"""The comparison that decides ``correct``.

The sampler's output is its records: every iteration's (beta_0, beta,
log_scale, log_noise_variance, shape) of every chain, and the recorded
field columns of the thinned iterations.  A Markov chain can only be
followed step by step from a state, so the reference starts from the
sampler's own state at the start of a timed cycle (what the window handed
on), draws the same numbers (``philox``), and runs the first ``ITERATIONS``
iterations of that cycle itself in float64 (``model``), following the
sampler's (log_scale, shape) accept decisions as its records show them;
the records of those iterations are compared with it (``state_gap``), and
each decision that the reference's own ratio takes the other way is held
to a limit by its margin (``decision_margin``).  The step-size adaptation
and the adaptive-covariance moments of the whole cycle are followed the
same way, from the records alone, to the cycle's end, where the sampler's
adaptive state is compared with them (``adapt_gap``).  What this skips,
the start, is checked by itself: the set-up the sampler derived (dedupe,
ordering, neighbour sets, colours) exactly, and the initial states of a
sample of chains.

Each compared leaf's gap is its largest absolute difference over the
larger of the reference's root mean square of that leaf and the median of
those over the leaves.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import model as M
from benchmark.reference import philox, setup

RECORD_LEAVES = ("beta_0", "beta", "log_scale", "log_noise_variance",
                 "shape")
ADAPT_LEAVES = ("tk_ancillary", "tk_sufficient", "prop_mean", "prop_m2",
                "prop_count")
ITERATIONS = 2     # iterations of the last timed cycle run in float64
TIE = 0.05         # a noise step this near its log-uniform is split
CAP_FACTOR = 2     # rows at most this many times the chains


def _gap(diffs: dict, refs: dict) -> tuple[float, str]:
    """(largest normalised gap, its leaf) from {leaf: [|prog - ref|]} and
    {leaf: [ref values]}."""
    rms = {k: float(np.sqrt(np.mean(np.concatenate(v) ** 2)))
           for k, v in refs.items()}
    floor = float(np.median(list(rms.values())))
    out = {k: float(np.max(np.concatenate(d))) / max(rms[k], floor, 1e-30)
           for k, d in diffs.items()}
    leaf = max(out, key=lambda k: out[k] if np.isfinite(out[k]) else np.inf)
    return (out[leaf] if np.isfinite(out[leaf]) else float("inf")), leaf


def _acc(diffs, refs, leaf, prog, ref):
    prog = np.asarray(prog, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    d = np.abs(prog - ref).ravel()
    d[~np.isfinite(d)] = np.inf
    diffs.setdefault(leaf, []).append(d)
    refs.setdefault(leaf, []).append(ref.ravel())


def setup_mismatch(derived: dict, prog: dict) -> int:
    """Entries where the sampler's set-up differs from the reference's:
    unique locations (in order), the observation map, the neighbour sets
    and the colours."""
    bad = 0
    if prog["locs"].shape != derived["locs"].shape:
        return int(max(len(prog["locs"]), len(derived["locs"])))
    bad += int((prog["locs"] != derived["locs"]).any(1).sum())
    bad += int((np.asarray(prog["locs_match"]) != derived["locs_match"]).sum())
    pn, rn = np.asarray(prog["NN"]), derived["NN"]
    if pn.shape != rn.shape:
        return bad + len(rn)
    bad += int((np.sort(pn[:, 1:], 1) != np.sort(rn[:, 1:], 1)).any(1).sum())
    bad += int((np.asarray(prog["colours"]) != derived["colours"]).sum())
    return bad


def init_gap(truth: dict, got: dict) -> tuple[float, str]:
    """The largest gap of the sampled chains' initial states ``got``
    {leaf: [c, ...]} against the reference's ``truth``."""
    diffs, refs = {}, {}
    for leaf in RECORD_LEAVES + ("field",):
        _acc(diffs, refs, leaf, np.asarray(got[leaf]),
             truth[leaf].double().cpu().numpy())
    return _gap(diffs, refs)


def saved_iterations(T, thinning):
    it = np.arange(1, T + 1)
    return it[np.round(it * thinning) == it * thinning]


def _draws(key, it, mdl, K, S, p, p_locs):
    seed, cycle_start, chains = key
    return philox.iteration_draws(seed, cycle_start, chains, it, K,
                                  1 + len(M.shape_names(mdl.covfun)), p,
                                  p_locs, S, mdl.n, M.NOISE_STEPS)


def recorded_decisions(mdl, rows, draws, K, rec):
    """The sampler's (log_scale, shape) decisions of an iteration [R, 2K]:
    the accept pattern whose moves from the rows' start reach the recorded
    (log_scale, shape) nearest."""
    moves = mdl.innovations(rows, draws, K)                  # [R, 2K, d]
    steps = moves.shape[1]
    bits = torch.tensor([[(p >> k) & 1 for k in range(steps)]
                         for p in range(2 ** steps)], dtype=moves.dtype,
                        device=moves.device)                 # [P, 2K]
    x0 = torch.cat([rows.s["log_scale"][:, None], rows.s["shape"]], 1)
    ends = x0[:, None] + torch.einsum("pk,rkd->rpd", bits, moves)
    want = torch.cat([rec["log_scale"][:, None], rec["shape"]], 1)
    dist = (ends - want[rows.owner][:, None]).abs().sum(-1)
    dist = torch.nan_to_num(dist, nan=torch.inf)
    return bits[dist.argmin(1)] > 0


def follow(mdl, state0, recs, key, plan):
    """Run the reference from ``state0`` for ``ITERATIONS`` iterations,
    following the sampler's recorded (log_scale, shape)
    decisions and keeping for each chain the noise-step branch that matches
    its recorded log_noise_variance.  Returns {"state_gap", "leaf",
    "ties", "disagree", "decision_margin"}.  ``recs`` {leaf: [T, C, ...]}
    with "field" [n_saved, C, w] at the columns ``plan["columns"]``."""
    dev = key[2].device
    rows = mdl.rows_of(state0, dev)
    C = rows.owner.shape[0]
    p, p_locs = rows.s["beta"].shape[1], mdl.X_locs_u.shape[1]
    saved = list(saved_iterations(plan["T"], plan["thinning"]))
    cols = torch.as_tensor(plan["columns"], device=dev)
    diffs, refs = {}, {}
    ties = disagree = 0
    margin, notes = 0.0, []
    for j in range(ITERATIONS):
        draws = _draws(key, j, mdl, plan["K"], plan["S"], p, p_locs)
        rec = {k: torch.as_tensor(np.asarray(recs[k][j], dtype=np.float64),
                                  device=dev).to(mdl.dtype)
               for k in RECORD_LEAVES}
        rows.forced = recorded_decisions(mdl, rows, draws, plan["K"], rec)
        rows = mdl.iteration(rows, draws, j, key[1], plan["K"], plan["S"],
                             tie=TIE, branch=True, cap=CAP_FACTOR * C)
        ties += rows.ties
        disagree += rows.disagree
        margin = max(margin, rows.margin)
        notes += [f"iteration {j}: {n}" for n in rows.notes]
        o = rows.owner
        dist = ((rows.s["log_scale"] - rec["log_scale"][o]).abs()
                + (rows.s["shape"] - rec["shape"][o]).abs().sum(1)
                + (rows.s["log_noise_variance"]
                   - rec["log_noise_variance"][o]).abs())
        dist = torch.nan_to_num(dist, nan=torch.inf)
        best = torch.full((C,), torch.inf, dtype=dist.dtype, device=dev)
        best.scatter_reduce_(0, o, dist, "amin")
        pick = torch.full((C,), -1, dtype=torch.int64, device=dev)
        hit = torch.nonzero(dist == best[o])[:, 0]
        pick[o[hit]] = hit
        rows = rows.take(pick)
        rows.ties, rows.forced, rows.disagree, rows.margin = 0, None, 0, 0.0
        rows.notes = []
        for leaf in RECORD_LEAVES:
            _acc(diffs, refs, leaf, rec[leaf].cpu().numpy(),
                 rows.s[leaf].cpu().numpy())
        if j + 1 in saved:
            slot = saved.index(j + 1)
            _acc(diffs, refs, "field", np.asarray(recs["field"][slot]),
                 rows.s["field"][:, cols].cpu().numpy())
    gap, leaf = _gap(diffs, refs)
    return {"state_gap": gap, "leaf": leaf, "ties": ties,
            "disagree": disagree, "decision_margin": margin, "notes": notes}


def plain_records(mdl, state0, key, plan, always_accept=False):
    """What the reference put in the sampler's place records over the
    first ``ITERATIONS`` iterations (no ties split): {leaf: [ITERATIONS,
    C, ...]} and "field" at the saved iterations' columns.
    ``always_accept`` plants a fault: every (log_scale, shape) proposal
    accepted."""
    dev = key[2].device
    rows = mdl.rows_of(state0, dev)
    p, p_locs = rows.s["beta"].shape[1], mdl.X_locs_u.shape[1]
    saved = list(saved_iterations(plan["T"], plan["thinning"]))
    cols = torch.as_tensor(plan["columns"], device=dev)
    out = {k: [] for k in RECORD_LEAVES + ("field",)}
    for j in range(ITERATIONS):
        draws = _draws(key, j, mdl, plan["K"], plan["S"], p, p_locs)
        if always_accept:
            rows.forced = torch.ones(rows.owner.shape[0], 2 * plan["K"],
                                     dtype=torch.bool, device=dev)
        rows = mdl.iteration(rows, draws, j, key[1], plan["K"], plan["S"])
        for k in RECORD_LEAVES:
            out[k].append(rows.s[k].double().cpu().numpy())
        if j + 1 in saved:
            out["field"].append(rows.s["field"][:, cols].double().cpu().numpy())
    return {k: np.stack(v) if v else np.zeros((0,)) for k, v in out.items()}


def lowered(mdl):
    """The control's model: the reference computed one step below the
    configuration's precisions: its float64 work in float32, the float32
    field in bfloat16 (and float32 matmuls in TF32, which the caller
    allows)."""
    from dataclasses import fields, replace

    f32 = {f.name: getattr(mdl, f.name).float() for f in fields(mdl)
           if isinstance(getattr(mdl, f.name), torch.Tensor)
           and getattr(mdl, f.name).is_floating_point()}
    return replace(mdl, dtype=torch.float32, sum_dtype=torch.float32,
                   field_dtype=torch.bfloat16, **f32)


def adaptation(mdl, state0, recs, key, plan, store=None):
    """The adaptive state at the cycle's end, {leaf: [C, ...]} of
    ``ADAPT_LEAVES``: from ``state0``'s step sizes and moments, each of the
    cycle's ``plan["T"]`` iterations in turn takes its proposals' moves
    from the state it started with and the draws, the accept pattern that
    reaches the recorded (log_scale, shape), and then the acceptance
    counts' step-size adaptation every ``ADAPT_WINDOW`` iterations and the
    moments of the recorded (log_scale, shape).  The field plays no part.
    ``store`` rounds the adaptive leaves after each iteration."""
    seed, start, chains = key
    dev, dt, K = chains.device, mdl.dtype, plan["K"]
    d = 1 + len(M.shape_names(mdl.covfun))
    t = lambda a: torch.as_tensor(np.asarray(a, dtype=np.float64),
                                  device=dev).to(dt)
    s = {k: None if state0.get(k) is None else t(state0[k])
         for k in ("log_scale", "shape") + ADAPT_LEAVES}
    C = chains.shape[0]
    zero = torch.zeros(C, dtype=dt, device=dev)
    rows = M.Rows(s, None, zero, zero.clone(), torch.arange(C, device=dev))
    for j in range(plan["T"]):
        draws = {k: philox.field_values(seed, start, chains, j, k,
                                        K * d).reshape(C, K, d)
                 for k in ("anc_z", "suf_z")}
        adapt_z = philox.field_values(seed, start, chains, j, "adapt_z", 2)
        rec = {k: t(recs[k][j]) for k in ("log_scale", "shape")}
        acc = recorded_decisions(mdl, rows, draws, K, rec).to(dt)
        rows.acc_anc = rows.acc_anc + acc[:, 0::2].sum(1)
        rows.acc_suf = rows.acc_suf + acc[:, 1::2].sum(1)
        s["log_scale"], s["shape"] = rec["log_scale"], rec["shape"]
        rows = mdl.adapt_and_am(rows, j, start, K, adapt_z.to(dt))
        if store is not None:
            for k in ADAPT_LEAVES:
                if s[k] is not None:
                    s[k] = store(s[k])
    return {k: s[k] for k in ADAPT_LEAVES if s[k] is not None}


def adapt_gap(ref: dict, prog: dict) -> tuple[float, str]:
    """The largest gap of the cycle end's adaptive state ``prog`` {leaf:
    [C, ...]} against the reference's ``ref``."""
    diffs, refs = {}, {}
    for leaf, v in ref.items():
        _acc(diffs, refs, leaf, np.asarray(prog[leaf]),
             v.double().cpu().numpy())
    return _gap(diffs, refs)


def control_gaps(derived, data, covfun, seed, sample, truth, state0, key,
                 plan, recs, limits):
    """The control's readings (init_gap, state_gap, decision_margin,
    adapt_gap) and its verdict under ``limits``: the reference put in the
    sampler's place one precision step down (``lowered``), read by the same
    comparisons as the sampler.  Its adaptive state follows the sampler's
    trajectory ``recs`` over the cycle with its leaves held in bfloat16.
    Beside them, "always_accept": the readings of the float64 reference in
    the sampler's place with every (log_scale, shape) proposal accepted."""
    mdl = derived["model"]
    low = lowered(mdl)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        got = setup.initial_states(derived, data, covfun, seed, sample,
                                   key[2].device, mdl=low)
        ig, _ = init_gap(truth, {k: v.double().cpu().numpy()
                                 for k, v in got.items()})
        low_recs = plain_records(low, state0, key, plan)
        bf16 = lambda x: x.to(low.field_dtype).to(low.dtype)
        low_end = adaptation(low, state0, recs, key, plan, store=bf16)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32
    f = follow(mdl, state0, low_recs, key, plan)
    ag, _ = adapt_gap(adaptation(mdl, state0, recs, key, plan),
                      {k: v.double().cpu().numpy()
                       for k, v in low_end.items()})
    out = {"init_gap": ig, "state_gap": f["state_gap"],
           "decision_margin": f["decision_margin"], "adapt_gap": ag}
    correct = all(np.isfinite(v) and v <= float(limits[k])
                  for k, v in out.items())
    fa = follow(mdl, state0, plain_records(mdl, state0, key, plan,
                                           always_accept=True), key, plan)
    return dict(out, disagree=f["disagree"], correct=bool(correct),
                always_accept={k: fa[k] for k in ("state_gap",
                                                  "decision_margin")})

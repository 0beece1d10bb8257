"""Benchmark: ESS per second on the Heavy-metals workload, on one CUDA card.

    python -m nngp_tpu_torch.bench [--smoke | --quick] [--device cuda|cpu]
        [--best-chains 96] [--best-iters 1500] [--lean | --no-lean] [--k 3]
        [--budget-s 1500]

Port of ``bench.py`` (the reference's real workload, Heavy_metals/
run_script.R:8-15: 64,274 lon/lat sites, 14 covariates,
exponential_sphere, m = 5, 3 chains; the synthetic stand-in of
``utils/datasets.py`` while the .RDS is absent).

Headline: effective samples per second of min(range, latent field),
against an R-equivalent baseline that is measured, not assumed: a
timing-faithful NumPy/SciPy single-chain run of the reference's operations
per iteration (GpGp::vecchia_Linv as a batched Cholesky, Matrix's sparse
ops as scipy CSR, the sequential colour loop with two sparse products per
colour, mcmc_nngp_update_Gaussian.R:254-275) on the port's own host layer.
The reference runs its 3 chains on 3 cores, so its per-chain wall clock is
the single-chain time.

Two legs, each a fit timed after a warmup gated on Gelman-Rubin-Brooks
(every univariate R-hat < 1.1) and a timed window that must pass the same
gate on its own records (else it becomes more warmup and a fresh window is
timed, up to the retries):
  best_chains_leg              96 chains, K = 3 (ASIS pairs per iteration
                               in the timed window), 64 recorded field
                               columns; runs first
  reference_protocol_3_chains  the reference's 3 chains, full records
On a card, the first leg's fit is held to the sweep kernel's parity
preflight (``diagnostics/preflight.py``) before any timing; if it fails,
no leg is timed.

``--budget-s`` bounds the run's wall clock: each leg stops its warmup, and
skips further window retries, when the next window would end past the
leg's share of the budget (``budget_hit`` records it); a window, once
started, completes.  The default lets a full run finish on an H100.

Prints ONE JSON line {"metric", "value", "unit", "vs_baseline", "detail"},
the keys of ``bench.py``; exits 1, after printing it, when a leg, the
preflight or the baseline failed (``detail.errors``).  ``--smoke`` runs
every leg on an 800-site problem in seconds (``--device cpu`` on a CPU).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

# each leg's deadline, as a share of --budget-s from the start; the
# baseline takes the rest
BEST_LEG_SHARE = 0.7
THREE_CHAIN_SHARE = 0.93
DEFAULT_BUDGET_S = 1500.0


def _subset(locs, y, X, k):
    return locs[:k], y[:k], {nm: v[:k] for nm, v in X.items()}


def measure_engine(n_timed_iters=600, n_iterations_update=200, quick=False,
                   n_chains=3, field_thinning=0.5, warmup_iters=None,
                   parity_out=None, warmup_grb=1.1, warmup_max_iters=3200,
                   lean_records=False, smoke=False, window_retries=0,
                   covparams_steps=1, device="cuda", deadline=None):
    """One leg: initialize at ``n_chains``, warm up, time a self-certifying
    window; the leg's ESS, its MC error and the window's R-hat.

    ``parity_out`` (a dict) asks for the sweep kernel's parity preflight on
    this fit first: it receives the result, and a failed preflight raises.
    ``deadline`` (a ``time.monotonic`` value) bounds the warmup and the
    window retries (see the module docstring)."""
    import torch

    import nngp_tpu_torch
    from nngp_tpu_torch.diagnostics.ess import effective_size
    from nngp_tpu_torch.diagnostics.grb import Gelman_Rubin_Brooks
    from nngp_tpu_torch.utils.datasets import load_heavy_metals

    locs, y, X = load_heavy_metals()
    if smoke:
        # every bench path, the lean-record leg included, in seconds
        locs, y, X = _subset(locs, y, X, 800)
        n_timed_iters, n_iterations_update = 50, 50
        warmup_max_iters = 50
        warmup_iters = 50 if warmup_iters is None else warmup_iters
    elif quick:
        locs, y, X = _subset(locs, y, X, 8000)
        n_timed_iters, n_iterations_update = 200, 100
        warmup_max_iters = 400

    clock = time.monotonic
    t0 = clock()
    mc = nngp_tpu_torch.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun="exponential_sphere",
        n_chains=n_chains, seed=1, device=device, verbose=False)
    setup_s = clock() - t0
    on_card = mc.device.type == "cuda"

    def sync():
        if on_card:
            torch.cuda.synchronize(mc.device)

    if parity_out is not None and on_card:
        from nngp_tpu_torch.diagnostics.preflight import chromatic_sweep_parity

        parity = chromatic_sweep_parity(mc)
        print(f"sweep parity preflight: {parity}", file=sys.stderr)
        parity_out.update(parity)
        if not parity["ok"]:
            raise RuntimeError(f"sweep parity preflight failed: {parity}")

    def fits(seconds):
        return deadline is None or clock() + seconds <= deadline

    # GRB-gated warmup: ESS of chains that are not stationary measures
    # throughput, not sampling, so warm up until every univariate R-hat <
    # warmup_grb before the timed window
    if warmup_iters is None:
        warmup_iters = n_iterations_update
    # lean records: the 64 monitored field columns only, and no per-cycle
    # GRB/ESS inside the timed window (the window is assessed afterwards;
    # the baseline's it/s excludes diagnostics too)
    rng = np.random.default_rng(0)
    field_cols = np.sort(rng.choice(mc.graph.n, size=64, replace=False))
    record_cols = field_cols if lean_records else None
    n_cycles = max(1, n_timed_iters // n_iterations_update)
    iters_timed = n_cycles * n_iterations_update
    K = max(1, int(covparams_steps))
    warmed, rhat_warm, s_per_iter, budget_hit = 0, None, None, False
    while True:
        # the window runs K ASIS pairs an iteration: at most K times the
        # warmup's cost an iteration
        if s_per_iter is not None and not fits(
                (warmup_iters + K * iters_timed) * s_per_iter):
            budget_hit = True
            break
        t = clock()
        mc = nngp_tpu_torch.run(
            mc, n_cycles=1, n_iterations_update=warmup_iters, verbose=False,
            field_thinning=field_thinning, Gelman_Rubin_Brooks_stop=(0.0, 0.0),
            field_record_columns=record_cols)
        sync()
        s_per_iter = (clock() - t) / warmup_iters
        warmed += warmup_iters
        if mc.n_chains < 2:
            break
        grb = mc.diagnostics["Gelman_Rubin_Brooks"][-1]
        rhat_warm = float(np.max(grb["R_hat"][1:]))
        print(f"warmup {warmed} iters: max univariate R-hat {rhat_warm:.3f}",
              file=sys.stderr, flush=True)
        if rhat_warm < warmup_grb or warmed >= warmup_max_iters:
            break

    # the self-certifying window: its own univariate R-hats must pass <
    # warmup_grb; a failing window is demoted to warmup and a fresh one is
    # timed, while the retries and the budget allow
    window_stationary, wall = None, None
    for attempt in range(window_retries + 1):
        if wall is not None and not fits(wall):
            budget_hit = True
            break
        sync()
        t = clock()
        mc = nngp_tpu_torch.run(
            mc, n_cycles=n_cycles, n_iterations_update=n_iterations_update,
            verbose=False, field_thinning=field_thinning,
            Gelman_Rubin_Brooks_stop=(0.0, 0.0),
            field_record_columns=record_cols,
            compute_diagnostics=not lean_records,
            # extra ASIS pairs per iteration in the timed window only
            # (post-adaptation; models/gaussian.py covparams_steps)
            covparams_steps=covparams_steps)
        sync()
        wall = clock() - t
        if mc.n_chains < 2:
            break
        g = Gelman_Rubin_Brooks(mc.records,
                                burn_in=1 - iters_timed / mc.iterations)
        worst = float(np.max(g["R_hat"][1:]))
        window_stationary = worst < warmup_grb
        print(f"timed window (attempt {attempt + 1}): max univariate R-hat "
              f"{worst:.3f} -> "
              f"{'stationary' if window_stationary else 'NOT stationary'}",
              file=sys.stderr, flush=True)
        if window_stationary:
            break
    it_per_s = iters_timed / wall  # all chains advance together

    # ESS per iteration of the timed window, summed across chains (the
    # reference's ESS summary row, mcmc_nngp_diagnose.R:116)
    T = mc.iterations
    lo = T - iters_timed
    ess_cols = np.arange(64) if lean_records else field_cols
    ess = {"log_scale": 0.0, "log_noise_variance": 0.0, "range": 0.0}
    ess_each = {k: [] for k in ess}
    field_ess, kept_counts = [], []
    for rec in mc.records:
        for k, series in (("log_scale", rec["log_scale"][lo:T]),
                          ("log_noise_variance",
                           rec["log_noise_variance"][lo:T]),
                          ("range", rec["shape"][lo:T, 0])):
            e = effective_size(series)
            ess[k] += e
            ess_each[k].append(e)
        keep = rec["saved_field"] > lo
        kept_counts.append(int(keep.sum()))
        f = rec["field"][keep]
        # the ESS of the retained (thinned) series, not rescaled to the
        # iteration count (that would be an upper bound, not an estimate)
        field_ess.append(np.mean([effective_size(f[:, c]) for c in ess_cols]))
    ess["field_mean"] = float(np.sum(field_ess))
    # MC error of the summed ESS: chain-to-chain spread * sqrt(chains)
    ess_mc_err = {k: float(np.std(v) * np.sqrt(len(v)))
                  for k, v in ess_each.items()}
    rhat_timed = None
    if mc.n_chains >= 2:
        g = Gelman_Rubin_Brooks(mc.records, burn_in=lo / T)
        rhat_timed = {nm: round(float(v), 3)
                      for nm, v in zip(g["names"], g["R_hat"])
                      if nm in ("Multivariate", "log_scale",
                                "log_noise_variance", "log_range")}
    return {
        "setup_s": setup_s,
        "wall_s": wall,
        "iters": iters_timed,
        "n_chains": n_chains,
        "schedule": "cuda" if on_card else "plain",
        "it_per_s": it_per_s,
        "ess": ess,
        "ess_mc_err": ess_mc_err,
        "ess_per_iter": {k: v / iters_timed for k, v in ess.items()},
        "ess_per_s": {k: v / wall for k, v in ess.items()},
        "field_kept_samples": kept_counts[0] if kept_counts else 0,
        "warmup_iters": warmed,
        "rhat_warmup_end": rhat_warm,
        "rhat_timed_window": rhat_timed,
        "window_stationary": window_stationary,
        "budget_hit": budget_hit,
        "covparams_steps": covparams_steps,
        "n": int(mc.graph.n),
        "device": (torch.cuda.get_device_name(mc.device) if on_card
                   else str(mc.device)),
        "lean_records": bool(lean_records),
    }


def measure_r_equivalent_baseline(n_iters=3, quick=False):
    """Single-chain time per iteration of the reference's operation schedule
    on C-backed NumPy/SciPy (the compute stack R uses).

    Audited per operation: each group is timed on its own, and the sparse
    triangular solve is the faster of the two credible C-backed candidates
    measured here (scipy's spsolve_triangular, the level-scheduled NumPy
    solve), so the baseline is the strongest honest stand-in for R's
    Matrix::solve."""
    from scipy import sparse
    from scipy.sparse.linalg import spsolve_triangular

    from nngp_tpu_torch.ops.numpy_ref import np_solve_L
    from nngp_tpu_torch.preprocess.coloring import dag_levels, greedy_coloring
    from nngp_tpu_torch.preprocess.dedupe import dedupe_and_match
    from nngp_tpu_torch.preprocess.neighbors import find_ordered_nn, nn_mask
    from nngp_tpu_torch.preprocess.ordering import (lonlat_to_xyz,
                                                    reorder_locations)
    from nngp_tpu_torch.utils.datasets import load_heavy_metals

    locs, y, X = load_heavy_metals()
    if quick:
        locs, y, X = _subset(locs, y, X, 8000)
    maps = dedupe_and_match(
        locs, perm_fn=lambda L: reorder_locations(L, "maxmin", lonlat=True))
    xyz = lonlat_to_xyz(maps.locs)
    m = 5
    NN = find_ordered_nn(maps.locs, m, lonlat=True)
    mask = nn_mask(NN)
    n = len(NN)
    colors = greedy_coloring(NN)
    levels = dag_levels(NN)
    color_sets = [np.where(colors == c)[0] for c in range(colors.max() + 1)]
    Xl = np.stack([np.asarray(v, dtype=np.float64) for v in X.values()],
                  1)[maps.hctam_scol_1]

    def vecchia_linv_np(rho):
        # batched build, the GpGp::vecchia_Linv equivalent (BLAS speed)
        pts = xyz[np.maximum(NN, 0)]                      # [n, m+1, 3]
        diff = pts[:, :, None, :] - pts[:, None, :, :]
        K = np.exp(-np.sqrt((diff * diff).sum(-1)) / rho)
        valid = mask[:, :, None] & mask[:, None, :]
        K = np.where(valid, K, np.eye(m + 1)[None])
        L = np.linalg.cholesky(K[:, 1:, 1:])
        u = np.linalg.solve(L, K[:, 1:, 0][..., None])[..., 0]
        d = np.maximum(K[:, 0, 0] - (u * u).sum(-1), 1e-12)
        b = np.linalg.solve(np.transpose(L, (0, 2, 1)), u[..., None])[..., 0]
        out = np.concatenate([1 / np.sqrt(d)[:, None],
                              -b / np.sqrt(d)[:, None]], 1)
        return out * mask

    def to_csr(linv):
        rows = np.repeat(np.arange(n), mask.sum(1))
        return sparse.csr_matrix((linv[mask], (rows, NN[mask])), shape=(n, n))

    w = np.random.default_rng(0).normal(size=n)
    rho = 0.05

    # the faster credible triangular solve, measured here, not assumed
    linv_probe = vecchia_linv_np(rho)
    L_probe = to_csr(linv_probe)
    v_probe = L_probe @ w
    t0 = time.time()
    x_sp = spsolve_triangular(L_probe, v_probe, lower=True)
    t_scipy = time.time() - t0
    t0 = time.time()
    x_lv = np_solve_L(linv_probe * mask, NN, v_probe, levels=levels)
    t_level = time.time() - t0
    if not np.allclose(x_sp, x_lv, atol=1e-8 * max(1, np.abs(x_sp).max())):
        raise RuntimeError("the two triangular solves disagree")
    use_level = t_level < t_scipy

    def trisolve(L, linv_rows, v):
        if use_level:
            return np_solve_L(linv_rows * mask, NN, v, levels=levels)
        return spsolve_triangular(L, v, lower=True)

    ops = {"factor_build": 0.0, "trisolve": 0.0, "loglik": 0.0,
           "beta_block": 0.0, "chromatic": 0.0}
    t_all = time.time()
    for _ in range(n_iters):
        # ancillary MH: factor build + sparse trisolve co-transform
        # (ref :123-127)
        t0 = time.time()
        linv = vecchia_linv_np(rho)
        L = to_csr(linv)
        ops["factor_build"] += time.time() - t0
        t0 = time.time()
        w_new = trisolve(L, linv, L @ w)
        _ = float(((y[:n] - w_new[:n]) ** 2).sum())
        ops["trisolve"] += time.time() - t0
        # sufficient MH: factor build + 2 Linv_mult log-liks (ref :179-186)
        t0 = time.time()
        linv2 = vecchia_linv_np(rho * 1.01)
        L2 = to_csr(linv2)
        ops["factor_build"] += time.time() - t0
        t0 = time.time()
        _ = np.log(linv2[:, 0]).sum() - 0.5 * float(((L2 @ w) ** 2).sum())
        _ = np.log(linv[:, 0]).sum() - 0.5 * float(((L @ w) ** 2).sum())
        ops["loglik"] += time.time() - t0
        # beta block: interweaved precision refresh + draws
        # (ref :147-150, :230-246)
        t0 = time.time()
        LX = L @ np.concatenate([np.ones((n, 1)), Xl], 1)
        np.linalg.cholesky(np.linalg.inv(LX.T @ LX))
        _ = LX.T @ (L @ w)
        ops["beta_block"] += time.time() - t0
        # chromatic sweeps: 10 x two sparse products per colour
        # (ref :257-274)
        t0 = time.time()
        pdiag = np.asarray(L.multiply(L).sum(0)).ravel()
        LT = L.T.tocsr()
        for _sweep in range(10):
            for S in color_sets:
                msk = np.ones(n)
                msk[S] = 0.0
                cross = LT[S] @ (L @ (w * msk))
                w[S] = cross / (pdiag[S] + cross * 0 + 1.0)
        ops["chromatic"] += time.time() - t0
        # noise MH x10: scalar work on a precomputed SSE (ref :283-293)
    per_iter = (time.time() - t_all) / n_iters
    return {
        "per_iter_s": per_iter,
        "it_per_s": 1.0 / per_iter,
        "n": n,
        "trisolve_impl": "level_numpy" if use_level else "scipy",
        "trisolve_probe_s": {"scipy": round(t_scipy, 3),
                             "level_numpy": round(t_level, 3)},
        "per_op_s": {k: round(v / n_iters, 3) for k, v in ops.items()},
    }


def _headline(eng, base):
    """(leg ESS/s, baseline ESS/s) of min(range, field); the baseline's is
    None without a baseline.

    The baseline runs the same sampler on 3 chains on 3 cores, so its ESS
    per iteration and chain equals the leg's: the leg's per-chain ESS per
    iteration times 3 chains times the baseline's it/s.  A leg with
    covparams_steps K > 1 charges the baseline the same K at its own
    measured prices: each extra ASIS pair adds 2 factor builds, a trisolve
    and a loglik (mcmc_nngp_update_Gaussian.R:108-213)."""
    h = min(eng["ess_per_s"]["range"], eng["ess_per_s"]["field_mean"])
    epi = min(eng["ess_per_iter"]["range"], eng["ess_per_iter"]["field_mean"])
    if base is None:
        return h, None
    K = int(eng.get("covparams_steps", 1) or 1)
    ops = base.get("per_op_s") or {}
    extra = (ops.get("factor_build", 0.0) + ops.get("trisolve", 0.0)
             + ops.get("loglik", 0.0))
    base_it_s = 1.0 / (1.0 / base["it_per_s"] + (K - 1) * extra)
    return h, epi / max(eng["n_chains"], 1) * 3 * base_it_s


def _ratio(h, b):
    """h / b to 2 decimals; 0.0 when there is no positive baseline (a stuck
    window or empty records give 0, never a ZeroDivisionError)."""
    if b is None or not (b > 0.0):
        return 0.0
    return round(float(h / b), 2)


def _summ(eng):
    return {
        "chains": eng["n_chains"],
        "schedule": eng["schedule"],
        "covparams_steps": eng["covparams_steps"],
        "it_per_s": round(eng["it_per_s"], 2),
        "ms_per_iter": round(1000 / max(eng["it_per_s"], 1e-9), 1),
        "ess_per_s": {k: round(v, 4) for k, v in eng["ess_per_s"].items()},
        "ess_mc_err": {k: round(v, 2) for k, v in eng["ess_mc_err"].items()},
        "timed_iters": eng["iters"],
        "wall_s": round(eng["wall_s"], 1),
        "setup_s": round(eng["setup_s"], 1),
        "warmup_iters": eng["warmup_iters"],
        "rhat_warmup_end": eng["rhat_warmup_end"],
        "rhat_timed_window": eng["rhat_timed_window"],
        "window_stationary": eng["window_stationary"],
        "budget_hit": eng["budget_hit"],
        "field_kept_samples": eng["field_kept_samples"],
        "lean_records": eng["lean_records"],
    }


def _excinfo(e):
    import traceback

    return "".join(traceback.format_exception(e)).strip().split("\n")[-3:]


def leg_settings(a, on_card):
    """(name, measure_engine keywords) of each leg, in run order."""
    legs = []
    if on_card or a.smoke:
        best = dict(n_chains=a.best_chains, n_timed_iters=a.best_iters,
                    n_iterations_update=100, field_thinning=0.05,
                    warmup_iters=200, lean_records=a.lean,
                    window_retries=2 if on_card else 0,
                    covparams_steps=a.k, smoke=a.smoke)
        if a.smoke:
            best.update(n_chains=3, n_timed_iters=50, warmup_iters=None)
        legs.append(("best_chains_leg", best))
    legs.append(("reference_protocol_3_chains", dict(
        n_chains=3, quick=a.quick, smoke=a.smoke,
        n_timed_iters=1000 if on_card else 600,
        field_thinning=0.1 if on_card else 0.5,
        window_retries=2 if on_card else 0)))
    return legs


def result_line(legs, base, parity, errors):
    """The one JSON object of a run, from its completed legs (name -> leg
    dict), the baseline, the preflight's result and the errors."""
    done = [e for e in legs.values() if e is not None]
    if not done:
        return {"metric": "ESS/sec on Heavy-metals (all legs failed)",
                "value": 0.0, "unit": "ESS/s", "vs_baseline": 0.0,
                "detail": {"sweep_parity_preflight": parity or None,
                           "errors": errors}}
    # the headline: the best completed leg by ESS/s among those whose
    # window passed its own R-hat gate; a leg that did not pass headlines
    # only when none did, its window_stationary=False beside it
    stationary = [e for e in done if e["window_stationary"] is not False]
    top = max(stationary or done, key=lambda e: _headline(e, base)[0])
    headline, baseline_ess_per_s = _headline(top, base)
    detail = {"best_config": _summ(top),
              "sweep_parity_preflight": parity or None}
    for name, eng in legs.items():
        if eng is not None and eng is not top:
            detail[name] = {**_summ(eng),
                            "vs_baseline": _ratio(*_headline(eng, base))}
    if base is not None:
        detail.update({
            "r_equiv_it_per_s": round(base["it_per_s"], 4),
            "baseline_per_op_s": base.get("per_op_s"),
            "baseline_trisolve": {"impl": base.get("trisolve_impl"),
                                  "probe_s": base.get("trisolve_probe_s")},
        })
    if errors:
        detail["errors"] = errors
    return {
        "metric": "ESS/sec (min of range, latent field) on Heavy-metals "
                  f"n={top['n']}, m=5, {top['n_chains']} chains "
                  f"[{top['device']}]",
        "value": round(float(headline), 3),
        "unit": "ESS/s",
        "vs_baseline": _ratio(headline, baseline_ess_per_s),
        "detail": detail,
    }


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    size = ap.add_mutually_exclusive_group()
    size.add_argument("--smoke", action="store_true",
                      help="800 sites, 50-iteration windows: seconds")
    size.add_argument("--quick", action="store_true",
                      help="8,000 sites, the 3-chain leg only")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--best-chains", type=int, default=96)
    ap.add_argument("--best-iters", type=int, default=1500)
    ap.add_argument("--lean", action=argparse.BooleanOptionalAction,
                    default=True, help="the best leg records 64 columns")
    ap.add_argument("--k", type=int, default=3,
                    help="ASIS pairs an iteration in the best leg's window")
    ap.add_argument("--budget-s", type=float, default=DEFAULT_BUDGET_S,
                    help="wall-clock budget of the whole run, seconds")
    return ap.parse_args(argv)


def main(argv=None):
    import torch

    a = parse_args(argv)
    on_card = (torch.device(a.device).type == "cuda"
               and not (a.quick or a.smoke))
    t0 = time.monotonic()
    shares = {"best_chains_leg": BEST_LEG_SHARE,
              "reference_protocol_3_chains": THREE_CHAIN_SHARE}
    errors, parity, legs = {}, {}, {}
    for name, kw in leg_settings(a, on_card):
        legs[name] = None
        if parity and not parity["ok"]:
            errors[name] = ["not run: the sweep parity preflight failed"]
            continue
        try:
            legs[name] = measure_engine(
                device=a.device, deadline=t0 + shares[name] * a.budget_s,
                parity_out=None if parity else parity, **kw)
        except Exception as e:  # noqa: BLE001 — the line must still print
            errors[name] = _excinfo(e)
    base = None
    try:
        base = measure_r_equivalent_baseline(n_iters=2,
                                             quick=a.quick or a.smoke)
    except Exception as e:  # noqa: BLE001
        errors["r_equivalent_baseline"] = _excinfo(e)
    print(json.dumps(result_line(legs, base, parity, errors)), flush=True)
    return 1 if errors else 0


if __name__ == "__main__":
    sys.exit(main())

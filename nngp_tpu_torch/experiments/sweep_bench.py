"""K1, the chromatic sweep kernel, timed at Heavy-metals width, and one
Gibbs iteration profiled by block, on one CUDA card.

    python -m nngp_tpu_torch.experiments.sweep_bench [--chains 3 96]
        [--family F] [--profile [CHAINS:K ...]] [--factor [CHAINS ...]]
        [--solve [CHAINS ...]] [--json PATH]

The problem is chip_smoke.py's main path: 64,274 synthetic lon/lat sites
(``utils/datasets.py``), ``exponential_sphere``, m = 5, 14 location
covariates, seed 1, 10 sweeps per call.  Its three initial states are tiled
to each chain count.  For each count it prints one JSON line: the kernel's
median time over 21 calls (CUDA events, field reset before each call), the
time of the Q layout gather that feeds it, the time of its grid barriers
alone, the plain twin's time (3 chains only) and the least time the card
could take for the function's bytes and operations (``sweep_bound``).

  --profile   5 iterations at each CHAINS:K (default 3:1; the states
              tiled to CHAINS chains, K ASIS pairs) under the program's
              spans (nngp_tpu_torch/tracing.py) and torch.profiler: each
              span's host and self time and calls an iteration, the
              card's idle share and its idle time by span, the device
              time and the launches
  --family    the covariance family of the fit (default exponential_sphere;
              matern_sphere for the Matérn iteration)
  --factor    the factor build alone (ops/vecchia.py:vecchia_linv, one
              factor_build launch) at the fit's states tiled to each
              CHAINS (default 3): its median time over 21 calls and a
              SHA-256 of its rows' bytes, so that two checkouts run under
              this script in one call can be compared bit for bit

Raises without a CUDA card.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import time
from dataclasses import fields, replace

import torch

from nngp_tpu_torch.experiments import timing

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory (NVIDIA data sheet)
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
SWEEPS = 10


def heavy_metals_fit(device, family="exponential_sphere"):
    """chip_smoke.py's main-path fit: 3 chains, seed 1, on ``device``."""
    import nngp_tpu_torch
    from nngp_tpu_torch.utils.datasets import synthetic_heavy_metals

    locs, y, X = synthetic_heavy_metals()
    return nngp_tpu_torch.initialize(
        locs, y, X_locs=X, m=5, stationary_covfun=family, n_chains=3, seed=1,
        device=device, verbose=False)


def tile_states(states, C):
    """``states`` repeated along the chain axis up to C chains."""
    def tile(x):
        if x is None:
            return None
        reps = -(-C // x.shape[0])
        return x.repeat((reps,) + (1,) * (x.dim() - 1))[:C].contiguous()

    return replace(states, **{f.name: tile(getattr(states, f.name))
                              for f in fields(states)})


def sweep_bound(C, S, n, nnz, n_colors):
    """(ms, "bytes" or "operations"): the least time of one call on an H100
    SXM at 700 W.  Bytes: what the function must move, each once: the field
    in and out, P and rs, the noise [C, S, n], scal, the neighbour CSR with
    the colour-major site order (plan_nbr, plan_ptr, plan_sites, color_ptr)
    and Q in its smaller form: one value per edge [C, nnz / 2] with the nnz
    edge ids that place it, or one per directed entry [C, nnz] (the
    kernel's ``q_plan``, whose duplication is the design's cost, not the
    bound's).  Operations: three float32 operations per neighbour entry
    and eight per site update, each sweep."""
    q_bytes = 4 * min(C * nnz, C * (nnz // 2) + nnz)
    nbytes = q_bytes + 4 * (2 * C * n + 2 * C * n + C * S * n + 3 * C
                            + nnz + (n + 1) + n + (n_colors + 1))
    flops = C * S * (3 * nnz + 8 * n)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                       else "operations")


def sweep_case(mc, C, seed=0, zero_noise=False):
    """The kernel's inputs at C chains (states tiled): a dict with the field
    ``w0``, the noise (standard normals from ``seed``, or zeros), the Q
    layout gather ``layout()`` and ``call(w)`` / ``plain(w)``, which run all
    sweeps in place on ``w``; ``barriers(w)`` runs the kernel with every
    colour empty, so its time is that of the launch and its grid
    barriers."""
    from nngp_tpu_torch.models import gaussian as G
    from nngp_tpu_torch.ops import sweep
    from nngp_tpu_torch.ops.covariance import shape_transform
    from nngp_tpu_torch.ops.vecchia import vecchia_linv

    g = mc.graph
    st = tile_states(mc.states, C)
    names = mc.space_time_model["covfun"]["shape_params"]
    linv = vecchia_linv(g, shape_transform(names, st.shape))
    q_edges, q_plan, P, rs, scal = G.sweep_inputs(
        g, mc.data, st, linv, G._mu_obs(mc.data, st, g))
    dev = st.field.device
    noise = torch.randn(C, SWEEPS, g.n, device=dev,
                        generator=torch.Generator(dev).manual_seed(seed))
    if zero_noise:
        noise.zero_()
    args = (q_plan, P, rs, noise, scal, g.color_ptr, g.plan_sites,
            g.plan_ptr, g.plan_nbr)
    lane_ptr, lane_tab = sweep.lanes(g.color_ptr, g.plan_sites, g.plan_ptr)
    # every colour empty: the launch's S x colours grid barriers alone
    empty = (q_plan, P, rs, noise, scal, g.plan_nbr,
             torch.zeros_like(lane_ptr), lane_tab)
    return {"C": C, "n": g.n, "nnz": g.plan_nbr.shape[0],
            "n_colors": g.n_colors, "w0": st.field.clone(), "noise": noise,
            "layout": lambda: q_edges.index_select(1, g.plan_edge),
            "call": lambda w: sweep.chromatic_sweeps_cuda(w, *args),
            "barriers": lambda w: sweep.launch(w, *empty),
            "plain": lambda w: sweep.chromatic_sweeps_reference(w, *args)}


def time_case(case, plain=False):
    """Median ms of the kernel, of the layout gather, of the grid barriers
    alone and (``plain``) of the plain twin on ``case``; the bound beside
    them."""
    w = case["w0"].clone()
    reset = lambda: w.copy_(case["w0"])  # noqa: E731
    out = {"chains": case["C"],
           "ms": timing.median_ms(lambda: case["call"](w), 21, reset),
           "layout_ms": timing.median_ms(case["layout"], 21),
           "barriers_ms": timing.median_ms(lambda: case["barriers"](w), 21)}
    if plain:
        out["plain_ms"] = timing.median_ms(lambda: case["plain"](w), 5, reset)
    bound, by = sweep_bound(case["C"], SWEEPS, case["n"], case["nnz"],
                            case["n_colors"])
    out.update(bound_ms=bound, bound_by=by, share=bound / out["ms"])
    return out


def _cycle(mc, T, state=None, seed=0, chains=None, steps=1):
    """One ``run_cycle`` of T Gibbs iterations with ``steps`` ASIS pairs
    from ``state`` (None: ``mc``'s states tiled to ``chains``); returns the
    state, synchronised."""
    from nngp_tpu_torch.models import gaussian as G
    from nngp_tpu_torch.ops.draws import DrawKey

    if state is None:
        state = mc.states if chains is None else tile_states(mc.states,
                                                             chains)
    cfg = G.UpdateConfig(
        n_iterations=T,
        shape_names=tuple(mc.space_time_model["covfun"]["shape_params"]),
        locs_cols=tuple(int(c) for c in mc.design.locs_cols),
        covparams_steps=steps)
    key = DrawKey.of(seed, 0, 0, state.field.shape[0], state.field.device)
    state, _ = G.run_cycle(mc.graph, mc.data, cfg, state, key, 0)
    if state.field.is_cuda:
        torch.cuda.synchronize()
    return state


def time_factor(mc, C):
    """The factor build at ``mc``'s states tiled to C chains: median ms of
    21 calls (CUDA events) and the SHA-256 of the rows' bytes."""
    import hashlib

    from nngp_tpu_torch.ops.covariance import shape_transform
    from nngp_tpu_torch.ops.vecchia import vecchia_linv

    names = mc.space_time_model["covfun"]["shape_params"]
    natural = shape_transform(names, tile_states(mc.states, C).shape)
    rows = vecchia_linv(mc.graph, natural)
    torch.cuda.synchronize()
    digest = hashlib.sha256(rows.cpu().numpy().tobytes()).hexdigest()
    return {"family": mc.graph.covfun, "factor_build_chains": C,
            "ms": timing.median_ms(lambda: vecchia_linv(mc.graph, natural),
                                   21),
            "rows_sha256": digest[:16]}


def level_solve_bytes(C, n, k):
    """Bytes one level solve call must move at C chains, n sites and k =
    m + 1 entries a factor row: linv (C n k float32) and v read, x written,
    and the step tables (each site's index and its m parent columns, int32)
    read once."""
    return 4 * (C * n * (k + 2) + n * k)


def _path_graph(S, m, device):
    """A graph whose level schedule has S steps of one site each (site i's
    one parent is i - 1): what the level solve costs for its steps alone."""
    from types import SimpleNamespace

    from nngp_tpu_torch.preprocess.coloring import STEP_FIELDS, level_steps

    NN = torch.full((S, m + 1), -1, dtype=torch.int64)
    NN[:, 0] = torch.arange(S)
    if m:
        NN[1:, 1] = torch.arange(S - 1)
    segs = (torch.arange(S).reshape(S, 1),)
    steps = level_steps(segs, NN, NN >= 0)
    return SimpleNamespace(
        n=S, NNarray=NN.to(device), nn_mask=(NN >= 0).float().to(device),
        level_segs=tuple(t.to(device) for t in segs),
        **{f: torch.as_tensor(t, device=device)
           for f, t in zip(STEP_FIELDS, steps)})


def time_solve(mc, C):
    """The level solve at ``mc``'s states tiled to C chains, on standard
    normal right-hand sides: median ms of 21 calls (CUDA events), the
    device ms a call back to back, the twin's median ms, the bytes bound
    and the step floor (the kernel on ``_path_graph`` of as many steps),
    the largest differences from the twin in float64 over max(1,
    |x|_inf), whether the twin and a repeat call give x's bits, the
    launches of one call, and the SHA-256 of x's bytes."""
    import hashlib

    from nngp_tpu_torch.ops import trisolve as T
    from nngp_tpu_torch.ops.covariance import shape_transform
    from nngp_tpu_torch.ops.vecchia import vecchia_linv

    g = mc.graph
    names = mc.space_time_model["covfun"]["shape_params"]
    linv = vecchia_linv(g, shape_transform(names,
                                           tile_states(mc.states, C).shape))
    dev = linv.device
    v = torch.randn(C, g.n, device=dev,
                    generator=torch.Generator(dev).manual_seed(C))
    before = T.level_solve.launches
    x = T.level_solve(linv, v, g)
    launches = T.level_solve.launches - before
    same = torch.equal(T.level_solve(linv, v, g), x)
    twin = T.level_solve_reference(linv, v, g)
    f64 = T.level_solve_reference(linv.double(), v.double(), g)
    torch.cuda.synchronize()
    scale = max(1.0, f64.abs().max().item())
    n_steps = g.step_ptr.shape[0] - 1
    path = _path_graph(n_steps, g.m, dev)
    pl = torch.ones(C, path.n, g.m + 1, device=dev)
    pv = torch.ones(C, path.n, device=dev)
    bound_ms = 1e3 * level_solve_bytes(C, g.n, g.m + 1) / HBM_BYTES_PER_S
    out = {"level_solve_chains": C, "steps": n_steps,
           "rows": g.n_levels_rows, "launches_a_call": launches,
           "same_bits": same, "twin_bits": torch.equal(x, twin),
           "ms": timing.median_ms(lambda: T.level_solve(linv, v, g), 21),
           "device_ms": timing.per_call_ms(
               lambda: T.level_solve_cuda(linv, v, g), 50)[0],
           "floor_ms": timing.median_ms(
               lambda: T.level_solve_cuda(pl, pv, path), 21),
           "plain_ms": timing.median_ms(
               lambda: T.level_solve_reference(linv, v, g), 5),
           "bound_ms": bound_ms,
           "f64_max_diff": (x.double() - f64).abs().max().item() / scale,
           "x_sha256": hashlib.sha256(
               x.cpu().numpy().tobytes()).hexdigest()[:16]}
    out["share"] = bound_ms / out["device_ms"]
    out["floor_share"] = max(bound_ms, out["floor_ms"]) / out["device_ms"]
    return out


def _device_intervals(prof):
    """(name, start_ns, end_ns) of each device operation a finished
    torch.profiler recorded, on the clock of ``tracing``'s spans."""
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            start = int(e.start_ns())
            out.append((e.name(), start, start + int(e.duration_ns())))
    return out


def profile_iteration(mc, T=5, chains=None, steps=1):
    """T iterations of ``mc``'s states tiled to ``chains`` with ``steps``
    ASIS pairs, in one ``run_cycle``: the bare loop's ms an iteration, then
    the same under ``tracing.record()`` (and torch.profiler on a card).
    Per iteration: each of the program's spans by name
    (``models/gaussian.py``'s blocks, ``factor``, ``level_solve``, ...)
    with its host ms, its self ms (less its children's) and its calls; the
    traced stretch's ms; on a card, the share of that stretch in which no
    device operation ran, its idle ms by the innermost span open over it
    (``tracing.idle_by_span``), the device time, the launches and the
    largest kernels."""
    from nngp_tpu_torch import tracing

    cycle = functools.partial(_cycle, mc, chains=chains, steps=steps)
    st = cycle(3)                                   # warm
    t = time.perf_counter()
    st = cycle(T, st, seed=1)
    loop_ms = 1e3 * (time.perf_counter() - t) / T

    cuda = st.field.is_cuda
    if cuda:
        from torch.profiler import ProfilerActivity, profile

        prof = profile(activities=[ProfilerActivity.CUDA])
    else:
        prof = contextlib.nullcontext()
    with prof, tracing.record() as spans:
        with tracing.span("cycle"):
            st = cycle(T, st, seed=2)
    blocks = {}
    for i, s in enumerate(spans[1:], 1):
        b = blocks.setdefault(s.name, {"host_ms": 0.0, "self_ms": 0.0,
                                       "calls": 0})
        b["host_ms"] += 1e3 * s.seconds / T
        b["self_ms"] += 1e3 * tracing.self_seconds(spans, i) / T
        b["calls"] += 1
    for b in blocks.values():
        b["calls"] /= T
    out = {"family": mc.graph.covfun, "chains": st.field.shape[0],
           "covparams_steps": steps, "loop_ms": loop_ms,
           "traced_ms": 1e3 * spans[0].seconds / T, "blocks": blocks,
           "idle_share": None, "idle_ms": None, "profiler_device_ms": None,
           "launches_per_iteration": None, "top_kernels_ms": None}
    if not cuda:
        return out
    ops = _device_intervals(prof)
    idle = tracing.idle_by_span(spans, [(a, b) for _, a, b in ops], 0)
    by_name = {}
    for name, a, b in ops:
        by_name[name[:80]] = by_name.get(name[:80], 0) + b - a
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    out.update(
        idle_share=sum(idle.values()) / spans[0].seconds,
        idle_ms={k: 1e3 * v / T for k, v in
                 sorted(idle.items(), key=lambda kv: -kv[1])},
        profiler_device_ms=sum(by_name.values()) * 1e-6 / T,
        launches_per_iteration=len(ops) / T,
        top_kernels_ms={k: v * 1e-6 / T for k, v in top})
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chains", type=int, nargs="*", default=[3, 96])
    ap.add_argument("--family", default="exponential_sphere")
    ap.add_argument("--profile", nargs="*", metavar="CHAINS:K",
                    help="profile one iteration at each CHAINS:K (default "
                         "3:1)")
    ap.add_argument("--factor", type=int, nargs="*", metavar="CHAINS",
                    help="time the factor build at each CHAINS (default 3)")
    ap.add_argument("--solve", type=int, nargs="*", metavar="CHAINS",
                    help="time the level solve at each CHAINS (default 3 "
                         "96)")
    ap.add_argument("--json", default=None, help="append the lines here")
    a = ap.parse_args(argv)
    dev = timing.cuda_device()
    torch.backends.cuda.matmul.allow_tf32 = False
    t = time.perf_counter()
    mc = heavy_metals_fit(dev, a.family)
    torch.cuda.synchronize()
    g = mc.graph
    deg = torch.diff(g.plan_ptr)
    print(f"# {torch.cuda.get_device_name(dev)}, {a.family}, n={g.n}, set-up "
          f"{time.perf_counter() - t:.1f} s; sites per colour "
          f"{torch.diff(g.color_ptr).tolist()}; degree mean "
          f"{deg.double().mean().item():.2f}, max {deg.max().item()}",
          flush=True)
    lines = []
    for C in a.chains:
        case = sweep_case(mc, C)
        lines.append(time_case(case, plain=(C <= 3)))
        del case
        torch.cuda.empty_cache()
    for C in ([] if a.factor is None else a.factor or [3]):
        lines.append(time_factor(mc, C))
    for C in ([] if a.solve is None else a.solve or [3, 96]):
        lines.append(time_solve(mc, C))
        torch.cuda.empty_cache()
    for spec in ([] if a.profile is None else a.profile or ["3:1"]):
        chains, steps = (int(v) for v in spec.split(":"))
        lines.append(profile_iteration(mc, chains=chains, steps=steps))
        torch.cuda.empty_cache()
    for line in lines:
        print(json.dumps(line), flush=True)
    if a.json:
        with open(a.json, "a") as f:
            for line in lines:
                f.write(json.dumps(line) + "\n")
    return lines


if __name__ == "__main__":
    main()

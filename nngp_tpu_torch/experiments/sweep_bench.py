"""K1, the chromatic sweep kernel, timed at Heavy-metals width, and one
Gibbs iteration profiled by block, on one CUDA card.

    python -m nngp_tpu_torch.experiments.sweep_bench [--chains 3 96]
        [--family F] [--profile [CHAINS:K ...]] [--json PATH]

The problem is chip_smoke.py's main path: 64,274 synthetic lon/lat sites
(``utils/datasets.py``), ``exponential_sphere``, m = 5, 14 location
covariates, seed 1, 10 sweeps per call.  Its three initial states are tiled
to each chain count.  For each count it prints one JSON line: the kernel's
median time over 21 calls (CUDA events, field reset before each call), the
time of the Q layout gather that feeds it, the time of its grid barriers
alone, the plain twin's time (3 chains only) and the least time the card
could take for the function's bytes and operations (``sweep_bound``).

  --profile   one iteration at each CHAINS:K (default 3:1; the states
              tiled to CHAINS chains, K ASIS pairs): the device span and
              host time of each block (CUDA events around the functions of
              models/gaussian.py), then torch.profiler over 5 iterations
              for the device time, the launches and the card's idle share
  --family    the covariance family of the fit (default exponential_sphere;
              matern_sphere for the Matérn iteration)

Raises without a CUDA card.
"""

from __future__ import annotations

import argparse
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


BLOCKS = ("_ancillary_step", "vecchia_linv", "level_solve",
          "_sufficient_step", "_beta_step", "_chromatic_sweeps",
          "sweep_inputs", "chromatic_sweeps", "_noise_steps")


def _iterations(mc, T, carry=None, seed=0, chains=None, steps=1):
    """T Gibbs iterations of ``mc``'s chains (tiled to ``chains``) with
    ``steps`` ASIS pairs from ``carry`` (None: the fit's states); returns
    the carry, synchronised."""
    from nngp_tpu_torch.models import gaussian as G
    from nngp_tpu_torch.ops.covariance import shape_transform
    from nngp_tpu_torch.ops.vecchia import vecchia_linv

    st = mc.states if chains is None else tile_states(mc.states, chains)
    cfg = G.UpdateConfig(
        n_iterations=T,
        shape_names=tuple(mc.space_time_model["covfun"]["shape_params"]),
        locs_cols=tuple(int(c) for c in mc.design.locs_cols),
        covparams_steps=steps)
    if carry is None:
        zero = torch.zeros_like(st.log_scale)
        carry = (st, vecchia_linv(mc.graph, shape_transform(cfg.shape_names,
                                                            st.shape)),
                 zero, zero)
    gen = torch.Generator(st.field.device).manual_seed(seed)
    for it in range(T):
        draws = G.IterationDraws.draw(gen, cfg, st.field.shape[0], mc.graph.n,
                                      st.beta.shape[1], st.field.device)
        carry = G.gibbs_iteration(mc.graph, mc.data, cfg, carry, it, 0, draws)
    torch.cuda.synchronize()
    return carry


def profile_iteration(mc, T=5, chains=None, steps=1):
    """Per block of models/gaussian.py: device span (CUDA events) and host
    time, ms per iteration over T iterations of ``mc``'s states tiled to
    ``chains`` with ``steps`` ASIS pairs; the bare loop's ms per iteration;
    torch.profiler's device time, launches and idle share."""
    from nngp_tpu_torch.models import gaussian as G

    run = functools.partial(_iterations, mc, chains=chains, steps=steps)
    carry = run(3)                                  # warm
    t = time.perf_counter()
    carry = run(T, carry, seed=1)
    loop_ms = 1e3 * (time.perf_counter() - t) / T

    spans = {name: [] for name in BLOCKS}
    saved = {name: getattr(G, name) for name in spans}

    def timed(name, fn):
        def wrapper(*a, **k):
            ev = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
            t0 = time.perf_counter()
            ev[0].record()
            out = fn(*a, **k)
            ev[1].record()
            spans[name].append((ev, time.perf_counter() - t0))
            return out
        return wrapper

    try:
        for name, fn in saved.items():
            setattr(G, name, timed(name, fn))
        carry = run(T, carry, seed=2)
    finally:
        for name, fn in saved.items():
            setattr(G, name, fn)
    blocks = {name: {"device_ms": sum(e[0].elapsed_time(e[1])
                                      for e, _ in v) / T,
                     "host_ms": 1e3 * sum(h for _, h in v) / T,
                     "calls": len(v) / T}
              for name, v in spans.items()}

    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run(T, carry, seed=3)
    busy_us, launches, by_name = 0.0, 0, {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            us = e.time_range.elapsed_us()
            busy_us += us
            launches += 1
            key = e.name[:80]
            by_name[key] = by_name.get(key, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    device_ms = busy_us / 1e3 / T if launches else None
    return {"family": mc.graph.covfun, "chains": carry[0].field.shape[0],
            "covparams_steps": steps, "loop_ms": loop_ms,
            "blocks": blocks,
            "profiler_device_ms": device_ms,
            "launches_per_iteration": launches / T,
            "idle_share": (None if device_ms is None
                           else max(0.0, 1.0 - device_ms / loop_ms)),
            "top_kernels_ms": {k: v / 1e3 / T for k, v in top}}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--chains", type=int, nargs="*", default=[3, 96])
    ap.add_argument("--family", default="exponential_sphere")
    ap.add_argument("--profile", nargs="*", metavar="CHAINS:K",
                    help="profile one iteration at each CHAINS:K (default "
                         "3:1)")
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

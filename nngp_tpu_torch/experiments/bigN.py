"""One device at n >= 500k sites (port of experiments/bigN.py; the JAX
script's record keys, and what this package adds).

    python -m nngp_tpu_torch.experiments.bigN [--n 500000] [--chains 3]
        [--iters 25] [--halo-plan] [--device cpu] [--out FILE]

A synthetic uniform square [0, 1000]^2 with a smooth field and noise,
middle-out ordering (exact maxmin is O(n^2) host time at this n),
``exponential_isotropic``, m = 5, seed 1.  ``initialize``, one cycle of
``--iters`` iterations (the first: it builds the sweep kernel), then two
timed cycles.  ``--halo-plan`` also builds the D = 8 halo plan on the host
(``parallel/halo.py:build_halo_plan``) and reports its table sizes.  The
JAX script's ``--schedule`` and ``max_device_iters`` are TPU options,
which this package does not have.  One JSON line is appended to ``--out``.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np
import torch

from nngp_tpu_torch.experiments import _common

HALO_RANKS = 8


def problem(n: int):
    """(locs, y) of the JAX script: seed 0, n uniform sites in
    [0, 1000]^2, y = 1 + sin(x/40) cos(y/55) + N(0, 0.6^2)."""
    rng = np.random.default_rng(0)
    locs = rng.uniform(0, 1000.0, size=(n, 2))
    w = np.sin(locs[:, 0] / 40.0) * np.cos(locs[:, 1] / 55.0)
    y = 1.0 + w + rng.normal(size=n) * 0.6
    return locs, y


def fit(locs, y, chains: int, device):
    """``initialize`` as the script calls it."""
    import nngp_tpu_torch

    return nngp_tpu_torch.initialize(
        locs, y, m=5, reordering="middleout",
        stationary_covfun="exponential_isotropic", n_chains=chains, seed=1,
        device=device, verbose=False)


def graph_bytes(graph) -> int:
    """Bytes of every tensor of a device graph (level tables and
    ordered-sum tables included)."""
    total = 0
    for v in vars(graph).values():
        items = v if isinstance(v, tuple) else (
            (v.src, v.pos) if hasattr(v, "steps") else (v,))
        total += sum(t.numel() * t.element_size() for t in items
                     if isinstance(t, torch.Tensor))
    return total


def halo_plan_entry(graph) -> dict:
    """The D = 8 plan of ``graph``: its build seconds, the largest need set
    and the halo's share of the work (``plan_overlap``)."""
    from nngp_tpu_torch.parallel.halo import build_halo_plan, plan_overlap

    t0 = time.time()
    plan = build_halo_plan(graph, HALO_RANKS)
    build_s = time.time() - t0
    need = np.asarray(plan.need_rows)
    return {"D": HALO_RANKS, "build_s": round(build_s, 1),
            "need_rows_per_device": int((need < graph.n).sum(1).max()),
            "owned_rows_per_device": [int(r) for r in
                                      (np.asarray(plan.owned_rows) < graph.n)
                                      .sum(1)],
            "halo_overlap_fraction": round(plan_overlap(plan), 4)}


def parse_args(argv=None):
    ap = _common.parser(__doc__, "bigN.jsonl")
    ap.add_argument("--n", type=int, default=500_000)
    ap.add_argument("--chains", type=int, default=3)
    ap.add_argument("--iters", type=int, default=25)
    ap.add_argument("--halo-plan", action="store_true",
                    help="also build (host-side) the D=8 halo plan and "
                         "report its table sizes")
    return ap.parse_args(argv)


def measure(args, device, entry: dict):
    """``initialize``, the warm cycle and the two timed cycles of ``args``
    (``parse_args``) on ``device``, with the sweep kernel's launches counted
    from zero; fills ``entry`` (and ``entry["halo_plan"]`` with
    ``--halo-plan``) and returns the fit."""
    import nngp_tpu_torch
    from nngp_tpu_torch.ops import sweep

    cuda = device.type == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    locs, y = problem(args.n)
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    t0 = time.time()
    mc = fit(locs, y, args.chains, device)
    sync()
    setup_s = time.time() - t0
    g = mc.graph
    print(f"setup {setup_s:.1f}s  n={g.n}  "
          + json.dumps({k: round(v, 1) for k, v in mc.setup_timings.items()}),
          flush=True)

    knobs = dict(n_iterations_update=args.iters, verbose=False,
                 field_thinning=2.0 / args.iters,
                 Gelman_Rubin_Brooks_stop=(0.0, 0.0))
    sweep.chromatic_sweeps.launches = 0
    t0 = time.time()
    mc = nngp_tpu_torch.run(mc, n_cycles=1, **knobs)     # build + warm
    sync()
    first_s = time.time() - t0
    t0 = time.time()
    mc = nngp_tpu_torch.run(mc, n_cycles=2, **knobs)     # timed
    sync()
    wall = time.time() - t0
    launches = sweep.chromatic_sweeps.launches
    ms_per_iter = wall / (2 * args.iters) * 1000
    print(f"first cycle {first_s:.1f}s; timed {wall:.1f}s "
          f"=> {ms_per_iter:.1f} ms/iter at {args.chains} chains", flush=True)
    for f in ("log_scale", "shape", "field"):
        if not bool(torch.isfinite(getattr(mc.states, f)).all()):
            raise RuntimeError(f"bigN: non-finite {f} after the run")

    entry.update({
        "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
        "n": int(g.n),
        "chains": args.chains,
        "schedule": "cooperative sweep kernel, one launch an iteration",
        "setup_s": round(setup_s, 1),
        "setup_timings": {k: round(v, 2) for k, v in mc.setup_timings.items()},
        # the JAX key: the first cycle, the sweep kernel's build included
        "compile_s": round(first_s, 1),
        "ms_per_iter": round(ms_per_iter, 1),
        "it_per_s": round(1000.0 / ms_per_iter, 3),
        "iterations": mc.iterations,
        "k1_launches": launches,
        "colours": g.n_colors,
        "level_rows": g.n_levels_rows,
        "max_degree": int(g.nbr_sites.shape[1]),
        "nbr_tables_bytes": sum(t.numel() * t.element_size() for t in
                                (g.nbr_sites, g.nbr_edge, g.nbr_mask)),
        "graph_device_bytes": graph_bytes(g),
        "max_memory_allocated": (torch.cuda.max_memory_allocated(device)
                                 if cuda else None),
    })
    print(f"colours {g.n_colors}, level rows {g.n_levels_rows}, largest "
          f"degree {entry['max_degree']} (neighbour tables "
          f"{entry['nbr_tables_bytes'] / 2**20:.1f} MiB), graph on the device "
          f"{entry['graph_device_bytes'] / 2**20:.1f} MiB", flush=True)
    if args.halo_plan:
        entry["halo_plan"] = halo_plan_entry(g)
        print(f"halo plan D={HALO_RANKS}: {entry['halo_plan']}", flush=True)
    return mc


def append_line(path: str, entry: dict) -> None:
    """``entry`` as one JSON line at the end of ``path``."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "a") as f:
        f.write(json.dumps(entry) + "\n")
    print(f"appended to {path}", flush=True)


def main(argv=None) -> dict:
    args = parse_args(argv)
    device, entry = _common.setup(args)
    measure(args, device, entry)
    append_line(args.out, entry)
    return entry


if __name__ == "__main__":
    main()

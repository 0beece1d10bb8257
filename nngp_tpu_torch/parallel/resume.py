"""Resume a saved fit with its chains sharded over the ranks of a group.

    torchrun --nproc-per-node=N -m nngp_tpu_torch.parallel.resume FIT \\
        [--iterations 200] [--cycles 1] [--save OUT] [--device cuda|cpu] \\
        [--mesh-device cuda|cpu] [--sites D]

Every rank joins the group (``initialize_distributed``: torchrun's
variables or the ``NNGP_*`` ones), loads FIT on ``--device`` (the card by
default), and calls ``run(mc, mesh=...)`` over a "chains" mesh of
``--mesh-device`` (default: the fit's device; "cpu" makes a gloo group,
which lets several ranks share one card), or with ``--sites D`` over a
``("chains", "sites")`` mesh of D sites ranks a chains block (halo mode).
Rank 0 writes ``--save``.  Each rank prints one JSON line: its chains, its
sites ranks, the iterations reached, the last R-hat, a digest of the whole
fit (equal on every rank), the run's seconds and ms per iteration, each
cycle's seconds, its sweep-kernel launches, and in halo mode its halo
exchanges and the bytes it sent per iteration and the plan's overlap
(need rows / owned rows - 1).  Without a group (no launcher variables) it
runs as one process with no mesh.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import sys
import time
from dataclasses import fields

import numpy as np
import torch

RECORD_KEYS = ("beta_0", "beta", "log_scale", "log_noise_variance", "shape",
               "field", "saved_field")


def fit_digest(mc) -> str:
    """sha256 of a fit's chain states and of its records' samples (not of
    their wall-clock stamps)."""
    h = hashlib.sha256()
    for f in fields(mc.states):
        t = getattr(mc.states, f.name)
        if t is not None:
            h.update(t.detach().cpu().numpy().tobytes())
    for rec in mc.records:
        for k in RECORD_KEYS:
            if rec.get(k) is not None:
                h.update(np.ascontiguousarray(rec[k]).tobytes())
    return h.hexdigest()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("fit")
    p.add_argument("--iterations", type=int, default=200)
    p.add_argument("--cycles", type=int, default=1)
    p.add_argument("--save")
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--mesh-device", choices=("cuda", "cpu"))
    p.add_argument("--sites", type=int, default=0,
                   help="sites ranks a chains block (halo mode; 0: none)")
    args = p.parse_args(argv)

    import nngp_tpu_torch
    from nngp_tpu_torch.ops import sweep
    from nngp_tpu_torch.parallel import (global_chains_mesh, halo,
                                         halo_mesh, initialize_distributed,
                                         local_chain_slice)

    mesh = None
    mesh_device = args.mesh_device or args.device
    if initialize_distributed(device_type=mesh_device):
        mesh = (halo_mesh(args.sites, mesh_device) if args.sites
                else global_chains_mesh())
    mc = nngp_tpu_torch.load(args.fit, device=args.device)
    lo, hi = (0, mc.n_chains) if mesh is None else local_chain_slice(
        mc.n_chains, mesh)
    start, stamps = mc.iterations, len(mc.records[0]["iterations"])
    sweep.chromatic_sweeps.launches = 0
    halo._exchange.calls = halo._exchange.bytes = 0
    began = time.time() - mc.t_begin
    t = time.perf_counter()
    mc = nngp_tpu_torch.run(mc, n_iterations_update=args.iterations,
                            n_cycles=args.cycles, save_name=args.save,
                            verbose=False, mesh=mesh)
    if mc.device.type == "cuda":
        torch.cuda.synchronize()
    secs = time.perf_counter() - t
    grb = mc.diagnostics["Gelman_Rubin_Brooks"]
    done = max(1, mc.iterations - start)
    sites = {}
    if args.sites and mesh is not None:
        plan, = mc.halo_plans.values()
        sites = {"exchanges_per_iteration": halo._exchange.calls / done,
                 "exchange_bytes_per_iteration": halo._exchange.bytes / done,
                 "overlap": plan.overlap}
    print(json.dumps({
        "rank": 0 if mesh is None else mesh.get_rank(),
        "world": 1 if mesh is None else mesh.size(),
        "chains": [lo, hi],
        "sites": args.sites if mesh is not None else 0,
        "iterations": mc.iterations,
        "r_hat": grb[-1]["R_hat"].tolist() if grb else None,
        "n_diagnostics": len(grb),
        "digest": fit_digest(mc),
        "run_s": secs,
        "ms_per_iteration": 1e3 * secs / done,
        # each cycle's seconds, from the records' end-of-cycle stamps
        "cycle_s": np.diff([began] + [e for _, e in
                                      mc.records[0]["iterations"][stamps:]]
                           ).tolist(),
        "sweep_launches": sweep.chromatic_sweeps.launches,
        **sites,
        "device": (torch.cuda.get_device_name(mc.device)
                   if mc.device.type == "cuda" else "cpu"),
    }), flush=True)
    if mesh is not None:
        torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(main())

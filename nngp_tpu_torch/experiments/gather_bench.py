"""X1 on one CUDA card: the whole-sweep field update of
experiments/gather_bench.py, at its shapes (a field of 65,537 floats,
blocks of 1,024 sites with 16 neighbours, 60 blocks per sweep, 10 sweeps).

    python -m nngp_tpu_torch.experiments.gather_bench

Prints the backend and, per cluster size, the plan's build time (on the
card, outside the timed calls), then ms per call of all 10 sweeps and ns
per gathered element for
  A  the plain PyTorch loop (the counterpart of the script's xla_sweeps)
  B  the kernel csrc/gather_sweep.cu (owner computes, products pushed over
     a cluster's distributed shared memory) at cluster sizes 2, 4, 8, 16
  C  the same kernel's barriers alone: its chain of 600 steps with nothing
     loaded or stored, the floor of B
Raises without a CUDA card.
"""

from __future__ import annotations

import time

import torch

from nngp_tpu_torch.experiments import data, gather_ops, timing

ELEMS = data.SWEEPS * data.NB * data.B * data.W   # gathered elements per call


def inputs(device, seed=0):
    """The script's arrays on ``device`` plus the last-occurrence mask of
    the block sites."""
    t = data.to_device(data.bench_arrays(seed), device)
    t["keep"] = gather_ops.last_occurrence(t["sites"])
    return t


def sweep_args(t):
    return t["sites"], t["nbrs"], t["q"], t["P"], t["noise"], t["keep"]


def _line(label, ms):
    print(f"{label}: {ms:.4f} ms  ({ms / ELEMS * 1e6:.4f} ns/elt)", flush=True)


def main(seed=0):
    """Time A-C; returns {"plain_ms": A, cluster size: B, "floor_ms":
    {cluster: C}, "plan_s": {cluster: seconds}}."""
    dev = timing.cuda_device()
    print("backend:", f"cuda ({torch.cuda.get_device_name(dev)})")
    t = inputs(dev, seed)
    args = sweep_args(t)
    w = t["w0"].clone()
    reset = lambda: w.copy_(t["w0"])  # noqa: E731

    out = {"floor_ms": {}, "plan_s": {}}
    plans = {}
    for cs in gather_ops.CLUSTERS:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plans[cs] = gather_ops.gather_sweeps_plan(
            t["sites"], t["nbrs"], t["q"], t["keep"], cs)
        torch.cuda.synchronize()
        out["plan_s"][cs] = time.perf_counter() - t0
        pushes = plans[cs].pushes
        print(f"plan build, cluster {cs}: {out['plan_s'][cs]:.4f} s "
              f"({int((pushes[..., 2] >= 0).sum())} pushes in rows of "
              f"{pushes.shape[1]}, {plans[cs].slots} partial slots)",
              flush=True)

    ms = timing.median_ms(
        lambda: gather_ops.gather_sweeps_reference(w, *args), 5, reset)
    _line("A plain PyTorch loop", ms)
    out["plain_ms"] = ms
    for cs in gather_ops.CLUSTERS:
        plan = plans[cs]
        ms = timing.median_ms(
            lambda: gather_ops.gather_sweeps(w, *args, cluster=cs, plan=plan),
            21, reset)
        _line(f"B cuda DSMEM pushes, cluster {cs}", ms)
        out[cs] = ms
        ms = timing.median_ms(
            lambda: gather_ops.gather_sweeps_floor(w, t["P"], t["noise"],
                                                   plan), 21)
        _line(f"C barriers alone, cluster {cs}", ms)
        out["floor_ms"][cs] = ms
    return out


if __name__ == "__main__":
    main()

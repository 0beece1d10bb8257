"""X1 on one CUDA card: the whole-sweep field update of
experiments/gather_bench.py, at its shapes (a field of 65,537 floats,
blocks of 1,024 sites with 16 neighbours, 60 blocks per sweep, 10 sweeps).

    python -m nngp_tpu_torch.experiments.gather_bench

Prints the backend, then ms per call of all 10 sweeps and ns per gathered
element for
  A  the plain PyTorch loop (the counterpart of the script's xla_sweeps)
  B  the kernel csrc/gather_sweep.cu, field in a cluster's distributed
     shared memory, at cluster sizes 2, 4, 8 and 16
Raises without a CUDA card.
"""

from __future__ import annotations

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


def main(seed=0):
    """Time A and B; returns {"plain_ms": A, cluster size: B}."""
    dev = timing.cuda_device()
    print("backend:", f"cuda ({torch.cuda.get_device_name(dev)})")
    t = inputs(dev, seed)
    args = sweep_args(t)
    w = t["w0"].clone()
    reset = lambda: w.copy_(t["w0"])  # noqa: E731

    ms = timing.median_ms(
        lambda: gather_ops.gather_sweeps_reference(w, *args), 5, reset)
    print(f"A plain PyTorch loop: {ms:.3f} ms  ({ms / ELEMS * 1e6:.3f} ns/elt)")
    out = {"plain_ms": ms}
    for cs in gather_ops.CLUSTERS:
        ms = timing.median_ms(
            lambda: gather_ops.gather_sweeps(w, *args, cluster=cs), 21, reset)
        print(f"B cuda DSMEM cluster {cs}: {ms:.3f} ms  "
              f"({ms / ELEMS * 1e6:.3f} ns/elt)")
        out[cs] = ms
    return out


if __name__ == "__main__":
    main()

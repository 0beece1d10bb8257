"""X3 on one CUDA card: the seven bodies of experiments/gather_probe2.py
(equal-shape gathers, a three-stage Beneš route, roll, transpose, a
4096-row source, an int32 lane gather) as CUDA kernels.

    python -m nngp_tpu_torch.experiments.gather_probe2

Prints what gather_probe does, per body.  Raises without a CUDA card.
"""

from __future__ import annotations

import torch

from nngp_tpu_torch.experiments import data, gather_ops as ops, timing
from nngp_tpu_torch.experiments.gather_probe import Probe, run


def probes(a):
    """The script's bodies over its arrays ``a`` (data.probe2_arrays on the
    device), in the script's order."""
    gather, ref = ops.staged_gather, ops.staged_gather_reference
    lane, eq = a["lane_idx"], a["idx_eq"]
    return [
        Probe("sublane gather equal-shape", gather, ref,
              (a["src"], [("rows", eq)])),
        Probe("lane gather equal-shape", gather, ref,
              (a["src"], [("cols", lane)])),
        Probe("3-stage benes route", gather, ref,
              (a["src"], [("cols", lane), ("rows", eq), ("cols", lane)])),
        Probe("pltpu.roll axis=0", gather, ref, (a["src"], [("roll", 3)])),
        Probe("transpose 128x128", gather, ref,
              (a["src"][:data.C], [("trans",)])),
        Probe("sublane gather idx<src rows", gather, ref,
              (a["src_big"], [("rows", a["idx_small"])])),
        Probe("lane gather int32", gather, ref, (a["srci"], [("cols", lane)])),
    ]


def main(seed=0):
    dev = timing.cuda_device()
    print("backend:", f"cuda ({torch.cuda.get_device_name(dev)})")
    return run(probes(data.to_device(data.probe2_arrays(seed), dev)))


if __name__ == "__main__":
    main()

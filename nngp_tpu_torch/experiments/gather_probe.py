"""X2 on one CUDA card: the five bodies of experiments/gather_probe.py
(sublane, lane and chained gathers, a column scatter, a 512 x 1024 by
1024 x 128 matmul) as CUDA kernels, at the script's shapes.

    python -m nngp_tpu_torch.experiments.gather_probe

Prints the backend, then for each body the kernel's us per call and ns per
output element, and its plain PyTorch twin's us per call.  Each time is
that of 100 calls enqueued back to back between two CUDA events, the
counterpart of the script's in-kernel fori_loop(0, 100).  Raises without a
CUDA card.
"""

from __future__ import annotations

from collections import namedtuple

import torch

from nngp_tpu_torch.experiments import data, gather_ops as ops, timing

# one body: its printed name, the wrapper (kernel on a card), the plain
# twin, and their arguments
Probe = namedtuple("Probe", "name op plain args")


def probes(a):
    """The script's bodies over its arrays ``a`` (data.probe_arrays on the
    device), in the script's order."""
    gather, gather_ref = ops.staged_gather, ops.staged_gather_reference
    return [
        Probe("take_along_axis axis=0 (sublane)", gather, gather_ref,
              (a["src"], [("rows", a["row_idx"])])),
        Probe("take_along_axis axis=1 (lane)", gather, gather_ref,
              (a["x2"], [("cols", a["lane_idx"])])),
        Probe("chained sublane+lane", gather, gather_ref,
              (a["src"], [("rows", a["row_idx"]), ("cols", a["lane_idx"])])),
        Probe("scatter .at[vec,0].set", ops.column_scatter,
              ops.column_scatter_reference,
              (a["scat_val"], a["scat_idx"], data.R)),
        Probe("one-hot matmul 512x1024 @ 1024x128", ops.matmul_f32,
              ops.matmul_f32_reference, (a["mm_a"], a["mm_b"])),
    ]


def run(probe_list, reps=100):
    """Time each probe's kernel and plain twin; prints one line per probe
    and returns a list of dicts."""
    results = []
    for p in probe_list:
        elems = p.op(*p.args).numel()
        ms, host_ms = timing.per_call_ms(lambda: p.op(*p.args), reps)
        plain_ms, _ = timing.per_call_ms(lambda: p.plain(*p.args), reps)
        print(f"{p.name}: OK  {ms * 1e3:.2f} us/call  "
              f"({ms / elems * 1e6:.4f} ns/elt); plain "
              f"{plain_ms * 1e3:.2f} us/call; host enqueue "
              f"{host_ms * 1e3:.2f} us/call")
        results.append({"name": p.name, "op": p.op.__name__, "ms": ms,
                        "plain_ms": plain_ms, "host_ms": host_ms,
                        "elems": elems})
    return results


def main(seed=0):
    dev = timing.cuda_device()
    print("backend:", f"cuda ({torch.cuda.get_device_name(dev)})")
    return run(probes(data.to_device(data.probe_arrays(seed), dev)))


if __name__ == "__main__":
    main()

"""The chromatic sweep kernel's share of its bound: the least time of a
call on an H100 SXM (bytes over 3.35 TB/s or float32 operations over 67
TFLOP/s, ``counts/sweep.py``) over its mean device time a call."""

from benchmark.counts.peaks import bound_s
from benchmark.counts.sweep import sweep_bytes_flops
from benchmark.trace import mean_call_s


def read(run):
    t = mean_call_s(run.events, "chromatic_sweeps_kernel")
    if t is None:
        return None
    sh = run.shapes
    nbytes, flops = sweep_bytes_flops(sh["C"], sh["S"], sh["n"], sh["nnz"],
                                      sh["n_colors"])
    return 100.0 * bound_s(nbytes, flops) / t

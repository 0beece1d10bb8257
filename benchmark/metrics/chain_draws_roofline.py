"""The draws kernel's share of its bound over its mean device time a call:
the larger of the bytes written over 3.35 TB/s and a fixed float64
operation count a normal over 34 TFLOP/s (``counts/draws.py``)."""

from benchmark.counts.draws import draws_bytes_flops
from benchmark.counts.peaks import bound_s
from benchmark.trace import mean_call_s


def read(run):
    t = mean_call_s(run.events, "chain_draws_kernel")
    if t is None:
        return None
    sh = run.shapes
    nbytes, flops = draws_bytes_flops(sh["C"], sh["normals"], sh["uniforms"])
    return 100.0 * bound_s(nbytes, flops, f64=True) / t

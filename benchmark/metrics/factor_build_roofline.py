"""The factor build kernel's share of its bound over its mean device time a
call.  Bytes over 3.35 TB/s against operations (``counts/factor_build.py``):
float32 over 67 TFLOP/s for the exponential families, float64 over 34
TFLOP/s for Matérn, whose operations are counted at the states the window
ended on."""

from benchmark.counts.factor_build import factor_bytes, factor_ops
from benchmark.counts.peaks import bound_s
from benchmark.trace import mean_call_s


def read(run):
    t = mean_call_s(run.events, "factor_build_kernel")
    if t is None:
        return None
    sh, f = run.shapes, run.factor
    flops = factor_ops(run.covfun, f["d2_pairs"], f["pair_valid"],
                       sh["k"] - 1, f["natural"])
    nbytes = factor_bytes(sh["n"], sh["k"], sh["C"], sh["ns"])
    return 100.0 * bound_s(nbytes, flops,
                           run.covfun.startswith("matern")) / t

"""The level solve kernel's share of its bound: the least time of a call on
an H100 SXM (its bytes over 3.35 TB/s, ``counts/level_solve.py``) over its
mean device time a call."""

from benchmark.counts.level_solve import level_solve_bytes
from benchmark.counts.peaks import bound_s
from benchmark.trace import mean_call_s


def read(run):
    t = mean_call_s(run.events, "level_solve_kernel")
    if t is None:
        return None
    sh = run.shapes
    return 100.0 * bound_s(level_solve_bytes(sh["C"], sh["n"], sh["k"])) / t

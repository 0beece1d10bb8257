"""CPU tests of the level solve's frozen byte count and its roofline reader.

    python -m pytest benchmark/tests -q
"""

from __future__ import annotations

import pytest

from benchmark import registry
from benchmark.counts import level_solve
from benchmark.trace import Event, TracedRun


def test_level_solve_count_by_hand():
    # C=2, n=3, k=2: linv 12, v 6, x 6 floats; the tables 6 ints
    assert level_solve.level_solve_bytes(2, 3, 2) == 4 * (12 + 6 + 6 + 6)


def test_level_solve_roofline_reads_the_kernels_mean_call():
    C, n, k = 96, 58097, 6
    events = [Event("void level_solve_kernel<false>(float const*)", 0,
                    200_000, "kernel"),
              Event("level_solve_kernel<true>", 300_000, 400_000, "kernel"),
              Event("chromatic_sweeps_kernel", 0, 900_000, "kernel")]
    run = TracedRun(events, 1.0, 4, {}, "exponential_sphere",
                    shapes={"C": C, "n": n, "k": k})
    bound = level_solve.level_solve_bytes(C, n, k) / 3.35e12
    assert registry.reader("level_solve_roofline")(run) == pytest.approx(
        100 * bound / 150e-6)
    # no level solve kernel in the trace (the parent's row loop): nothing
    run = TracedRun(events[2:], 1.0, 4, {}, "exponential_sphere",
                    shapes={"C": C, "n": n, "k": k})
    assert registry.reader("level_solve_roofline")(run) is None

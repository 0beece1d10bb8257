"""Share of the traced stretch's wall time in which no device operation
(kernel, copy or fill) ran: 100 (1 - union of their intervals / wall)."""

from benchmark.trace import union_s


def read(run):
    if not run.events or run.wall_s <= 0:
        return None
    return 100.0 * (1.0 - union_s(run.events) / run.wall_s)

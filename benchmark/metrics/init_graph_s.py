"""Host seconds of initialize's graph stages (ordering, neighbour search,
colouring and levels, neighbour distances), from the sampler's
``setup_timings``."""

STAGES = ("ordering_s", "nn_search_s", "coloring_s", "nn_dist2_s")


def read(run):
    t = run.setup_timings
    if not all(k in t for k in STAGES):
        return None
    return sum(float(t[k]) for k in STAGES)

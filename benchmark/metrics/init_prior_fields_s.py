"""Host seconds of initialize's initial states (one prior field a chain),
from the sampler's ``setup_timings``."""


def read(run):
    v = run.setup_timings.get("prior_fields_s")
    return None if v is None else float(v)

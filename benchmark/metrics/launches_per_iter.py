"""Device kernels a Gibbs iteration in the traced stretch."""


def read(run):
    kernels = [e for e in run.events if e.kind == "kernel"]
    if not kernels or run.iterations <= 0:
        return None
    return len(kernels) / run.iterations

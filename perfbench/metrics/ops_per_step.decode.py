"""Device operations per decode step of the batch, in the profiled
steps."""


def read(run):
    p = run.profile
    return None if p is None or not p.units else p.n_ops / p.units

"""Device operations per agent step in the profiled part of the
fleet's window (collection's forwards included)."""


def read(run):
    p = run.profile
    return None if p is None or not p.units else p.n_ops / p.units

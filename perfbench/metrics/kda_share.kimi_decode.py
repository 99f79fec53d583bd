"""Kernel E's share of the profiled decode steps' device time: the device
seconds of the operations whose name holds ``kda_`` (``kda_step``, the
fused KDA decode step; nothing else on the path has such a name) over the
seconds in which any operation ran, in percent.  The rest of the KDA
mixer (its projections, short convolutions, gates and output norm) runs
as library kernels under other names and is not counted."""


def read(run):
    p = run.profile
    if p is None or p.busy_s <= 0:
        return None
    _, seconds = p.kernel("kda_")
    return 100.0 * seconds / p.busy_s

"""Kernel G's share of the profiled decode steps' device time: the device
seconds of the operations whose name holds ``mhc_`` (``mhc_pre_kernel``
and ``mhc_post_kernel``, Xing4.0's mHC sites; nothing else on the path
has such a name) over the seconds in which any operation ran, in
percent.  The sites' sublayers' own norms are kernel C's, not counted."""


def read(run):
    p = run.profile
    if p is None or p.busy_s <= 0:
        return None
    _, seconds = p.kernel("mhc_")
    return 100.0 * seconds / p.busy_s

"""Kernel G (``mhc_pre_kernel`` and ``mhc_post_kernel``, one mHC site of
Xing4.0 in two launches) in the profiled decode steps: the least time
its launches could take (``roofline/xing4.py``: a site's stream read,
read again and written, u and y, phi and the norm's scale once, the
coefficients; its projection's products at the float32 units' peak)
over their device time, in percent.  Nothing where the trace's launches
are not two a site, two sites a layer, a step."""

from perfbench.roofline import xing4
from perfbench.roofline.peaks import peaks, roofline_share

LAUNCHES_A_SITE = 2


def read(run):
    p, prof = peaks(run.device), run.profile
    if p is None or prof is None or not prof.units:
        return None
    c = run.cell.config
    launches, seconds = prof.kernel("mhc_")
    per_step = xing4.sites(c) * LAUNCHES_A_SITE
    if launches != prof.units * per_step or seconds <= 0:
        return None
    site_steps = launches // LAUNCHES_A_SITE
    rows = run.window["batch"]
    flops = site_steps * xing4.site_kernel_flops(c, rows)
    nbytes = site_steps * xing4.site_bytes(c, rows)
    return roofline_share(flops, nbytes, seconds, p, p["fp32_flops"])

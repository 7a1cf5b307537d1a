"""The share of the measured window in which no operation ran on the
device, in percent: 1 - (the device's busy time that the window's
V-cycles stand for) / (the window's wall).  The busy time is the union of
the device operations' intervals over the traced stretch, per V-cycle
there, times the window's V-cycles: the profiler slows the host but not
the kernels, so the stretch's own idle share would count its overhead.
Per V-cycle, not per slab, since the stretch's few slabs take more or
fewer V-cycles than the window's mean.  Where the card is saturated it
reads within the slabs' noise of 0, either side."""


def read(summary):
    t, w = summary["trace"], summary["window"]
    vc = t and t["spans"].get("vcycle")
    if (not vc or not vc["count"] or t["busy_s"] <= 0 or not w["vcycles"]
            or w["elapsed_s"] <= 0):
        return None
    busy = t["busy_s"] / vc["count"] * w["vcycles"]
    return 100.0 * (1.0 - busy / w["elapsed_s"])

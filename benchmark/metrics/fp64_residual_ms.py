"""Device time of the operations launched inside the harness's span
around the FP64 IR residual, per residual (one a slab), over the traced
stretch."""


def read(summary):
    t = summary["trace"]
    st = t and t["spans"].get("fp64_residual")
    if not st or not st["count"] or st["device_s"] <= 0:
        return None
    return 1e3 * st["device_s"] / st["count"]

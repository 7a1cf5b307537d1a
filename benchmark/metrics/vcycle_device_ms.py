"""Device time of the operations launched inside the V-cycle span, per
V-cycle, over the traced stretch."""


def read(summary):
    t = summary["trace"]
    st = t and t["spans"].get("vcycle")
    if not st or not st["count"] or st["device_s"] <= 0:
        return None
    return 1e3 * st["device_s"] / st["count"]

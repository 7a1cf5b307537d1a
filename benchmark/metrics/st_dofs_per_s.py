"""Space-time DoFs of every slab of the window over the time from the
window's start to the end of its last slab (host clock)."""


def read(summary):
    w = summary["window"]
    if not w["slabs"] or w["elapsed_s"] <= 0:
        return None
    return w["slabs"] * w["dofs_per_slab"] / w["elapsed_s"]

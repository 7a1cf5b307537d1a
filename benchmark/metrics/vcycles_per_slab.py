"""Calls of the V-cycle callable that the harness hands to the solver,
over the window's slabs (first solve and correction solve together)."""


def read(summary):
    w = summary["window"]
    return w["vcycles"] / w["slabs"] if w["slabs"] else None

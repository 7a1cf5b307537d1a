"""Host time inside each call of the V-cycle callable that the harness
hands the solver (the enqueue, and any wait in it: where the card sets
the pace the launch queue fills and the host waits), per V-cycle, over
the measured window, which runs without the profiler (host clock)."""


def read(summary):
    w = summary["window"]
    return 1e3 * w["vcycle_host_s"] / w["vcycles"] if w["vcycles"] else None

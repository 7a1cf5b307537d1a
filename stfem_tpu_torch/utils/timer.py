"""Named-scope wall timing (counterpart of stfem_tpu/utils/timer.py; the
reference's deal.II TimerOutput scopes, tp_01.cc:648,709-710).

A scope is a torch.profiler record_function range as well, so it shows in
a trace; `sync` (a device) synchronizes before the clock stops, so a scope
around queued GPU work measures the work and not its enqueue."""
from __future__ import annotations

import contextlib
import time
from collections import defaultdict

import torch


class TimerOutput:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.times = defaultdict(list)      # every call's wall, in order

    @contextlib.contextmanager
    def scope(self, name: str, sync=None):
        with torch.profiler.record_function(name):
            t0 = time.time()
            yield
            if sync is not None and torch.device(sync).type == "cuda":
                torch.cuda.synchronize(sync)
        dt = time.time() - t0
        self.totals[name] += dt
        self.counts[name] += 1
        self.times[name].append(dt)

    def summary(self) -> str:
        lines = ["+---------------------------------+------------+--------+",
                 "| Section                         | wall time  | calls  |",
                 "+---------------------------------+------------+--------+"]
        for name in sorted(self.totals):
            lines.append(f"| {name:<31} | {self.totals[name]:9.3f}s | "
                         f"{self.counts[name]:6d} |")
        lines.append(lines[0])
        return "\n".join(lines)

    def print_wall_time_statistics(self):
        print(self.summary())

"""Named-scope wall timing (counterpart of stfem_tpu/utils/timer.py; the
reference's deal.II TimerOutput scopes, tp_01.cc:648,709-710) and the
program's tracer.

The tracer records named spans and counters from inside the library (the
V-cycle's levels and stages, the level operators, the smoother, the
transfers, the Krylov solvers' host reads, the set-up).  It is off by
default: then `span(name)` checks one module-level flag and returns a
shared no-op context (no allocation, no clock read, no profiler range),
and `count` returns at the same check.  Inside `tracing()` each span
appends [name, parent index, start ns, end ns] (time.perf_counter_ns) to
an in-memory list and each count adds to a counter; with
`tracing(profiler=True)` each span is also a torch.profiler
record_function range of the same name, on the profiler's clock.
`records()` returns both, `clear()` empties them.  One thread records at
a time.

Span names (`L{l}` is the GMG level, 0 the coarsest):
  stmg.vcycle; stmg.smooth.L{l}, stmg.residual.L{l}, stmg.restrict.L{l},
      stmg.prolongate.L{l}, stmg.post_smooth.L{l}, stmg.coarse.L0
      (stage spans, which do not nest across levels)     stmg/gmg.py
  sysmat.vmult > sysmat.space, sysmat.time_mix           system.py
  vanka.vmult > vanka.down, vanka.time, vanka.up         stmg/vanka.py
  transfer.restrict, transfer.prolongate                 stmg/transfers.py
  residual64                                             ops/slab_residual.py
  krylov.norm_read                                       krylov.py
  stmg.build > stmg.build.level.L{l} > stmg.build.vanka.L{l},
      stmg.build.estimate.L{l}; stmg.build.coarse_direct  stmg/gmg.py
  kernels.load                                           ops/cuda_kernels.py
Counters: stmg.vcycles, sysmat.vmults.<route>, vanka.applies,
krylov.host_reads, eig_cache.hits, eig_cache.misses, kernels.built, and
from records() the kernels' own launch counts over the traced time,
kernel.<name>.launches.

A TimerOutput scope is a span as well; `sync` (a device) synchronizes
before the clock stops, so a scope around queued GPU work measures the
work and not its enqueue."""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict

import torch

_ON = False
_PROFILE = False
# the record, one column each (flat lists of str and int, which the
# garbage collector does not traverse however long a traced stretch runs)
_NAMES: list = []
_PARENTS: list = []        # index of the enclosing span, or -1
_STARTS: list = []         # ns
_ENDS: list = []
_STACK: list = []          # indices of the open spans
_COUNTS: dict = defaultdict(int)
_LAUNCHES0: dict = {}      # the kernels' launch counts at the last fold
_CLEARS = 0                # clear()s so far: a span open across one is
                           # not recorded


class _Off:
    """The shared context of a span while the tracer is off."""
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, exc_type, exc, tb):
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("name", "index", "cleared", "range")

    def __init__(self, name: str):
        self.name = name
        self.range = None

    def __enter__(self):
        if _PROFILE:
            self.range = torch.profiler.record_function(self.name)
            self.range.__enter__()
        self.index = len(_NAMES)
        self.cleared = _CLEARS
        _NAMES.append(self.name)
        _PARENTS.append(_STACK[-1] if _STACK else -1)
        _ENDS.append(0)
        _STACK.append(self.index)
        _STARTS.append(time.perf_counter_ns())
        return None

    def __exit__(self, exc_type, exc, tb):
        end = time.perf_counter_ns()
        if self.cleared == _CLEARS:
            _ENDS[self.index] = end
            if _STACK and _STACK[-1] == self.index:
                _STACK.pop()
        if self.range is not None:
            self.range.__exit__(exc_type, exc, tb)
        return None


def span(name: str):
    """A context manager: a recorded span while tracing, else a no-op."""
    if not _ON:
        return _OFF
    return _Span(name)


def traced(name: str):
    """Decorator: every call of the function is the span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return inner
    return wrap


def count(name: str, n: int = 1) -> None:
    """Add n to the counter `name` while tracing."""
    if _ON:
        _COUNTS[name] += n


def _launches() -> dict:
    """The kernels' own launch counters (their `.launches` attributes)."""
    from ..ops.banded_apply import banded_apply
    from ..ops.grid_chain import chain_down, chain_up
    from ..ops.kron_pair import kron_pair
    from ..ops.level_pair import level_pair
    from ..ops.quad_middle import quad_middle
    from ..ops.time_solve import time_solve
    return {f.__name__: f.launches for f in (time_solve, kron_pair,
                                              banded_apply, chain_down,
                                              chain_up, quad_middle,
                                              level_pair)}


def _fold_launches() -> None:
    """Count the kernels' launches since the last fold."""
    now = _launches()
    for name, n in now.items():
        if n != _LAUNCHES0.get(name, n):
            _COUNTS[f"kernel.{name}.launches"] += n - _LAUNCHES0[name]
    _LAUNCHES0.clear()
    _LAUNCHES0.update(now)


@contextlib.contextmanager
def tracing(profiler: bool = False):
    """Turn the tracer on for the block (profiler: each span also opens a
    torch.profiler range); the state before it is restored after."""
    global _ON, _PROFILE
    saved = (_ON, _PROFILE)
    if not _ON:
        _LAUNCHES0.clear()
        _LAUNCHES0.update(_launches())
    _ON, _PROFILE = True, bool(profiler)
    try:
        yield
    finally:
        if not saved[0]:
            _fold_launches()
        _ON, _PROFILE = saved


def records() -> dict:
    """{"spans": [(name, parent index or -1, start ns, end ns)] in the
    order they were entered, "counters": {name: n}} since the last
    clear(); the counters hold the kernels' launches while tracing,
    kernel.<name>.launches."""
    if _ON:
        _fold_launches()
    return {"spans": list(zip(_NAMES, _PARENTS, _STARTS, _ENDS)),
            "counters": dict(_COUNTS)}


def clear() -> None:
    """Empty the record (between stretches: a span open across it is not
    recorded)."""
    global _CLEARS
    _CLEARS += 1
    for column in (_NAMES, _PARENTS, _STARTS, _ENDS, _STACK):
        column.clear()
    _COUNTS.clear()
    if _ON:
        _fold_launches()
        _COUNTS.clear()


class TimerOutput:
    def __init__(self):
        self.totals = defaultdict(float)
        self.counts = defaultdict(int)
        self.times = defaultdict(list)      # every call's wall, in order

    @contextlib.contextmanager
    def scope(self, name: str, sync=None):
        """Time the block (also when it raises); a span of the tracer."""
        t0 = time.perf_counter()
        try:
            with span(name):
                yield
                if sync is not None and torch.device(sync).type == "cuda":
                    torch.cuda.synchronize(sync)
        finally:
            dt = time.perf_counter() - t0
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

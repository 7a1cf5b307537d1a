"""One run of one cell: set-up, the measured window, the traced stretch,
the reference judgement and the result line.

The march comes from marches/<problemType>.py of the cell's
configuration, the kernel probes of the traced stretch from the cell's
roofline metrics (spec.kernel_probes).

Order of a run:
  set-up   the program (operators, hierarchy, residual), the seeded
           march (its data), the probe, the warm-up slab (slab 0,
           judged);
  window   slabs back to back for `seconds`: each slab's wall on the host
           clock after a synchronize;
  trace    (with --trace 1) the next traffic["trace"]["slabs"] slabs of
           the march, under torch.profiler with spans and the kernel
           bounds on;
  close    the memory peak, the trace summary, the program's state freed;
  judge    the march's reference judgement of the warm-up slab, of one
           window slab drawn from the seed (a reservoir sample, since the
           count is known only at the close) and of the last slab.
"""
from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time

import numpy as np
import torch

from . import spec, trace as trace_reader
from .roofline import KernelCalls


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else "not read"
    except (OSError, subprocess.SubprocessError, IndexError):
        return "not read"


class JudgedSlabs:
    """The slabs a run judges: the warm-up slab 0 (the start), one window
    slab drawn from the seed (a reservoir sample, since the window's count
    is known only at its close) and the window's last slab, each with what
    it started from (the initial state, or the previous slab's tail)."""

    def __init__(self, seed: int, march):
        self.rng = np.random.default_rng(
            np.random.SeedSequence([int(seed) % 2 ** 64, 1]))
        self.march, self.before, self.n = march, march.start, 0
        self.start = self.pick = self.last = None

    def warmup(self, i: int, x: torch.Tensor) -> None:
        if i == 0:
            self.start = ("start", i, x, self.before)
        self.before = self.march.tail(x)

    def window(self, i: int, x: torch.Tensor) -> None:
        self.n += 1
        if self.rng.random() * self.n < 1.0:
            self.pick = ("sample", i, x, self.before)
        self.last = ("last", i, x, self.before)
        self.before = self.march.tail(x)

    def slabs(self) -> list:
        out = [j for j in (self.start, self.pick) if j is not None]
        if self.last is not None and self.last[1] != self.pick[1]:
            out.append(self.last)
        return out


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", root: pathlib.Path = spec.ROOT, bench: dict | None = None,
        t_process: float | None = None, out_dir: pathlib.Path | None = None,
        ir_passes: int | None = None, log=None):
    """-> (result dict, the check lines for standard error)."""
    t_process = time.perf_counter() if t_process is None else t_process
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    device = torch.device(device)
    bench = spec.load_benchmark(root) if bench is None else bench
    c = spec.cell(bench, workload, root)
    config, traffic = c["config"], c["traffic"]
    marches = spec.march_module(config)
    timings = {"imports_s": time.perf_counter() - t_process}

    t = time.perf_counter()
    program = marches.Program(config, device)
    march = marches.march(program, traffic, seed, ir_passes)
    sync(device)
    timings["program_s"] = time.perf_counter() - t
    timings.update(program.timings)
    t = time.perf_counter()
    probe = march.probe()
    sync(device)
    timings["probe_s"] = time.perf_counter() - t
    t = time.perf_counter()
    judged = JudgedSlabs(seed, march)
    for _ in range(int(traffic["warmup_slabs"])):
        judged.warmup(*march.slab()[:2])
    sync(device)
    timings["warmup_s"] = time.perf_counter() - t
    log(f"# set-up: {json.dumps(timings)}  probe: {json.dumps(probe)}")

    walls, oks = [], []
    march.reset_counters()
    sync(device)
    t_start = time.perf_counter()
    setup_s = t_start - t_process
    n = 0
    while True:
        t0 = time.perf_counter()
        i, x, ok = march.slab()
        sync(device)
        t_end = time.perf_counter()
        walls.append(t_end - t0)
        oks.append(ok)
        n += 1
        judged.window(i, x)
        if t_end - t_start >= seconds:
            break
    vcycles, vcycle_host_s = march.vcycles, march.vcycle_host_s

    # the traced stretch: the next slabs of the same march, after the
    # window, under the profiler with spans and kernel bounds on
    prof = calls = None
    traced_walls = []
    probes = spec.kernel_probes(c["per_layer"]) if trace else []
    if trace:
        prof = _profiler(device)
        recorded = [(name, wrap, bound) for name, _, wrap, bound in probes]
        with prof, KernelCalls(recorded) as calls:
            march.spans = True
            for _ in range(int(traffic["trace"]["slabs"])):
                t0 = time.perf_counter()
                march.slab()
                sync(device)
                traced_walls.append(time.perf_counter() - t0)
            march.spans = False
    del x
    solves = march.solves
    window = {"slabs": n, "elapsed_s": t_end - t_start,
              "slab_walls_s": walls, "dofs_per_slab": program.dofs_per_slab,
              "vcycles": vcycles, "vcycle_host_s": vcycle_host_s}
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    summary = {"window": window,
               "setup": {"setup_s": setup_s, **timings}, "trace": None}
    if prof is not None:
        t = time.perf_counter()
        events, kinds = trace_reader.events_from_profiler(prof,
                                                          marches.SPANS)
        tsum = trace_reader.summarize(events, marches.SPANS,
                                      {n: k for n, k, _, _ in probes})
        tsum["kernel_bounds"] = calls.totals()
        tsum["activity_types"] = kinds
        tsum["slabs"] = len(traced_walls)
        tsum["profiler_overhead"] = (float(np.mean(traced_walls))
                                     / float(np.median(walls)) - 1.0)
        if out_dir is not None:
            out_dir.mkdir(parents=True, exist_ok=True)
            path = out_dir / f"trace-{seed}.json.gz"
            prof.export_chrome_trace(str(path))
            tsum["chrome_trace"] = str(path.relative_to(root)
                                       if path.is_relative_to(root) else path)
        tsum["summary_s"] = time.perf_counter() - t
        summary["trace"] = tsum
        del prof, events

    # free the program's state, then judge on the same device
    judged = judged.slabs()
    march.free()
    del program
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t = time.perf_counter()
    checks = march.judge(judged)
    judge_s = time.perf_counter() - t
    correct = all(math.isfinite(v["value"]) and v["value"] <= v["limit"]
                  for v in checks.values())

    metrics = spec.read_metrics(c["per_layer"] if trace else c["end_to_end"],
                                summary)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": n,
              "failed": sum(1 for ok in oks if not ok), "metrics": metrics,
              "device": dev}
    tsum = summary["trace"]
    if tsum is not None:
        dev["busy_s"] = tsum["busy_s"]
        dev["window_s"] = tsum["window_s"]
        result["breakdown"] = {"device_ops": tsum["device_ops"],
                               "idle_gaps": tsum["idle_gaps"]}
    result["info"] = {
        "workload": workload, "seed": int(seed), "seconds": seconds,
        "trace": bool(trace), "slabs": n, "vcycles": window["vcycles"],
        "vcycle_host_s": vcycle_host_s,
        "dofs_per_slab": window["dofs_per_slab"],
        "slab_s_median": float(np.median(walls)), "probe": probe,
        "setup": summary["setup"], "judge_s": judge_s,
        "judged_slabs": [j[1] for j in judged], "solves": solves,
        "power": _power_limit() if device.type == "cuda" else "cpu",
        "torch": torch.__version__}
    if tsum is not None:
        result["info"]["trace"] = {k: tsum[k] for k in (
            "slabs", "spans", "relayout_s", "groups", "kernel_bounds",
            "activity_types", "profiler_overhead", "n_device_ops",
            "summary_s") if k in tsum}
        result["info"]["trace"]["chrome_trace"] = tsum.get("chrome_trace")
    result["checks"] = checks
    lines = [f"check {k}: {v['value']:.6e} limit {v['limit']:.1e} "
             f"{'ok' if v['value'] <= v['limit'] else 'FAILED'}"
             for k, v in checks.items()]
    return result, lines


def _profiler(device):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    return profile(activities=acts)

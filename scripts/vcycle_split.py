"""The V-cycle of a benchmark cell split by level, stage and operator, on
the card, from the port's tracer (stfem_tpu_torch/utils/timer.py):

    python3 scripts/vcycle_split.py --workload heat3d-q4dg2-c16-n32.march
        --seed <n> [--window-slabs 20] [--on-slabs 10] [--out <file>]

One process, in the benchmark's order and with its march
(benchmark/marches/<problemType>.py), its caches and its trace reader:
  set-up   program, seeded march, probe and warm-up slab with the tracer
           on (no profiler): the set-up spans and counters;
  window   --window-slabs slabs with the tracer off: slab walls, V-cycles
           and the host's time inside them;
  spans-on --on-slabs slabs with the tracer on and no profiler: its cost
           (mean slab wall over the window's median, minus 1) and the
           host time of each span; then half as many slabs off again;
  profiled the cell's traffic["trace"]["slabs"] slabs under torch.profiler
           with the tracer on and its profiler ranges (last: the
           profiler leaves the host slower after it).
From the profiled stretch, each program range is named by its path of
enclosing program ranges and the benchmark's reader (benchmark/trace.py
summarize, with the port's own kernels joined to their launches:
join_ctypes_launches) gives each path's device time, relayout copies and
the idle gaps; per span name the inclusive and self device time follow, and the
V-cycle's split: the Vanka applies, the operator applies, the transfers,
the coarse solve, the levels below the finest and the remaining glue,
per V-cycle.  The disabled tracer's cost per V-cycle is a host
micro-benchmark of a disabled site times the sites a V-cycle runs.

The JSON result goes to --out (default build/vcycle_split-<cell>-<seed>
.json) and a short summary to standard output."""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import sys
import time
import timeit
from collections import defaultdict

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

PREFIXES = ("stmg.", "sysmat.", "vanka.", "transfer.", "krylov.",
            "residual64", "kernels.")


def _program(name: str) -> bool:
    return name.startswith(PREFIXES)


def _level(name: str):
    """The level of a stage span name (stmg.<stage>.L<l>), else None."""
    if not name.startswith("stmg.") or ".L" not in name:
        return None
    if name.startswith("stmg.build"):
        return None
    return int(name.rsplit(".L", 1)[1])


def path_named(events: list[dict]) -> tuple[list[dict], set]:
    """events with every program range renamed to its path of enclosing
    program ranges on its thread ("stmg.vcycle/stmg.smooth.L3/
    vanka.vmult"), and the set of those paths."""
    out, paths = [], set()
    by_tid = defaultdict(list)
    for i, e in enumerate(events):
        if e["kind"] == "cpu" and _program(e["name"]):
            by_tid[e["tid"]].append(i)
    renamed = {}
    for idx in by_tid.values():
        idx.sort(key=lambda i: (events[i]["start"], -events[i]["end"]))
        stack = []
        for i in idx:
            e = events[i]
            while stack and events[stack[-1]]["end"] <= e["start"]:
                stack.pop()
            parent = renamed[stack[-1]] if stack else None
            renamed[i] = e["name"] if parent is None else \
                f"{parent}/{e['name']}"
            stack.append(i)
    for i, e in enumerate(events):
        if i in renamed:
            e = dict(e, name=renamed[i])
            paths.add(e["name"])
        out.append(e)
    return out, paths


def program_section(tsum: dict, paths: set) -> dict:
    """Per program span name: count, host_s, inclusive device_s, self
    device_s (less its child ranges' inclusive time), relayout_s and self
    relayout_s, summed over its paths."""
    kids = defaultdict(list)
    for p in paths:
        if "/" in p:
            kids[p.rsplit("/", 1)[0]].append(p)
    out = defaultdict(lambda: {"count": 0, "host_s": 0.0, "device_s": 0.0,
                               "self_device_s": 0.0, "relayout_s": 0.0,
                               "self_relayout_s": 0.0})
    for p in paths:
        st, rel = tsum["spans"][p], tsum["relayout_s"][p]
        o = out[p.rsplit("/", 1)[-1]]
        o["count"] += st["count"]
        o["host_s"] += st["host_s"]
        o["device_s"] += st["device_s"]
        o["relayout_s"] += rel
        o["self_device_s"] += st["device_s"] - sum(
            tsum["spans"][c]["device_s"] for c in kids[p])
        o["self_relayout_s"] += rel - sum(tsum["relayout_s"][c]
                                          for c in kids[p])
    return dict(sorted(out.items()))


def vcycle_split(tsum: dict, paths: set, max_level: int) -> dict:
    """Per V-cycle (ms): the smoother's, the level operators', the
    transfers', the coarse solve's and the levels below the finest's
    device time and relayouts, and the remaining glue, each over the
    ranges inside stmg.vcycle."""
    inside = [p for p in paths if p.startswith("stmg.vcycle")]
    n = tsum["spans"].get("stmg.vcycle", {}).get("count", 0)
    if not n:
        return {}

    def total(pred, relayout=False):
        """ms per V-cycle of the paths whose last name passes pred."""
        return 1e3 * sum(
            tsum["relayout_s"][p] if relayout else tsum["spans"][p][
                "device_s"]
            for p in inside if pred(p.rsplit("/", 1)[-1])) / n

    leaf = lambda name: (lambda x: x == name)
    vc = total(leaf("stmg.vcycle"))
    smoother = total(leaf("vanka.vmult"))
    matvec = total(leaf("sysmat.vmult"))
    transfer = total(lambda x: x.startswith("transfer."))
    coarse_all = total(leaf("stmg.coarse.L0"))
    coarse_self = coarse_all - 1e3 * sum(
        tsum["spans"][p]["device_s"] for p in inside
        if p.startswith("stmg.vcycle/stmg.coarse.L0/")
        and p.count("/") == 2) / n
    below = total(lambda x: _level(x) is not None and _level(x) < max_level)
    return {"vcycles": n, "vcycle_device_ms": vc,
            "smoother_device_ms": smoother,
            "smoother_relayout_ms": total(leaf("vanka.vmult"), True),
            "matvec_device_ms": matvec,
            "matvec_relayout_ms": total(leaf("sysmat.vmult"), True),
            "transfer_device_ms": transfer,
            "coarse_solve_device_ms": coarse_all,
            "coarse_levels_device_ms": below,
            "vcycle_relayout_ms": total(leaf("stmg.vcycle"), True),
            "glue_device_ms": vc - smoother - matvec - transfer
            - coarse_self}


def by_level(tsum: dict, paths: set, n: int) -> dict:
    """Device ms per V-cycle of each stage span, by level."""
    out = defaultdict(dict)
    for p in paths:
        name = p.rsplit("/", 1)[-1]
        lvl = _level(name)
        if lvl is not None and p.startswith("stmg.vcycle/"):
            stage = name.split(".")[1]
            out[f"L{lvl}"][stage] = (out[f"L{lvl}"].get(stage, 0.0) + 1e3
                                     * tsum["spans"][p]["device_s"] / n)
    return dict(sorted(out.items(), key=lambda kv: -int(kv[0][1:])))


def host_spans(record: dict) -> dict:
    """Per span name of an in-memory record: count and host seconds."""
    out = defaultdict(lambda: [0, 0.0])
    for name, _, start, end in record["spans"]:
        out[name][0] += 1
        out[name][1] += (end - start) * 1e-9
    return {k: {"count": c, "host_s": s} for k, (c, s) in sorted(
        out.items())}


def setup_spans(record: dict) -> dict:
    """The set-up's spans (build per level, Vanka factors, estimates, the
    coarse inverse, the kernel library's load) and counters."""
    spans = {k: v for k, v in host_spans(record).items()
             if k.startswith(("stmg.build", "kernels."))}
    counters = {k: v for k, v in record["counters"].items()
                if k.startswith(("eig_cache.", "kernels."))}
    return {"spans": spans, "counters": counters}


def clock_offset(record: dict, events: list[dict]) -> dict:
    """The offset between the tracer's clock and the profiler's from the
    first stmg.vcycle of each, and how far the paired starts of all
    program ranges lie apart after it (median, p99, max, the share under
    100 us, the last pair's signed difference: the drift)."""
    ranges = sorted((e for e in events if e["kind"] == "cpu"
                     and _program(e["name"])),
                    key=lambda e: (e["start"], -e["end"]))
    spans = record["spans"]
    first_r = next(e for e in ranges if e["name"] == "stmg.vcycle")
    first_s = next(s for s in spans if s[0] == "stmg.vcycle")
    offset = first_r["start"] - first_s[2]
    paired = list(zip(ranges, spans))
    same = all(r["name"] == s[0] for r, s in paired)
    diff = sorted(abs(r["start"] - (s[2] + offset)) * 1e-3
                  for r, s in paired)
    return {"offset_ns": int(offset), "paired": len(paired),
            "names_agree": same and len(ranges) == len(spans),
            "start_diff_us": {"median": diff[len(diff) // 2],
                              "p99": diff[int(0.99 * (len(diff) - 1))],
                              "max": diff[-1]},
            "under_100us_share": sum(d < 100.0 for d in diff) / len(diff),
            "last_pair_diff_us": (paired[-1][0]["start"] - paired[-1][1][2]
                                  - offset) * 1e-3}


def launch_join(events: list[dict]) -> dict:
    """How benchmark/trace.py finds each device operation's launch: by a
    runtime call of its correlation id, by the host event its linked id
    names, or not at all; [count, seconds] per kind of kernel (the
    port's kernels by name fragment, the rest as "torch")."""
    frags = ("time_solve", "kron_pair", "banded_", "grid_chain_",
             "quad_middle", "level_pair")
    runtime = {e["corr"] for e in events if e["kind"] == "runtime"}
    host = {e["corr"] for e in events if e["kind"] == "cpu"}
    out = defaultdict(lambda: defaultdict(lambda: [0, 0.0]))
    for d in events:
        if d["kind"] != "device":
            continue
        kind = next((f for f in frags if f in d["name"]), "torch")
        how = ("runtime" if d["corr"] in runtime else "linked"
               if d["linked"] in host else "none")
        out[kind][how][0] += 1
        out[kind][how][1] += (d["end"] - d["start"]) * 1e-9
    return {"join": {k: dict(v) for k, v in out.items()}}


def join_ctypes_launches(events: list[dict]) -> int:
    """Mark as runtime calls the host events that launch the port's own
    kernels: their cudaLaunchKernel goes through the kernel library's own
    CUDA runtime, carries no linked id, and torch builds without
    activity_type() (2.11) make it a cpu event, so that benchmark/trace.py
    joins those kernels to no host event.  A host call named cuda*/cu*
    whose correlation id is a device operation's is that operation's
    launch.  Returns the count marked."""
    dev = {e["corr"] for e in events if e["kind"] == "device"}
    n = 0
    for e in events:
        if (e["kind"] == "cpu" and e["corr"] in dev and e["linked"] == 0
                and e["name"].startswith(("cuda", "cuLaunch"))):
            e["kind"] = "runtime"
            n += 1
    return n


def off_cost(record: dict, vcycles: int) -> dict:
    """A disabled span site's and count's host cost (timeit, best of 5,
    less an empty call's), and the sites a stretch runs per V-cycle (all
    its spans and counts, those of the outer solve included)."""
    from stfem_tpu_torch.utils.timer import count, span

    def site():
        with span("stmg.smooth.L3"):
            pass

    n = 200_000
    empty = min(timeit.repeat(lambda: None, number=n, repeat=5)) / n
    s = min(timeit.repeat(site, number=n, repeat=5)) / n - empty
    c = min(timeit.repeat(lambda: count("vanka.applies"), number=n,
                          repeat=5)) / n - empty
    spans = len(record["spans"])
    counts = sum(v for k, v in record["counters"].items()
                 if not k.startswith(("kernel.", "eig_cache.")))
    per_vc = ((spans / vcycles) * s + (counts / vcycles) * c
              if vcycles else None)
    return {"span_site_ns": s * 1e9, "count_ns": c * 1e9,
            "spans_per_vcycle": spans / vcycles if vcycles else None,
            "counts_per_vcycle": counts / vcycles if vcycles else None,
            "off_ms_per_vcycle": None if per_vc is None else per_vc * 1e3}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--window-slabs", type=int, default=20)
    ap.add_argument("--on-slabs", type=int, default=None)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default=None)
    ap.add_argument("--root", default=str(ROOT),
                    help="the checkout whose BENCHMARK.json names the cell")
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from benchmark import cell as bench_cell
    from benchmark import spec
    from benchmark import trace as reader
    from benchmark.run import environment
    from stfem_tpu_torch.utils import timer

    environment()
    device = torch.device(args.device)
    sync = lambda: bench_cell.sync(device)
    root = pathlib.Path(args.root)
    bench = spec.load_benchmark(root)
    c = spec.cell(bench, args.workload, root)
    config, traffic = c["config"], c["traffic"]
    marches = spec.march_module(config)
    out = {"workload": args.workload, "seed": args.seed,
           "power": bench_cell._power_limit()
           if device.type == "cuda" else "cpu",
           "torch": torch.__version__}

    t0 = time.perf_counter()
    with timer.tracing():
        program = marches.Program(config, device)
        march = marches.march(program, traffic, args.seed)
        march.probe()
        for _ in range(int(traffic["warmup_slabs"])):
            march.slab()
        sync()
    out["setup_s"] = time.perf_counter() - t0
    out["setup_spans"] = setup_spans(timer.records())
    timer.clear()
    max_level = len(program.gmg.levels) - 1
    out["levels"] = [{"level": l, "n_blocks": lv.n_blocks,
                      "dof_shape": list(lv.dof_shape),
                      "smoother": type(lv.smoother).__name__}
                     for l, lv in enumerate(program.gmg.levels)]

    # the window: tracer off
    march.reset_counters()
    walls = []
    for _ in range(args.window_slabs):
        t = time.perf_counter()
        march.slab()
        sync()
        walls.append(time.perf_counter() - t)
    vc_off = march.vcycles
    out["window"] = {"slabs": len(walls), "slab_s_median":
                     statistics.median(walls), "vcycles": vc_off,
                     "vcycle_host_ms": 1e3 * march.vcycle_host_s / vc_off}

    # the spans-on stretch: tracer on, no profiler
    n_on = args.on_slabs or int(traffic["trace"]["slabs"])
    march.reset_counters()
    on_walls = []
    with timer.tracing():
        for _ in range(n_on):
            t = time.perf_counter()
            march.slab()
            sync()
            on_walls.append(time.perf_counter() - t)
    on_rec = timer.records()
    timer.clear()
    vc_on = march.vcycles
    out["spans_on"] = {
        "slabs": n_on, "slab_s_mean": float(np.mean(on_walls)),
        "tracing_overhead": float(np.mean(on_walls))
        / statistics.median(walls) - 1.0,
        "vcycle_host_ms": 1e3 * march.vcycle_host_s / vc_on,
        "counters_per_slab": {k: v / n_on for k, v in
                              sorted(on_rec["counters"].items())},
        "host_spans": host_spans(on_rec)}
    coarse_host = sum((e - s) * 1e-9 for name, _, s, e in on_rec["spans"]
                      if _level(name) is not None
                      and _level(name) < max_level)
    out["spans_on"]["coarse_levels_host_ms"] = 1e3 * coarse_host / vc_on
    level_host = defaultdict(float)
    for name, _, s, e in on_rec["spans"]:
        if _level(name) is not None:
            level_host[f"L{_level(name)}"] += 1e3 * (e - s) * 1e-9 / vc_on
    out["spans_on"]["host_ms_by_level"] = dict(level_host)

    # the window's state again, tracer off: the drift over the stretches
    march.reset_counters()
    again = []
    for _ in range(max(2, n_on // 2)):
        t = time.perf_counter()
        march.slab()
        sync()
        again.append(time.perf_counter() - t)
    out["off_again"] = {"slabs": len(again),
                        "slab_s_median": statistics.median(again),
                        "vcycle_host_ms": 1e3 * march.vcycle_host_s
                        / march.vcycles}

    # the profiled stretch: tracer on with its ranges
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                     if device.type == "cuda" else [])
    n_prof = int(traffic["trace"]["slabs"])
    with profile(activities=acts) as prof:
        with timer.tracing(profiler=True):
            march.spans = True
            for _ in range(n_prof):
                march.slab()
                sync()
            march.spans = False
    prof_rec = timer.records()
    timer.clear()

    # the profiled stretch through the benchmark's reader
    t = time.perf_counter()
    events, kinds = reader.events_from_profiler(prof, marches.SPANS)
    out["activity_types"] = kinds
    out["launches"] = launch_join(events)
    out["clock"] = clock_offset(prof_rec, events)
    # the harness's spans as the accepted reader joins them, then with
    # the port's kernels joined to their launches
    as_is = reader.summarize(events, marches.SPANS)
    out["launches"]["marked"] = join_ctypes_launches(events)
    fixed = reader.summarize(events, marches.SPANS)
    out["harness_spans"] = {
        name: {"as_read": as_is["spans"][name], "joined": fixed["spans"][
            name], "relayout_as_read": as_is["relayout_s"][name],
               "relayout_joined": fixed["relayout_s"][name]}
        for name in marches.SPANS}
    named, paths = path_named(events)
    reader.TOP = 10 ** 9
    tsum = reader.summarize(named, set(marches.SPANS) | paths)
    out["profiled"] = {
        "slabs": n_prof, "window_s": tsum["window_s"],
        "busy_s": tsum["busy_s"],
        "harness_vcycle": {**tsum["spans"]["vcycle"],
                           "relayout_s": tsum["relayout_s"]["vcycle"]}}
    out["program"] = program_section(tsum, paths)
    split = vcycle_split(tsum, paths, max_level)
    out["split"] = split
    out["device_ms_by_level"] = by_level(tsum, paths, split["vcycles"])
    idle, idle_stage = defaultdict(float), defaultdict(float)
    for label, sec in tsum["idle_gaps"]:
        where = label.split(":", 1)[0]      # an op's name holds "::"
        stage = next((p for p in where.split("/") if _level(p) is not None),
                     where.split("/")[0] if _program(where.split("/")[0])
                     else "no program span")
        idle_stage[stage] += sec
        where, op = label.split(":", 1)
        parts = where.split("/")
        short = "/".join(parts[-2:]) if _program(parts[-1]) else where
        idle[f"{short}:{op}"] += sec
    total_idle = sum(idle.values())
    unnamed = sum(v for k, v in idle.items() if not _program(
        k.split(":", 1)[0].split("/")[-1]))
    out["idle"] = {"total_s": total_idle,
                   "no_program_span_share": unnamed / total_idle
                   if total_idle else None,
                   "top": sorted(([k, v] for k, v in idle.items()),
                                 key=lambda kv: -kv[1])[:25],
                   "by_stage": sorted(([k, v] for k, v in
                                       idle_stage.items()),
                                      key=lambda kv: -kv[1])}
    out["off_cost"] = off_cost(on_rec, vc_on)
    out["off_cost"]["share_of_vcycle_host"] = (
        out["off_cost"]["off_ms_per_vcycle"]
        / out["window"]["vcycle_host_ms"])
    out["summary_s"] = time.perf_counter() - t

    path = pathlib.Path(args.out or ROOT / "build" / (
        f"vcycle_split-{args.workload}-{args.seed}.json"))
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    brief = {k: out[k] for k in ("window", "off_again", "split", "clock",
                                 "off_cost")}
    brief["tracing_overhead"] = out["spans_on"]["tracing_overhead"]
    brief["coarse_levels_host_ms"] = out["spans_on"]["coarse_levels_host_ms"]
    brief["no_program_span_share"] = out["idle"]["no_program_span_share"]
    brief["setup_counters"] = out["setup_spans"]["counters"]
    print(json.dumps(brief, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())

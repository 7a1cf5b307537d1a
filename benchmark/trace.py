"""The trace reader: from a torch.profiler trace to the numbers the
per-layer metrics read.

It works on the trace's raw events (`events_from_profiler`), never on
key_averages(), which builds an event tree and takes minutes for a slab
of ~10^4 launches.  Each device operation (kernel, memcpy, memset) is
joined to the host: to its launch (the runtime call of the same
correlation id) or else to the op that it is linked to, and from there, by
the nesting of the host's ranges on that thread, to the chain of ops and
harness spans that enclosed the launch.  Device busy time is the union
of the device operations' intervals, so it stays right when operations
overlap on several streams.

`summarize` takes plain event dicts, so the join is tested on the CPU
against a synthetic list:
    {"kind": "cpu" | "device" | "runtime", "name", "start", "end" (ns),
     "corr", "linked", "tid"}
"""
from __future__ import annotations

from collections import defaultdict

DEVICE_SKIP = {"gpu_user_annotation", "cuda_sync", "overhead",
               "cuda_profiler_range"}
SYNC_NAMES = {"Context Sync", "Stream Sync", "Event Sync",
              "Stream Wait Event"}
CPU_KINDS = {"cpu_op", "user_annotation"}
RUNTIME_KINDS = {"cuda_runtime", "cuda_driver"}
COPY_OPS = {"aten::copy_", "aten::contiguous", "aten::clone"}
CAST_OPS = {"aten::to", "aten::_to_copy", "aten::type_as"}
TOP = 10


def _activity(e, cuda) -> str:
    """The event's kineto activity type; older torch builds do not expose
    it, and then it is told from the device, the user-annotation flag and
    the link to a torch op (a runtime call is linked, an op is not)."""
    at = getattr(e, "activity_type", None)
    if at is not None:
        return str(at())
    annot = getattr(e, "is_user_annotation", None)
    annotation = bool(annot()) if annot is not None else False
    if e.device_type() == cuda:
        if annotation:
            return "gpu_user_annotation"
        return "cuda_sync" if e.name() in SYNC_NAMES else "kernel"
    if annotation:
        return "user_annotation"
    return "cuda_runtime" if e.linked_correlation_id() != 0 else "cpu_op"


def events_from_profiler(prof, annotations=()) -> tuple[list[dict], dict]:
    """The raw events of a finished torch.profiler.profile as plain dicts,
    and the count of each activity type seen.  annotations: the names of
    the harness's spans, whose device-side copies are no device work."""
    from torch.autograd import DeviceType

    cuda = DeviceType.CUDA
    out, kinds = [], defaultdict(int)
    for e in prof.profiler.kineto_results.events():
        at = _activity(e, cuda)
        kinds[at] += 1
        if e.device_type() == cuda:
            if at in DEVICE_SKIP or e.name() in annotations:
                continue
            kind = "device"
        elif at in CPU_KINDS:
            kind = "cpu"
        elif at in RUNTIME_KINDS:
            kind = "runtime"
        else:
            continue
        start = int(e.start_ns())
        out.append({"kind": kind, "name": e.name(), "start": start,
                    "end": start + int(e.duration_ns()),
                    "corr": int(e.correlation_id()),
                    "linked": int(e.linked_correlation_id()),
                    "tid": int(getattr(e, "start_thread_id", lambda: 0)())})
    return out, dict(kinds)


def _stacks(cpu: list[dict], probes: list[tuple[int, int]]):
    """Nest the host ranges of one thread.  cpu: that thread's cpu events;
    probes: (time, id).  Returns (parent index of each cpu event, {probe
    id: index of the innermost cpu event enclosing its time, or -1})."""
    items = [(e["start"], 0, -e["end"], i) for i, e in enumerate(cpu)]
    items += [(t, 1, 0, pid) for t, pid in probes]
    items.sort()
    parent, inner, stack = [-1] * len(cpu), {}, []
    for t, typ, _, idx in items:
        while stack and cpu[stack[-1]]["end"] <= t:
            stack.pop()
        if typ == 0:
            parent[idx] = stack[-1] if stack else -1
            stack.append(idx)
        else:
            inner[idx] = stack[-1] if stack else -1
    return parent, inner


def _union(intervals, lo, hi):
    """Merged intervals of [(start, end)] clipped to [lo, hi]."""
    merged = []
    for s, e in sorted(intervals):
        s, e = max(s, lo), min(e, hi)
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def summarize(events: list[dict], spans=(), kernel_groups=None,
              window_span: str = "slab") -> dict:
    """The trace's numbers over its window: from the first start to the
    last end of the `window_span` ranges (or of all events without one).

    Returns {"window_s", "busy_s", "n_device_ops",
             "spans": {span: {"count", "host_s", "device_s"}},
             "relayout_s": {span: s}  (copies that are not casts),
             "groups": {group: {"count", "device_s"}},
             "device_ops": [[name, s]], "idle_gaps": [[label, s]]}
    with the device time of a span summed over the operations launched
    inside it, and the idle gaps labelled "<innermost span>:<innermost
    op>" of the host at each gap's middle, summed by label."""
    spans = set(spans)
    kernel_groups = kernel_groups or {}
    cpu_by_tid = defaultdict(list)
    for e in events:
        if e["kind"] == "cpu":
            cpu_by_tid[e["tid"]].append(e)
    device = [e for e in events if e["kind"] == "device"]
    runtime = {e["corr"]: e for e in events if e["kind"] == "runtime"}
    op_by_corr = {e["corr"]: e for e in events if e["kind"] == "cpu"}

    win = [e for e in events if e["kind"] == "cpu"
           and e["name"] == window_span]
    pool = win or events
    if not pool:
        raise ValueError("an empty trace")
    lo = min(e["start"] for e in pool)
    hi = max(e["end"] for e in pool)
    main_tid = (win[0]["tid"] if win else
                max(cpu_by_tid, key=lambda t: len(cpu_by_tid[t]))
                if cpu_by_tid else None)

    # each device op's launch: (tid, time)
    probes = defaultdict(list)
    for i, d in enumerate(device):
        launch = runtime.get(d["corr"])
        if launch is None:
            launch = op_by_corr.get(d["linked"])
        if launch is not None:
            probes[launch["tid"]].append((launch["start"], ("d", i)))
    busy = _union([(d["start"], d["end"]) for d in device], lo, hi)
    gaps, prev = [], lo
    for s, e in busy:
        if s > prev:
            gaps.append((prev, s))
        prev = e
    if hi > prev:
        gaps.append((prev, hi))
    if main_tid is not None:
        for j, (s, e) in enumerate(gaps):
            probes[main_tid].append(((s + e) // 2, ("g", j)))

    def chain(cpu, parent, idx):
        out = []
        while idx >= 0:
            out.append(cpu[idx]["name"])
            idx = parent[idx]
        return out

    dev_chain = [None] * len(device)
    gap_label = ["host:none"] * len(gaps)
    for tid, plist in probes.items():
        cpu = cpu_by_tid.get(tid, [])
        parent, inner = _stacks(cpu, plist)
        for (_, pid), idx in ((p, inner[p[1]]) for p in plist):
            names = chain(cpu, parent, idx)
            if pid[0] == "d":
                dev_chain[pid[1]] = names
            else:
                span = next((n for n in names if n in spans), "outside")
                op = next((n for n in names if n not in spans), "none")
                gap_label[pid[1]] = f"{span}:{op}"

    span_stats = {s: {"count": 0, "host_s": 0.0, "device_s": 0.0}
                  for s in spans}
    for e in events:
        if (e["kind"] == "cpu" and e["name"] in spans
                and e["start"] >= lo and e["end"] <= hi):
            st = span_stats[e["name"]]
            st["count"] += 1
            st["host_s"] += (e["end"] - e["start"]) * 1e-9
    relayout = {s: 0.0 for s in spans}
    groups = {g: {"count": 0, "device_s": 0.0} for g in kernel_groups}
    by_name = defaultdict(float)
    for d, names in zip(device, dev_chain):
        if d["start"] < lo or d["end"] > hi:
            continue
        sec = (d["end"] - d["start"]) * 1e-9
        by_name[d["name"]] += sec
        for g, frags in kernel_groups.items():
            if any(f in d["name"] for f in frags):
                groups[g]["count"] += 1
                groups[g]["device_s"] += sec
        if not names:
            continue
        inside = spans.intersection(names)
        for s in inside:
            span_stats[s]["device_s"] += sec
        if names[0] in COPY_OPS and not CAST_OPS.intersection(names):
            for s in inside:
                relayout[s] += sec
    idle = defaultdict(float)
    for (s, e), label in zip(gaps, gap_label):
        idle[label] += (e - s) * 1e-9
    rank = lambda d: sorted(([k[:120], v] for k, v in d.items()),
                            key=lambda kv: -kv[1])[:TOP]
    return {"window_s": (hi - lo) * 1e-9,
            "busy_s": sum(e - s for s, e in busy) * 1e-9,
            "n_device_ops": sum(1 for d in device
                                if lo <= d["start"] and d["end"] <= hi),
            "spans": span_stats, "relayout_s": relayout, "groups": groups,
            "device_ops": rank(by_name), "idle_gaps": rank(idle)}

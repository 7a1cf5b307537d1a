"""Finding a cell's pieces by name: `BENCHMARK.json` at the checkout's
root names the cells, configurations, traffic mixes and metrics; each
lives in a file of its own under `benchmark/`:
    configs/<configuration>.json, traffic/<mix>.json,
    metrics/<metric>.py (a function read(summary) -> number or None; a
        roofline metric also names its kernels, the helper to wrap and a
        call's bound: see metrics/k4_roofline.py),
    marches/<problemType>.py (the march of a configuration's problem:
        see marches/__init__.py).
Adding a cell, a mix, a metric or a problem adds files and entries; no
file here changes."""
from __future__ import annotations

import functools
import importlib
import importlib.util
import json
import pathlib

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent


def load_benchmark(root: pathlib.Path = ROOT) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _by_name(items: list[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def _read_json(path: pathlib.Path) -> dict:
    with open(path) as f:
        return json.load(f)


def cell(bench: dict, workload: str, root: pathlib.Path = ROOT) -> dict:
    """{"cell", "config", "traffic", "end_to_end", "per_layer"}: the
    workload's entry, its configuration file, its traffic file and the
    metric entries that it reports."""
    wl = _by_name(bench["workloads"], workload, "workload")
    cfg_entry = _by_name(bench["configs"], wl["config"], "config")
    config = _read_json(root / cfg_entry["file"])
    traffic = _read_json(HERE / "traffic" / f"{wl['traffic']}.json")
    applies = lambda m: workload in m.get("workloads", [workload])
    return {"cell": wl, "config": config, "traffic": traffic,
            "end_to_end": [m for m in bench["end_to_end"] if applies(m)],
            "per_layer": [m for m in bench["per_layer"] if applies(m)]}


@functools.cache
def metric_module(metric: str):
    """The module of metrics/<metric>.py, loaded once."""
    path = HERE / "metrics" / f"{metric}.py"
    spec = importlib.util.spec_from_file_location(
        f"_benchmark_metric_{metric.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str):
    """The read(summary) function of metrics/<metric>.py."""
    return metric_module(metric).read


def kernel_probes(entries: list[dict]) -> list:
    """[(name, kernel-name fragments, (module, attribute) to wrap, bound)]
    of the entries whose metric file names a kernel (the rooflines)."""
    out = []
    for m in entries:
        mod = metric_module(m["name"])
        if hasattr(mod, "WRAP"):
            out.append((m["name"], tuple(mod.KERNEL), tuple(mod.WRAP),
                        mod.bound))
    return out


def march_module(config: dict):
    """marches/<problemType>.py: the march of the configuration's
    problem."""
    name = config["problemType"]
    return importlib.import_module(f"benchmark.marches.{name}")


def read_metrics(entries: list[dict], summary: dict) -> dict:
    """{name: {"value", "unit"}} of every entry whose reader finds
    something to read."""
    out = {}
    for m in entries:
        v = reader(m["name"])(summary)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out

"""Shared fixtures of the benchmark's CPU tests: a checkout-like root with
a BENCHMARK.json that names one tiny configuration (Q2 x dG(1), 4^3
cells, 2 steps a slab) beside the real traffic mixes and metrics."""
import copy
import json
import pathlib

import pytest

from benchmark import spec

TINY = "tiny-q2dg1-c4-n2"
TINY_CELL = TINY + ".march"


def tiny_config() -> dict:
    with open(spec.HERE / "configs" / "heat3d-q4dg2-c16-n32.json") as f:
        cfg = json.load(f)
    cfg = copy.deepcopy(cfg)
    cfg.update(name=TINY, refinement=1, space_degree=2,
               space_quadrature_points=3, time_degree=1,
               nTimestepsAtOnce=2)
    cfg["solver"]["gmg"]["eig_proxy_cells"] = 0
    return cfg


@pytest.fixture
def tiny_root(tmp_path: pathlib.Path, monkeypatch) -> pathlib.Path:
    """A root holding BENCHMARK.json (the real metrics, one tiny cell)
    and the tiny configuration's file; the estimate cache in tmp_path."""
    bench = spec.load_benchmark()
    (tmp_path / "configs").mkdir()
    with open(tmp_path / "configs" / f"{TINY}.json", "w") as f:
        json.dump(tiny_config(), f)
    bench["configs"] = [{"name": TINY, "source": "test",
                         "file": f"configs/{TINY}.json", "reduced": [],
                         "why": "CPU test"}]
    bench["workloads"] = [{"name": TINY_CELL, "config": TINY,
                           "traffic": "march", "chips": 1,
                           "why": "CPU test"}]
    for m in bench["end_to_end"] + bench["per_layer"]:
        m.pop("workloads", None)
    with open(tmp_path / "BENCHMARK.json", "w") as f:
        json.dump(bench, f)
    monkeypatch.setenv("STFEM_EIG_CACHE", str(tmp_path / "eig.json"))
    return tmp_path

"""The harness finds every configuration, traffic mix and metric by name
from BENCHMARK.json, and the file keeps to the benchmark's contract."""
import json
import re

import pytest

from benchmark import spec

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = spec.load_benchmark()


def test_contract_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    runs = 2 + 14 * 24
    assert runs * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in BENCH[k]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
    texts = ([x["why"] for k in ("configs", "workloads") for x in BENCH[k]]
             + [x["source"] for x in BENCH["configs"]]
             + [m["layer"] for m in BENCH["per_layer"]] + BENCH["command"])
    for t in texts:
        assert 1 <= len(t) <= 200 and "\n" not in t and "\t" not in t, t
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("wl", [w["name"] for w in BENCH["workloads"]])
def test_cell_found_by_name(wl):
    c = spec.cell(BENCH, wl)
    cfg = c["config"]
    entry = next(x for x in BENCH["configs"] if x["name"] == cfg["name"])
    assert entry["file"].startswith("benchmark/configs/")
    assert sorted(entry["reduced"]) == sorted(cfg["reduced"])
    assert c["traffic"]["forcing"]["modes"]
    assert any(m["name"] == "setup_s" for m in c["end_to_end"])
    assert len(c["end_to_end"]) >= 2 and c["per_layer"]
    for m in c["end_to_end"] + c["per_layer"]:
        assert callable(spec.reader(m["name"]))
    # every per-layer metric's moved metric is reported in this cell
    e2e = {m["name"] for m in c["end_to_end"]}
    assert all(m["moves"] in e2e for m in c["per_layer"])


def test_every_file_is_named():
    """No metric reader or traffic mix lies about unnamed."""
    metrics = {m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]}
    files = {p.stem for p in (spec.HERE / "metrics").glob("*.py")}
    assert files == metrics
    mixes = {w["traffic"] for w in BENCH["workloads"]}
    assert mixes <= {p.stem for p in (spec.HERE / "traffic").glob("*.json")}


def _summary(trace=None):
    return {"window": {"slabs": 4, "elapsed_s": 2.0, "dofs_per_slab": 10,
                       "slab_walls_s": [0.4, 0.5, 0.6, 0.5],
                       "vcycles": 36, "vcycle_host_s": 0.9},
            "setup": {"setup_s": 12.5, "hierarchy_build_s": 1.5},
            "trace": trace}


def test_readers():
    tr = {"window_s": 2.0, "busy_s": 0.5,
          "spans": {"vcycle": {"count": 10, "host_s": 0.3, "device_s": 0.2},
                    "fp64_residual": {"count": 2, "host_s": 0.01,
                                      "device_s": 0.004}},
          "relayout_s": {"vcycle": 0.1},
          "groups": {"k4_roofline": {"count": 4, "device_s": 0.002},
                     "k2_roofline": {"count": 2, "device_s": 0.001}},
          "kernel_bounds": {"k4_roofline": {"calls": 4, "bound_s": 0.0005},
                            "k2_roofline": {"calls": 3, "bound_s": 0.0004}}}
    got = spec.read_metrics(BENCH["end_to_end"] + BENCH["per_layer"],
                            _summary(tr))
    v = {k: d["value"] for k, d in got.items()}
    assert v["st_dofs_per_s"] == 20.0 and v["setup_s"] == 12.5
    assert v["slab_s_p90"] == pytest.approx(0.57)
    assert v["vcycles_per_slab"] == 9.0
    assert v["vcycle_host_ms"] == pytest.approx(25.0)   # the window's
    assert v["vcycle_device_ms"] == pytest.approx(20.0)
    assert v["vcycle_relayout_ms"] == pytest.approx(10.0)
    assert v["fp64_residual_ms"] == pytest.approx(2.0)
    assert v["k4_roofline"] == pytest.approx(25.0)
    assert "k2_roofline" not in v        # 3 calls, 2 kernels: no pairing
    # busy 0.5 s over the stretch's 10 V-cycles stands for 1.8 s of the
    # window's 36, in its 2.0 s: 10% idle (the stretch's own read 75%)
    assert v["device_idle_share"] == pytest.approx(10.0)
    assert v["hierarchy_build_s"] == 1.5
    # without a trace the device readers find nothing, and say nothing
    got = spec.read_metrics(BENCH["per_layer"], _summary())
    assert set(got) == {"vcycles_per_slab", "vcycle_host_ms",
                        "hierarchy_build_s"}


@pytest.mark.parametrize("wl", [w["name"] for w in BENCH["workloads"]])
def test_march_found_by_problem(wl):
    """The march of a cell is marches/<problemType>.py, and it gives what
    cell.py drives."""
    c = spec.cell(BENCH, wl)
    mod = spec.march_module(c["config"])
    assert mod.__name__ == "benchmark.marches." + c["config"]["problemType"]
    assert "slab" in mod.SPANS and "vcycle" in mod.SPANS
    assert callable(mod.Program) and callable(mod.march)


def test_roofline_metrics_name_their_kernels():
    """Every roofline metric's file names its kernels, the helper it
    wraps and a call's bound; no other metric wraps anything."""
    names = [m["name"] for m in BENCH["per_layer"]]
    probes = spec.kernel_probes([{"name": n} for n in names])
    assert sorted(p[0] for p in probes) == sorted(
        n for n in names if n.endswith("_roofline"))
    for _, kernel, (module, attr), bound in probes:
        assert kernel and module.startswith("stfem_tpu_torch.") and attr
        assert callable(bound)

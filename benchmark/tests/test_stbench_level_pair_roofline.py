"""level_pair_roofline: K6's bound against a hand count, the call
recorder on its launch helper, and silence where the program has no K6."""
import importlib.util

import pytest
import torch

from benchmark import roofline, spec


def test_bound_by_hand():
    # x (2, 5, 5, 5) bf16, k = 1: read x, write K x and M x (3 x 250 x 2
    # bytes) and the two float32 tables of the three axes (2 x 3 x 15 x 4);
    # per element 8 tap sets of 3 taps, 2 operations a tap, FP32
    mod = spec.metric_module("level_pair_roofline")
    x = torch.zeros((2, 5, 5, 5), dtype=torch.bfloat16)
    nbytes = 3 * 250 * 2 + 2 * 3 * 15 * 4
    flops = 250 * 8 * 3 * 2
    assert mod.bound(x, None, None, 1) == pytest.approx(
        roofline.bound_s(nbytes, flops, "f32"))
    # at the 32^3 march's finest level the operations bound it in bf16
    x = torch.empty((96, 129, 129, 129), dtype=torch.bfloat16,
                    device="meta")
    assert mod.bound(x, None, None, 4) == pytest.approx(
        144 * x.numel() / 67e12)


def test_calls_recorded_and_passed_on(monkeypatch):
    from stfem_tpu_torch.ops import level_pair
    seen = []
    monkeypatch.setattr(level_pair, "_launch",
                        lambda *a: seen.append(a) or ("kx", "mx"))
    probes = spec.kernel_probes([{"name": "level_pair_roofline"}])
    assert [(n, k, w) for n, k, w, _ in probes] == [
        ("level_pair_roofline", ("level_pair",),
         ("stfem_tpu_torch.ops.level_pair", "_launch"))]
    x = torch.zeros((1, 3, 3, 3), dtype=torch.float32)
    with roofline.KernelCalls([(n, w, b) for n, _, w, b in probes]) as calls:
        assert level_pair._launch(x, "dm", "da", 1) == ("kx", "mx")
    assert len(seen) == 1 and seen[0][1:] == ("dm", "da", 1)
    tot = calls.totals()["level_pair_roofline"]
    assert tot["calls"] == 1 and tot["bound_s"] > 0.0


def test_silent_without_the_kernel(monkeypatch):
    """Loaded against a program without ops/level_pair.py the metric
    wraps nothing and reads nothing."""
    real = importlib.util.find_spec
    monkeypatch.setattr(
        importlib.util, "find_spec",
        lambda name, *a: None if name.endswith(".level_pair")
        else real(name, *a))
    path = spec.HERE / "metrics" / "level_pair_roofline.py"
    s = importlib.util.spec_from_file_location("_lp_without", path)
    mod = importlib.util.module_from_spec(s)
    s.loader.exec_module(mod)
    assert not hasattr(mod, "WRAP")
    trace = {"groups": {}, "kernel_bounds": {}}
    assert mod.read({"trace": trace}) is None
    assert mod.read({"trace": None}) is None

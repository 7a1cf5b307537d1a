"""The bound arithmetic against hand counts, and the call recorder's
pass-through."""
import pytest
import torch

from benchmark import roofline, spec


def test_kron_pair_by_hand():
    # x (2, 5, 5, 5) f64, k = 1: read x, write K x and M x (3 x 250 x 8
    # bytes) and the two factors' diagonals (2 x 3 x 15 x 8); per element
    # 8 tap sets of 3 taps, 2 operations a tap
    nbytes, flops = roofline.kron_pair_work((2, 5, 5, 5), 1)
    assert nbytes == 3 * 250 * 8 + 2 * 3 * 15 * 8
    assert flops == 250 * 8 * 3 * 2


def test_grid_chain_by_hand():
    # down: 2 cells of degree 1 a side (n = 3), r = 2 (q = 4): each axis'
    # factor has q (k + 1) = 8 nonzeros; the chain applies axis 0 on
    # (3, 3, 3) -> (4, 3, 3), axis 1 -> (4, 4, 3), axis 2 -> (4, 4, 4)
    nbytes, flops = roofline.grid_chain_work(
        (1, 3, 3, 3), 4, [(4, 3)] * 3, 2, 4, 1, up=False)
    assert flops == 2 * (8 * 9 + 8 * 4 * 3 + 8 * 16)
    assert nbytes == 27 * 4 + 64 * 4 + 3 * 12 * 2
    # up: the transposed factors (3, 4), same nonzeros, (4,4,4) -> (3,3,3)
    nbytes, flops = roofline.grid_chain_work(
        (2, 4, 4, 4), 2, [(3, 4)] * 3, 2, 2, 1, up=True)
    assert flops == 2 * 2 * (8 * 16 + 3 * 8 * 4 + 9 * 8)
    assert nbytes == 2 * 64 * 2 + 2 * 27 * 2 + 3 * 12 * 2


def test_bound_takes_the_larger():
    assert roofline.bound_s(3.35e12, 1.0, "f64") == pytest.approx(1.0)
    assert roofline.bound_s(1.0, 67e12, "f32") == pytest.approx(1.0)
    assert roofline.bound_s(3.35e12, 2 * 67e12, "f64") == pytest.approx(2.0)


def test_calls_recorded_and_passed_on(monkeypatch):
    """The probes come from the roofline metrics' own files; each wrapper
    passes every argument on and returns what the helper returns."""
    from stfem_tpu_torch.ops import grid_chain, kron_pair
    seen = []
    monkeypatch.setattr(grid_chain, "_launch",
                        lambda *a: seen.append(("k4", a)) or "y")
    monkeypatch.setattr(kron_pair, "kernel_args",
                        lambda *a: seen.append(("k2", a)) or "args")
    probes = spec.kernel_probes([{"name": "k4_roofline"},
                                 {"name": "k2_roofline"},
                                 {"name": "vcycle_device_ms"}])
    assert [(n, k, w) for n, k, w, _ in probes] == [
        ("k4_roofline", ("grid_chain_",),
         ("stfem_tpu_torch.ops.grid_chain", "_launch")),
        ("k2_roofline", ("kron_pair",),
         ("stfem_tpu_torch.ops.kron_pair", "kernel_args"))]
    x = torch.zeros((1, 3, 3, 3))
    mats = [torch.zeros((4, 3), dtype=torch.bfloat16)] * 3
    xk = torch.zeros((2, 5, 5, 5), dtype=torch.float64)
    with roofline.KernelCalls([(n, w, b) for n, _, w, b in probes]) as calls:
        assert grid_chain._launch(x, mats, torch.float32, (2, 2, 2), 1,
                                  False, "n") == "y"
        assert kron_pair.kernel_args(xk, "Dm", "Da", 1) == "args"
    assert seen[0][1][0] is x
    assert seen[0][1][1:] == (mats, torch.float32, (2, 2, 2), 1, False, "n")
    assert seen[1][1] == (xk, "Dm", "Da", 1)
    t = calls.totals()
    assert t["k4_roofline"]["calls"] == 1 and t["k2_roofline"]["calls"] == 1
    n4, f4 = roofline.grid_chain_work((1, 3, 3, 3), 4, [(4, 3)] * 3, 2, 4,
                                      1, False)
    assert t["k4_roofline"]["bound_s"] == pytest.approx(
        roofline.bound_s(n4, f4, "f32"))
    n2, f2 = roofline.kron_pair_work((2, 5, 5, 5), 1)
    assert t["k2_roofline"]["bound_s"] == pytest.approx(
        roofline.bound_s(n2, f2, "f64"))
    # restored on exit
    assert kron_pair.kernel_args("a", "b", "c", 0) == "args"
    assert calls.totals()["k2_roofline"]["calls"] == 1

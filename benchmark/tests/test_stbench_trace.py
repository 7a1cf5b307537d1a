"""The trace reader on a synthetic event list: the join of device
operations to the host's spans, busy time as a union, the relayout
filter, the roofline groups and the idle gaps' labels."""
import pytest

from benchmark import trace

US = 1000  # ns


def ev(kind, name, start, end, corr=0, linked=0, tid=1):
    return {"kind": kind, "name": name, "start": start * US,
            "end": end * US, "corr": corr, "linked": linked, "tid": tid}


def synthetic():
    return [
        ev("cpu", "slab", 0, 1000, corr=1),
        ev("cpu", "vcycle", 10, 400, corr=2),
        ev("cpu", "aten::to", 20, 60, corr=3),
        ev("cpu", "aten::copy_", 30, 50, corr=4),           # a cast
        ev("runtime", "cudaLaunchKernel", 35, 40, corr=100, linked=4),
        ev("device", "copy_kernel", 100, 200, corr=100),
        ev("cpu", "aten::contiguous", 70, 90, corr=5),
        ev("cpu", "aten::copy_", 72, 88, corr=6),           # a relayout
        ev("runtime", "cudaLaunchKernel", 75, 80, corr=101, linked=6),
        ev("device", "copy_kernel", 150, 260, corr=101),    # overlaps
        ev("cpu", "aten::mm", 95, 99, corr=7),
        # launched by ctypes: no runtime event kept, linked to the span
        ev("device", "grid_chain_down_kernel<5>", 300, 340, corr=102,
           linked=2),
        ev("cpu", "fp64_residual", 500, 900, corr=8),
        ev("cpu", "aten::item", 600, 880, corr=9),
        ev("runtime", "cudaLaunchKernel", 510, 515, corr=103, linked=8),
        ev("device", "kron_pair_kernel<4>", 520, 580, corr=103),
        # outside the window: ignored
        ev("device", "late", 1200, 1300, corr=104),
    ]


def test_summary():
    s = trace.summarize(synthetic(), ("slab", "vcycle", "fp64_residual"),
                        {"k4": ("grid_chain_",), "k2": ("kron_pair",)})
    assert s["window_s"] == pytest.approx(1000e-6)
    # union of [100, 260], [300, 340], [520, 580]
    assert s["busy_s"] == pytest.approx((160 + 40 + 60) * 1e-6)
    assert s["n_device_ops"] == 4
    v = s["spans"]["vcycle"]
    assert v["count"] == 1 and v["host_s"] == pytest.approx(390e-6)
    assert v["device_s"] == pytest.approx((100 + 110 + 40) * 1e-6)
    assert s["spans"]["slab"]["device_s"] == pytest.approx(310e-6)
    assert s["spans"]["fp64_residual"]["device_s"] == pytest.approx(60e-6)
    # the copy under aten::to is a cast, not a relayout
    assert s["relayout_s"]["vcycle"] == pytest.approx(110e-6)
    assert s["groups"]["k4"] == {"count": 1,
                                 "device_s": pytest.approx(40e-6)}
    assert s["groups"]["k2"]["count"] == 1
    assert s["device_ops"][0] == ["copy_kernel", pytest.approx(210e-6)]
    gaps = dict(s["idle_gaps"])
    # the gaps at their middles: [0, 100] at 50 in aten::to in the
    # V-cycle; [260, 300] at 280 in the V-cycle, no op; [340, 520] at 430
    # in the slab, outside the other spans; [580, 1000] at 790 in
    # aten::item in the residual
    assert gaps == {"vcycle:aten::to": pytest.approx(100e-6),
                    "vcycle:none": pytest.approx(40e-6),
                    "slab:none": pytest.approx(180e-6),
                    "fp64_residual:aten::item": pytest.approx(420e-6)}
    assert sum(gaps.values()) + s["busy_s"] == pytest.approx(s["window_s"])


def test_stacks_nest_by_time():
    cpu = [ev("cpu", "a", 0, 10), ev("cpu", "b", 2, 5), ev("cpu", "c", 5, 9)]
    parent, inner = trace._stacks(cpu, [(3 * US, "p"), (9 * US, "q"),
                                        (11 * US, "r")])
    assert parent == [-1, 0, 0]
    assert inner == {"p": 1, "q": 0, "r": -1}


def test_empty_window_uses_all_events():
    s = trace.summarize([ev("device", "k", 0, 5)], ())
    assert s["busy_s"] == pytest.approx(5e-6)

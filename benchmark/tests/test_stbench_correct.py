"""A whole run on the CPU at a tiny size, past the look for a card: the
program comes out correct, and the control and each fault that the cell
can have come out not correct.

The control is the program's float32 path (no FP64 refinement pass).
The faults, planted under the harness: a solve that returns its state
unchanged; half of the time blocks left out; one answer altered where it
is produced.  (A one-chip cell has no exchange between chips.)"""
import subprocess
import sys

import pytest
import torch

from benchmark import cell, spec
from benchmark.marches import heat
from benchmark.tests.conftest import TINY_CELL


def run(root, **kw):
    return cell.run(TINY_CELL, 2 ** 31 + 7, 0.5, False, device="cpu",
                    root=root, log=lambda s: None, **kw)


def test_program_correct_and_result_shape(tiny_root):
    res, lines = run(tiny_root)
    assert res["correct"] and res["failed"] == 0 and res["attempted"] >= 1
    assert list(res)[-1] == "checks" and len(lines) == len(res["checks"])
    assert set(res["metrics"]) == {"st_dofs_per_s", "slab_s_p90",
                                   "setup_s"}
    for v in res["checks"].values():
        assert v["value"] <= v["limit"] == 1e-8


def test_traced_run(tiny_root, tmp_path):
    res, _ = cell.run(TINY_CELL, 5, 0.1, True, device="cpu", root=tiny_root,
                      out_dir=tmp_path / "out", log=lambda s: None)
    assert res["correct"]
    assert {"vcycles_per_slab", "vcycle_host_ms",
            "hierarchy_build_s"} <= set(res["metrics"])
    # no device operation on the CPU: no device metric, never a zero share
    assert "k4_roofline" not in res["metrics"]
    assert "device_idle_share" not in res["metrics"]
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert list((tmp_path / "out").glob("trace-5.json*"))


def test_control_not_correct(tiny_root):
    res, _ = run(tiny_root, ir_passes=0)
    assert not res["correct"]


@pytest.mark.parametrize("fault", ["unchanged", "half"])
def test_solver_faults_not_correct(tiny_root, monkeypatch, fault):
    solve, probe, broken = heat.richardson_solve, heat.March.probe, []

    def unchanged(A, b, x0, P, **kw):      # returns its start unchanged
        return solve(A, b, x0, P, **(kw if not broken else {"maxiter": 0}))

    def half(A, b, x0, P, **kw):           # the later half of the blocks
        res = solve(A, b, x0, P, **kw)     # left out
        if broken:
            x = res.x.clone()
            x[x.shape[0] // 2:] = 0.0
            res = res._replace(x=x)
        return res

    def probe_then_break(self):            # the timed path only
        out = probe(self)
        broken.append(True)
        return out

    monkeypatch.setattr(heat.March, "probe", probe_then_break)
    monkeypatch.setattr(heat, "richardson_solve",
                        {"unchanged": unchanged, "half": half}[fault])
    res, _ = run(tiny_root)
    assert not res["correct"]


def test_altered_answer_not_correct(tiny_root, monkeypatch):
    slab = heat.March.slab

    def altered(self):
        i, x, ok = slab(self)
        x = x.clone()
        x[1] += 1e-6 * float(x.abs().max())
        return i, x, ok

    monkeypatch.setattr(heat.March, "slab", altered)
    res, _ = run(tiny_root)
    assert not res["correct"]


def test_no_card_no_result():
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload",
         "heat3d-q4dg2-c16-n32.march", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True,
        cwd=str(spec.ROOT), timeout=300)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert out.returncode != 0 and out.stdout.strip() == ""

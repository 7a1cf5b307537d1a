"""tp_01's convergence mode through the config driver
(drivers/tp01.py::run_config and main) on the CPU: the printed
convergence and iteration tables of stfem_tpu_torch against stfem_tpu's
on the same tiny config, and the reference's default run (tf01..tf08
read from STFEM_TESTDIR) on tiny stand-ins for its eight configs.

The tables are compared as printed: the errors to stfem_tpu's 6
significant digits, the rates to 2 decimals, the mean iterations to 4."""
import io
import json
import math

import pytest
import torch

from stfem_tpu.config import Parameters as JParameters
from stfem_tpu.drivers import tp01 as jtp01
from stfem_tpu_torch.config import Parameters
from stfem_tpu_torch.drivers import tp01

torch.set_num_threads(1)

TINY = {"problemType": "heat", "timeType": "DG", "feDegree": 1,
        "nTimestepsAtOnce": 2, "subdivisions": "1,1", "refinement": 1,
        "nRefCycles": 2, "endTime": 0.5, "spaceTimeConvergenceTest": True,
        "relativeTolerance": 1e-12, "spaceTimeMg": True}


@pytest.fixture(autouse=True, scope="module")
def _no_estimate_cache():
    """The port's hierarchies estimate afresh: no estimate disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        yield


def _tables(text):
    """The lines from the first convergence table on."""
    lines = text.splitlines()
    return lines[lines.index("Convergence table k=1"):]


def test_run_config_matches_stfem_tpu(tmp_path, monkeypatch):
    monkeypatch.setenv("STFEM_EIG_CACHE", "0")
    path = tmp_path / "tiny.json"
    path.write_text(json.dumps(TINY))
    out, jout = io.StringIO(), io.StringIO()
    res = tp01.run_config(Parameters.parse(str(path), 2), out=out,
                          device="cpu")
    jtp01.run_config(JParameters.parse(str(path), 2), out=jout)
    lines = _tables(out.getvalue())
    assert lines == _tables(jout.getvalue())
    header = lines[1].split()
    assert header == ["cells", "s-dofs", "t-dofs", "st-dofs", "work",
                      "L∞-L∞", "L2-L2", "L2-H1_semi"]
    rows = [lines[2].split(), lines[3].split()]
    # each error column is followed by its observed rate ("-" first)
    assert rows[0][5:] == [f"{res[(1, 1)].linf_linf:.5e}", "-",
                           f"{res[(1, 1)].l2_l2:.5e}", "-",
                           f"{res[(1, 1)].l2_h1:.5e}", "-"]
    for col, name in ((6, "linf_linf"), (8, "l2_l2"), (10, "l2_h1")):
        a, b = getattr(res[(1, 1)], name), getattr(res[(1, 2)], name)
        assert rows[1][col] == f"{math.log2(a / b):.2f}"
    it = lines.index("Iteration count table")
    assert lines[it + 1].split() == ["k", "\\", "r", "1", "2"]


# tiny stand-ins for the reference's tf01..tf08 (tp_01.cc:818-826)
_DEFAULT_RUN = {"tf01": ("heat", "DG", 1, 2), "tf02": ("heat", "CGP", 2, 2),
                "tf03": ("heat", "DG", 1, 1), "tf04": ("heat", "CGP", 2, 1),
                "tf05": ("wave", "DG", 1, 4), "tf06": ("wave", "CGP", 2, 4),
                "tf07": ("wave", "DG", 1, 1), "tf08": ("wave", "CGP", 2, 1)}


def test_default_run(tmp_path, monkeypatch, capsys):
    for name, (problem, kind, r, n) in _DEFAULT_RUN.items():
        cfg = dict(TINY, problemType=problem, timeType=kind, feDegree=r,
                   nTimestepsAtOnce=n, nRefCycles=1, endTime=0.25)
        (tmp_path / f"{name}.json").write_text(json.dumps(cfg))
    monkeypatch.setenv("STFEM_TESTDIR", str(tmp_path))
    tp01.main(["--file", "default", "--dim", "2", "--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    heads = [ln for ln in lines if ln.isupper() or ln.startswith(
        ("HEAT", "WAVE"))]
    assert heads == ["HEAT 2 steps at once DG", "HEAT single step",
                     "WAVE 4 steps at once", "WAVE single step"]
    assert lines.count("Iteration count table") == 8
    tables = [i for i, ln in enumerate(lines)
              if ln.startswith("Convergence table k=")]
    assert [lines[i] for i in tables] == ["Convergence table k=1",
                                          "Convergence table k=2"] * 4
    for i in tables:       # every table carries the three error columns
        assert lines[i + 1].split()[5:] == ["L∞-L∞", "L2-L2", "L2-H1_semi"]


def test_default_run_needs_testdir(monkeypatch):
    monkeypatch.delenv("STFEM_TESTDIR", raising=False)
    with pytest.raises(SystemExit):
        tp01.main(["--file", "default", "--device", "cpu"])

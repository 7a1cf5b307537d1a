"""The campaign and printing utilities of stfem_tpu_torch (utils/
campaign.py, utils/printing.py: the port's own copies) against
stfem_tpu's: tests/test_aux.py:45-72's campaign cases on the port, each
generated file and script byte for byte stfem_tpu's (with the driver
named the same), the table extraction and its output files equal, and
print_formatted's text equal on the reference's tp_02 style matrices."""
import numpy as np
import pytest

from stfem_tpu.utils import campaign as jcampaign
from stfem_tpu.utils.printing import print_formatted as jprint
from stfem_tpu_torch.utils import campaign
from stfem_tpu_torch.utils.printing import print_formatted

LOG = (":: Number of active cells: 16\n"
       "Average GMRES iterations 8 (32 / 4)\n\n"
       "Convergence table k=1\n"
       "cells s-dofs L2-L2\n16 81 1.78760e-02\n\n"
       "noise\n\n"
       "Iteration count table\n"
       "  k \\ r  2  3\n  1  8.0  8.75\n\n")


def test_campaign_generation(tmp_path):
    """tests/test_aux.py:45-50 on the port, and every file as
    stfem_tpu's."""
    files = campaign.generate_convergence_campaign(str(tmp_path / "t"))
    assert len(files) == 2 * 2 * 3
    assert len(set(files)) == len(files)      # content-hashed, unique
    script = campaign.emit_job_script(files[0], str(tmp_path / "t"))
    assert "python -m stfem_tpu_torch.drivers.tp01" in open(script).read()
    ref = jcampaign.generate_convergence_campaign(str(tmp_path / "j"))
    assert [f.split("/")[-1] for f in files] == [f.split("/")[-1]
                                                 for f in ref]
    for a, b in zip(files, ref):
        assert open(a, "rb").read() == open(b, "rb").read()
    for driver in ("stfem_tpu.drivers.tp01", "stfem_tpu_torch.drivers.tp01"):
        a = campaign.emit_job_script(files[1], str(tmp_path / "s"), dim=2,
                                     driver=driver)
        b = jcampaign.emit_job_script(files[1], str(tmp_path / "s"), dim=2,
                                      driver=driver)
        assert a == b


@pytest.mark.parametrize("dest", [None, "elsewhere"])
def test_campaign_postprocess(tmp_path, dest):
    """tests/test_aux.py:53-72 on the port, against stfem_tpu's output."""
    for root in ("t", "j"):
        (tmp_path / root).mkdir()
        (tmp_path / root / "run1.log").write_text(LOG)
        (tmp_path / root / "run2.log").write_text(LOG.replace("8.75", "9.0"))
    d = None if dest is None else str(tmp_path / "t" / dest)
    res = campaign.postprocess_campaign(str(tmp_path / "t"), d)
    ref = jcampaign.postprocess_campaign(
        str(tmp_path / "j"), None if dest is None else
        str(tmp_path / "j" / dest))
    assert res == ref and "run1" in res
    out = tmp_path / "t" / (dest or "output")
    conv = (out / "run1" / "convergence.txt").read_text()
    assert "1.78760e-02" in conv and "noise" not in conv
    assert "8.75" in (out / "run1" / "iterations.txt").read_text()
    jout = tmp_path / "j" / (dest or "output")
    for f in sorted(out.rglob("*.txt")):
        assert f.read_bytes() == (jout / f.relative_to(out)).read_bytes()
    assert campaign.extract_tables(LOG) == jcampaign.extract_tables(LOG)


@pytest.mark.parametrize("seed", [0, 1])
def test_print_formatted(seed):
    """Reference tests/tp_02.cc:12-30's format, byte for byte stfem_tpu's:
    entries below the threshold blank, negatives and a 1-D row."""
    m = np.random.default_rng(seed).standard_normal((5, 7))
    m[np.abs(m) < 0.5] *= 0.01
    for a in (m, m[0], np.zeros((2, 2)), 100.0 * m):
        assert print_formatted(a) == jprint(a)
    assert print_formatted(m, threshold=0.5) == jprint(m, threshold=0.5)

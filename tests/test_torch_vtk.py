"""tp_01's VTK output of stfem_tpu_torch against stfem_tpu on the CPU.

- utils/vtk.py::write_vtk writes the bytes of stfem_tpu's native writer
  (native/stfem_setup.cc, built here with g++ into the test's directory)
  for a 2D and a 3D field.
- The 2D practical mode with "doOutput" true (2 x 2 subdivisions at
  refinement 1, Q3 x dG(2), 2 steps a slab; stfem_tpu on the native
  writer built here, as above) writes the same files,
  solution_0001.vtk on, in both packages: equal headers and points, the
  values within 1e-8 of their largest.  stfem_tpu's FGMRES leaves
  rounding noise on the Dirichlet dofs, which the port zeroes after each
  slab (the reference's constraints.distribute()); the test zeroes them
  in stfem_tpu's files as well."""
import ctypes
import json
import subprocess
from pathlib import Path

import numpy as np
import pytest
import torch

from stfem_tpu.config import Parameters as JParameters
from stfem_tpu.drivers import tp01 as jtp01
from stfem_tpu.utils import native
from stfem_tpu_torch.config import Parameters
from stfem_tpu_torch.drivers import tp01
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.utils.vtk import write_vtk

torch.set_num_threads(1)
REPO = Path(__file__).resolve().parents[1]


@pytest.fixture
def native_writer(tmp_path, monkeypatch):
    """stfem_tpu's native library, built into tmp_path and loaded as
    stfem_tpu loads it."""
    so = tmp_path / "libstfem_setup.so"
    subprocess.run(["g++", "-O3", "-fPIC", "-std=c++17", "-shared",
                    str(REPO / "native" / "stfem_setup.cc"), "-lpthread",
                    "-o", str(so)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.stfem_write_vtk.argtypes = [
        ctypes.c_char_p, ctypes.POINTER(ctypes.c_int64),
        ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
        ctypes.c_char_p]
    lib.stfem_write_vtk.restype = ctypes.c_int
    monkeypatch.setattr(native, "_LIB", lib)
    monkeypatch.setattr(native, "_TRIED", True)
    return lib


@pytest.mark.parametrize("dim", [2, 3])
def test_write_vtk_bytes(tmp_path, native_writer, dim):
    mesh = StructuredMesh([2] * dim, [0.0] * dim, [1.0, 0.5, 2.0][:dim],
                          refinement=1)
    pts = mesh.dof_coordinates(2)
    vals = np.random.default_rng(dim).standard_normal(pts.shape[:-1])
    native.write_vtk(str(tmp_path / "ref.vtk"), pts, vals)
    write_vtk(str(tmp_path / "got.vtk"), pts, vals)
    ref = (tmp_path / "ref.vtk").read_bytes()
    assert b"BINARY" in ref and b"DIMENSIONS 9 9 " in ref
    assert (tmp_path / "got.vtk").read_bytes() == ref


def _read_vtk(path):
    """(header bytes, points [n, 3], values [n]) of a binary file."""
    data = path.read_bytes()
    head, rest = data.split(b" double\n", 1)
    n = int(head.rsplit(b"POINTS ", 1)[1])
    pts = np.frombuffer(rest[:24 * n], ">f8").reshape(n, 3)
    tail = rest[24 * n:]
    vals = np.frombuffer(tail.split(b"LOOKUP_TABLE default\n", 1)[1][:8 * n],
                         ">f8")
    return head, pts, vals


def test_practical_output(tmp_path, monkeypatch, native_writer):
    """stfem_tpu's files come from its native (binary) writer, built by
    the fixture: without it stfem_tpu falls back to ASCII, and whether
    native/libstfem_setup.so exists depends on which test ran first."""
    cfg = {"problemType": "heat", "timeType": "DG", "feDegree": 2,
           "nTimestepsAtOnce": 2, "subdivisions": "2,2",
           "hyperRectLowerLeft": "0,0", "hyperRectUpperRight": "1,1",
           "refinement": 1, "endTime": 0.5, "spaceTimeConvergenceTest": False,
           "distortCoeff": 0.5, "sourcePoint": "0.5,0.5",
           "relativeTolerance": 1e-12, "spaceTimeMg": True,
           "doOutput": True}
    files = {}
    for who, parse, run in (
            ("jax", JParameters.parse,
             lambda p: jtp01.run_single(p, p.fe_degree, p.refinement)),
            ("torch", Parameters.parse,
             lambda p: tp01.run_single(p, p.fe_degree, p.refinement,
                                       device="cpu"))):
        d = tmp_path / who
        d.mkdir()
        path = d / "cfg.json"
        path.write_text(json.dumps(dict(
            cfg, functionalFile=str(d / "functionals.txt"))))
        p = parse(str(path), 2)
        assert p.do_output
        monkeypatch.chdir(d)
        run(p)
        files[who] = sorted(d.glob("solution_*.vtk"))
    assert [f.name for f in files["torch"]] == \
        [f.name for f in files["jax"]] == ["solution_0001.vtk",
                                           "solution_0002.vtk"]
    mask = StructuredMesh([2, 2], [0.0, 0.0], [1.0, 1.0],
                          refinement=1).boundary_dof_mask(3)
    free = mask.reshape(-1, order="F")
    for fj, ft in zip(files["jax"], files["torch"]):
        (hj, pj, vj), (ht, pt, vt) = _read_vtk(fj), _read_vtk(ft)
        assert ht == hj and np.array_equal(pt, pj)
        assert not np.any(vt[free == 0])
        vj = vj * free
        assert np.abs(vj).max() > 0
        np.testing.assert_allclose(vt, vj, rtol=0,
                                   atol=1e-8 * np.abs(vj).max())

"""The estimate disk cache (stmg/eig_cache.py) on the CPU.

  * hit and miss: a heat hierarchy built twice with one cache file
    computes its estimates once and reads them the second time, with
    bitwise-equal omegas; a changed input (another time step) misses;
  * bypass: a coefficient hierarchy and a distorted one estimate every
    time and store nothing, and estimate_key declines coefficient,
    masked, stepped, mapped and distorted levels;
  * STFEM_EIG_CACHE="0" turns the cache off; a path moves it; the default
    is build/eig_cache.json in the checkout;
  * the file is replaced atomically (a temporary file in its directory,
    then os.replace), and threads that write it at once never leave a
    file that does not parse;
  * the key holds the device type and the Vanka storage dtype."""
import json
import os
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.problems.coefficient import Coefficient
from stfem_tpu_torch.stmg import eig_cache
from stfem_tpu_torch.stmg.eig_cache import (EstimateCache, cache_path,
                                            estimate_key)
from stfem_tpu_torch.stmg.gmg import GMGParams, build_stmg
from stfem_tpu_torch.stmg.smoother import EigInfo
from stfem_tpu_torch.types import TimeStepType

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _build(tau=1 / 16, **kw):
    mesh = kw.pop("mesh", None) or StructuredMesh([2, 2], [0, 0], [1, 1],
                                                  refinement=1)
    return build_stmg(mesh, 1, 2, TimeStepType.DG, 4, tau,
                      GMGParams(smoothing_steps=2), dtype=torch.float32,
                      device="cpu", fe_degree_min=1, **kw)


def _omegas(gmg):
    return [getattr(lvl.smoother, "omega", None) for lvl in gmg.levels]


def test_hit_and_miss(tmp_path, monkeypatch):
    path = tmp_path / "eig.json"
    monkeypatch.setenv("STFEM_EIG_CACHE", str(path))
    first = _build()
    assert first.estimates["computed"] > 0 and first.estimates["read"] == 0
    stored = json.loads(path.read_text())
    assert len(stored) == first.estimates["computed"]
    second = _build()
    assert second.estimates == {"computed": 0,
                                "read": first.estimates["computed"]}
    assert _omegas(second) == _omegas(first)       # bitwise
    other = _build(tau=1 / 8)
    assert other.estimates["read"] == 0 and other.estimates["computed"] > 0
    assert len(json.loads(path.read_text())) == len(stored) + \
        other.estimates["computed"]


@pytest.mark.parametrize("kind", ["coefficient", "distorted"])
def test_bypass(tmp_path, monkeypatch, kind):
    path = tmp_path / "eig.json"
    monkeypatch.setenv("STFEM_EIG_CACHE", str(path))
    kw = (dict(laplace_coefficient=Coefficient([2, 2], [0, 0], [1, 1], 0.5))
          if kind == "coefficient" else
          dict(mesh=StructuredMesh([2, 2], [0, 0], [1, 1], refinement=1,
                                   distort=0.15)))
    for _ in range(2):
        gmg = _build(**kw)
        assert gmg.estimates["read"] == 0 and gmg.estimates["computed"] > 0
    assert not path.exists()


def _key(mesh, device="cpu", storage=None, coefficient=None):
    K = LaplaceMassOperator(mesh, 2, 3, 0.0, 1.0, dtype=torch.float32,
                            device="cpu", coefficient=coefficient)
    A = np.eye(3)
    return estimate_key(K, A, 2 * A, (3,) + K.dof_shape, torch.float32,
                        storage, 1, 20, 1.2, "arnoldi", device)


def test_key_declines_other_levels():
    base = StructuredMesh([2, 2], [0, 0], [1, 1], refinement=1)
    assert isinstance(_key(base), str) and len(_key(base)) == 64
    assert _key(base) == _key(StructuredMesh([2, 2], [0, 0], [1, 1],
                                             refinement=1))
    declined = [
        _key(base, coefficient=Coefficient([2, 2], [0, 0], [1, 1], 0.5)),
        _key(StructuredMesh([2, 2], [0, 0], [1, 1], refinement=1,
                            cell_mask=np.array([[1, 1, 0, 1]] * 4, float))),
        _key(StructuredMesh([2, 2], [0, 0], [1, 1],
                            axis_steps=[[0.25, 0.75], [0.5, 0.5]])),
        _key(StructuredMesh([2, 2], [0, 0], [1, 1], refinement=1,
                            distort=0.15)),
        _key(StructuredMesh([2, 2], [0, 0], [1, 1], refinement=1,
                            vertex_map=lambda p: p * 1.5))]
    assert declined == [None] * 5


def test_key_holds_device_and_storage():
    mesh = StructuredMesh([2, 2], [0, 0], [1, 1], refinement=1)
    keys = {_key(mesh), _key(mesh, device="cuda"),
            _key(mesh, device=torch.device("cuda", 0)),
            _key(mesh, storage=torch.bfloat16)}
    assert len(keys) == 3
    assert _key(mesh, device="cuda") == _key(mesh,
                                             device=torch.device("cuda", 0))


def test_off_path_and_default(tmp_path, monkeypatch):
    assert cache_path({"STFEM_EIG_CACHE": "0"}) is None
    assert cache_path({"STFEM_EIG_CACHE": str(tmp_path / "x.json")}) == \
        str(tmp_path / "x.json")
    assert Path(cache_path({})) == REPO / "build" / "eig_cache.json"
    monkeypatch.setenv("STFEM_EIG_CACHE", "0")
    for _ in range(2):
        gmg = _build()
        assert gmg.estimates["read"] == 0 and gmg.estimates["computed"] > 0


def test_atomic_write(tmp_path, monkeypatch):
    """The file is written whole to a temporary file beside it and moved
    over it; no temporary file is left."""
    path = tmp_path / "sub" / "eig.json"
    moves = []
    real = os.replace

    def replace(src, dst):
        moves.append((Path(src), Path(dst), json.loads(Path(src).read_text())))
        real(src, dst)

    monkeypatch.setattr(eig_cache.os, "replace", replace)
    cache = EstimateCache(str(path))
    info = cache.estimate("k1", lambda: EigInfo(1.5, 2.5))
    assert (info.min_eigenvalue, info.max_eigenvalue) == (1.5, 2.5)
    assert len(moves) == 1
    src, dst, content = moves[0]
    assert dst == path and src.parent == path.parent and src != path
    assert content == {"k1": [1.5, 2.5]}
    assert sorted(p.name for p in path.parent.iterdir()) == ["eig.json"]
    # a hit reads without writing; a failed estimate is not stored
    assert cache.estimate("k1", lambda: pytest.fail("recomputed")) == info
    cache.estimate("k2", lambda: EigInfo(float("nan"), float("nan")))
    assert len(moves) == 1 and (cache.computed, cache.read) == (2, 1)


def test_concurrent_writers_leave_valid_json(tmp_path):
    """8 threads store 25 estimates each into one file while a reader
    parses it: every read parses (entries may be lost to a concurrent
    writer's replace, never torn)."""
    path = str(tmp_path / "eig.json")
    errors, done = [], threading.Event()

    def writer(w):
        cache = EstimateCache(path)
        for i in range(25):
            cache.estimate(f"{w}-{i}", lambda: EigInfo(1.0, 2.0 + i))

    def reader():
        while not done.is_set():
            if os.path.exists(path):
                try:
                    with open(path) as f:
                        assert isinstance(json.load(f), dict)
                except Exception as e:      # record and fail below
                    errors.append(e)

    r = threading.Thread(target=reader)
    ws = [threading.Thread(target=writer, args=(w,)) for w in range(8)]
    r.start()
    for t in ws:
        t.start()
    for t in ws:
        t.join(timeout=60)
    done.set()
    r.join(timeout=60)
    assert not any(t.is_alive() for t in ws + [r])
    assert errors == []
    assert len(json.load(open(path))) >= 25

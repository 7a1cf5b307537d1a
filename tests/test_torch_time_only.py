"""Time-only multigrid (build_stmg(time_only=True), the reference's
transfer_01 scenario) and the space p-ladder floor
(build_stmg(space_degree_min=)) of stfem_tpu_torch against stfem_tpu's
(CPU, numpy seeds).

  * the ladder: the levels' kinds, meshes, space degrees, steps at once
    and time tables equal stfem_tpu's level by level, for the time-only
    ladder (also on a distorted fine mesh, where time_only takes
    precedence), a space_degree_min=2 ladder and both together;
  * tests/test_aux.py::test_time_only_multigrid's configuration (2D,
    refinement 2, DG(1), 4 steps at once, space_or_time, to 1 step and
    DG(1)): stfem_tpu's run once per dtype in a module fixture, under x64.
    With float64 V-cycles in both packages every slab's FGMRES iterations
    equal stfem_tpu's.  With the float32 V-cycles of the test itself
    (stfem_tpu reads 10 and 10) each slab is within one iteration: the
    count there is set by float32 rounding (scripts/time_only_rounding.py:
    the port's FGMRES takes 9 or 10 on the first slab when its V-cycle's
    output carries 6e-8 of relative noise), so it is compared as
    tests/test_torch_tp01_convergence.py compares float32 cycles.
    The error norms within 1e-8 relative of stfem_tpu's either way;
  * the estimate disk cache on a ladder without an h level."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu import integrators as jintegrators
from stfem_tpu.drivers.heat import run_heat_cycle as jrun
from stfem_tpu.drivers.heat import stmg_preconditioner_factory as jfactory
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.stmg.gmg import GMGParams as JGMGParams
from stfem_tpu.stmg.gmg import build_stmg as jbuild
from stfem_tpu.types import CoarseningType as JCoarseningType
from stfem_tpu.types import TimeStepType as JTimeStepType
from stfem_tpu_torch.drivers.heat import (run_heat_cycle,
                                          stmg_preconditioner_factory)
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.stmg.gmg import GMGParams, build_stmg
from stfem_tpu_torch.types import CoarseningType, MGType, TimeStepType

torch.set_num_threads(1)

# tests/test_aux.py::test_time_only_multigrid
AUX = dict(fe_degree_min=1, time_only=True, n_timesteps_at_once_min=1)
NORMS = ("l2_l2", "linf_linf", "l2_h1")


@pytest.fixture(autouse=True, scope="module")
def _no_estimate_cache():
    """The port's hierarchies estimate afresh: no estimate disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        yield


@pytest.fixture(scope="module")
def jax_cycles():
    """stfem_tpu's test_aux cycle with float32 and float64 V-cycles: per
    dtype the per-slab FGMRES iterations and the error norms."""
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        slabs = []
        orig = jintegrators.TimeIntegratorFO.solve

        def solve(self, *args):
            x, stats = orig(self, *args)
            slabs.append(stats.iterations)
            return x, stats

        mp.setattr(jintegrators.TimeIntegratorFO, "solve", solve)
        for name, dtype in (("float32", jnp.float32),
                            ("float64", jnp.float64)):
            slabs.clear()
            res = jrun(refinement=2, fe_degree=1, type_=JTimeStepType.DG,
                       n_timesteps_at_once=4, gmres_maxiter=60,
                       preconditioner_factory=jfactory(
                           dtype=dtype, coarsening_type=JCoarseningType
                           .space_or_time, **AUX))
            out[name] = (list(slabs), {n: getattr(res, n) for n in NORMS},
                         res.avg_iterations)
    return out


@pytest.mark.parametrize("dtype,iters_tol", [("float64", 0),
                                             ("float32", 1)])
def test_time_only_cycle(jax_cycles, dtype, iters_tol):
    jslabs, jnorms, javg = jax_cycles[dtype]
    if dtype == "float32":
        assert javg == 10.0           # stfem_tpu's reading
    res = run_heat_cycle(
        refinement=2, fe_degree=1, type_=TimeStepType.DG,
        n_timesteps_at_once=4, gmres_maxiter=60, device="cpu",
        preconditioner_factory=stmg_preconditioner_factory(
            dtype=getattr(torch, dtype),
            coarsening_type=CoarseningType.space_or_time, **AUX))
    assert len(res.slab_iterations) == len(jslabs) == res.n_timesteps == 2
    assert np.all(np.abs(np.subtract(res.slab_iterations, jslabs))
                  <= iters_tol), (res.slab_iterations, jslabs)
    for name in NORMS:
        assert abs(getattr(res, name) / jnorms[name] - 1.0) <= 1e-8, name
    # tests/test_aux.py's bounds
    assert res.avg_iterations <= 25 and res.l2_l2 < 2e-2


def _ladder(gmg):
    """Per level: (kind of the transfer below it, mesh cells, space
    degree, steps-blocks, Alpha, Beta)."""
    kinds = [None] + [t.name for t in gmg.mg_type_level]
    return [(kind, tuple(lvl.matrix.K.cells), lvl.matrix.K.degree,
             lvl.n_blocks, np.asarray(lvl.matrix.Alpha, np.float64),
             np.asarray(lvl.matrix.Beta, np.float64))
            for kind, lvl in zip(kinds, gmg.levels)]


@pytest.mark.parametrize("dim,refinement,space_degree,kw,distort", [
    (2, 1, 4, dict(space_degree_min=2), 0.0),
    (3, 1, 4, dict(time_only=True, space_degree_min=2), 0.0),
    (2, 2, 2, dict(time_only=True), 0.15)])
def test_ladder(dim, refinement, space_degree, kw, distort):
    args = ([1] * dim, [0.0] * dim, [1.0] * dim)
    mkw = dict(refinement=refinement, distort=distort)
    j = jbuild(JMesh(*args, **mkw), 1, space_degree, JTimeStepType.DG, 4,
               0.125, params=JGMGParams(relaxation=1.0), dtype=jnp.float64,
               fe_degree_min=0, n_timesteps_at_once_min=1,
               coarsening_type=JCoarseningType.space_or_time, **kw)
    t = build_stmg(StructuredMesh(*args, **mkw), 1, space_degree,
                   TimeStepType.DG, 4, 0.125, GMGParams(relaxation=1.0),
                   dtype=torch.float64, device="cpu", fe_degree_min=0,
                   n_timesteps_at_once_min=1,
                   coarsening_type=CoarseningType.space_or_time, **kw)
    assert [m.name for m in t.mg_type_level] == \
        [m.name for m in j.mg_type_level]
    jl, tl = _ladder(j), _ladder(t)
    assert len(tl) == len(jl)
    for a, b in zip(tl, jl):
        assert a[:4] == b[:4], (a[:4], b[:4])
        np.testing.assert_array_equal(a[4], b[4])
        np.testing.assert_array_equal(a[5], b[5])
    degrees = [lvl[2] for lvl in tl]
    assert min(degrees) == kw.get("space_degree_min", 1)
    if kw.get("time_only"):
        assert MGType.h not in t.mg_type_level
        assert {lvl[1] for lvl in tl} == {t.levels[-1].matrix.K.cells}
        assert all(lvl.matrix.K.mesh is t.levels[-1].matrix.K.mesh
                   for lvl in t.levels)
        # the coarse solve is the coarsest level's smoother: the Vanka of
        # the fine mesh
        assert t.coarse == "Smoother"
        assert t.levels[0].smoother.precond.mode == \
            ("cell" if distort else "grid")


def test_time_only_estimate_cache(tmp_path, monkeypatch):
    """A ladder without an h level estimates once and reads its estimates
    back, with bitwise-equal omegas."""
    monkeypatch.setenv("STFEM_EIG_CACHE", str(tmp_path / "eig.json"))

    def build():
        return build_stmg(StructuredMesh([1, 1], [0, 0], [1, 1],
                                         refinement=2), 1, 2,
                          TimeStepType.DG, 4, 0.125, device="cpu",
                          coarsening_type=CoarseningType.space_or_time,
                          **AUX)

    first, second = build(), build()
    assert first.estimates["computed"] == len(first.levels) > 0
    assert second.estimates == {"computed": 0,
                                "read": first.estimates["computed"]}
    assert [lvl.smoother.omega for lvl in first.levels] == \
        [lvl.smoother.omega for lvl in second.levels]

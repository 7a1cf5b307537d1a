"""tp_01's convergence mode, heat: stfem_tpu_torch's run_heat_cycle against
stfem_tpu's on the CPU with each package's STMG factory at GMGParams'
defaults and fe_degree_min 1.  `both` and `check` serve the wave file
too; stfem_tpu's per-slab FGMRES iterations are recorded by wrapping its
integrators' slab solves.

Tolerances: the errors within 1e-8 relative of stfem_tpu's (both solve
each slab to FGMRES's rel 1e-12 with float32 V-cycles built separately)
and within 2e-5 of the reference goldens where the repository carries
them (tests/test_heat_endtoend.py:12-15, :55-57); the FGMRES iterations
of every slab within +-1 of stfem_tpu's."""
import numpy as np
import pytest
import torch

from stfem_tpu import integrators as jintegrators
from stfem_tpu.drivers.heat import run_heat_cycle as jrun
from stfem_tpu.drivers.heat import stmg_preconditioner_factory as jfactory
from stfem_tpu.stmg.gmg import GMGParams as JGMGParams
from stfem_tpu.types import ProblemType as JProblemType
from stfem_tpu.types import TimeStepType as JTimeStepType
from stfem_tpu_torch.drivers.heat import run_heat_cycle
from stfem_tpu_torch.drivers.heat import stmg_preconditioner_factory
from stfem_tpu_torch.stmg.gmg import GMGParams
from stfem_tpu_torch.types import ProblemType, TimeStepType
from stfem_tpu_torch.utils.carry import load_gmg

torch.set_num_threads(1)

# reference tests/tp_01.output (linf, l2, h1): heat DG(1) and CGP(2),
# 2 steps at once, refinement 2
GOLDEN_DG1_REF2 = (5.53197e-02, 1.78760e-02, 1.35366e-01)
GOLDEN_CGP2_REF2 = (4.36348e-03, 1.57444e-03, 1.16973e-02)


@pytest.fixture(autouse=True, scope="module")
def _no_estimate_cache():
    """The port's hierarchies estimate afresh: no estimate disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        yield


def both(kind: str, r: int, problem: str, n_at_once: int, refinement: int,
         dim: int = 2, skip_identity: bool = False,
         carry_omegas: bool = False):
    """(stfem_tpu's result and per-slab iterations, the port's result);
    carry_omegas: the port's V-cycle takes stfem_tpu's Relaxation omegas
    instead of estimating its own."""
    geo = dict(subdivisions=(1,) * dim, lower=(0.0,) * dim,
               upper=(1.0,) * dim)
    slabs, omegas = [], []
    jbase = jfactory(params=JGMGParams(skip_identity_levels=skip_identity),
                     fe_degree_min=1)

    def jfac(ctx):
        gmg = jbase(ctx)
        omegas.extend(getattr(lvl.smoother, "omega", None)
                      for lvl in gmg.levels)
        return gmg

    tbase = stmg_preconditioner_factory(
        params=GMGParams(skip_identity_levels=skip_identity),
        fe_degree_min=1)

    def tfac(ctx):
        gmg = tbase(ctx)
        if carry_omegas:
            load_gmg(gmg, omegas)
        return gmg

    orig_fo = jintegrators.TimeIntegratorFO.solve
    orig_wave = jintegrators.TimeIntegratorWave.solve_wave

    def solve(self, *args):
        x, stats = orig_fo(self, *args)
        slabs.append(stats.iterations)
        return x, stats

    def solve_wave(self, *args):
        u, v, stats = orig_wave(self, *args)
        slabs.append(stats.iterations)
        return u, v, stats

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        mp.setattr(jintegrators.TimeIntegratorFO, "solve", solve)
        mp.setattr(jintegrators.TimeIntegratorWave, "solve_wave", solve_wave)
        jres = jrun(refinement=refinement, fe_degree=r,
                    type_=getattr(JTimeStepType, kind),
                    problem=getattr(JProblemType, problem),
                    n_timesteps_at_once=n_at_once, gmres_maxiter=100,
                    preconditioner_factory=jfac, **geo)
    tres = run_heat_cycle(refinement=refinement, fe_degree=r,
                          type_=getattr(TimeStepType, kind),
                          problem=getattr(ProblemType, problem),
                          n_timesteps_at_once=n_at_once, gmres_maxiter=100,
                          preconditioner_factory=tfac, device="cpu", **geo)
    return jres, slabs, tres


def check(jres, jslabs, tres, iters_tol: int | None, golden=None):
    """Errors within 1e-8 relative of stfem_tpu's and, where given, within
    2e-5 of the golden (linf, l2, h1); per-slab iterations within
    iters_tol of stfem_tpu's (None: not compared)."""
    for name in ("linf_linf", "l2_l2", "l2_h1"):
        a, b = getattr(tres, name), getattr(jres, name)
        assert abs(a / b - 1.0) <= 1e-8, (name, a, b)
    for g, name in zip(golden or (), ("linf_linf", "l2_l2", "l2_h1")):
        if g is not None:
            assert getattr(tres, name) == pytest.approx(g, rel=2e-5), name
    assert len(jslabs) == len(tres.slab_iterations) == tres.n_timesteps
    assert tres.total_iterations == sum(tres.slab_iterations)
    if iters_tol is None:
        return
    assert np.all(np.abs(np.subtract(jslabs, tres.slab_iterations))
                  <= iters_tol), (jslabs, tres.slab_iterations)


@pytest.mark.parametrize("kind,r,dim,golden", [
    ("DG", 1, 2, GOLDEN_DG1_REF2), ("CGP", 2, 2, GOLDEN_CGP2_REF2),
    ("DG", 1, 3, None)])
def test_heat_cycle(kind, r, dim, golden):
    ref = 2 if dim == 2 else 1
    jres, jslabs, tres = both(kind, r, "heat", 2, ref, dim=dim)
    check(jres, jslabs, tres, 1, golden)

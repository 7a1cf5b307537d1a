"""The tp_01 practical mode of stfem_tpu_torch vs stfem_tpu on the CPU: the
3D configuration (configs/tp01_practical_3d.json: Q3 x dG(2), distorted
coefficient, C-infinity bump at the centre) reduced to 2x2x2
subdivisions, refinement 1 (4^3 cells), 2 steps per slab and end time
0.25 (2 slabs); both packages parse the same JSON file.

- Hierarchy: the ladder, level shapes, smoother kinds and Vanka modes are
  stfem_tpu's; each package's own ARPACK omegas agree to 1e-4 (ARPACK's
  resolution of the non-normal P A, which the two Vanka builds perturb at
  ~1e-6); one V-cycle with stfem_tpu's omegas and Vanka factors carried
  across agrees within 1e-5 (float32 levels).
- The whole slice through run_single: the per-slab FGMRES iterations
  within +-1, the last time block within 1e-8 relative, and the probe
  values and functionals-file rows within 1e-8 of the largest.
  stfem_tpu's FGMRES leaves rounding noise (~1e-7 of the field's size)
  on the Dirichlet dofs, which the operator never reads and its probes on
  boundary cells do; the port zeroes those dofs after each slab, as the
  reference's constraints.distribute() does, and the test zeroes them in
  stfem_tpu's slab solutions the same way."""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu import integrators as jintegrators
from stfem_tpu.config import Parameters as JParameters
from stfem_tpu.drivers import tp01 as jtp01
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.problems.coefficient import Coefficient as JCoefficient
from stfem_tpu.stmg.gmg import build_stmg as jbuild
from stfem_tpu.utils.probes import PointEvaluator as JPointEvaluator
from stfem_tpu_torch.config import Parameters
from stfem_tpu_torch.drivers import tp01
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.problems.coefficient import Coefficient
from stfem_tpu_torch.stmg.gmg import build_stmg
from stfem_tpu_torch.utils.carry import load_gmg, load_vanka_cell
from stfem_tpu_torch.utils.probes import PointEvaluator

torch.set_num_threads(1)

REDUCED = {"subdivisions": "2,2,2", "refinement": 1, "nTimestepsAtOnce": 2,
           "endTime": 0.25}


@pytest.fixture(autouse=True, scope="module")
def _no_estimate_cache():
    """The port's hierarchies estimate afresh: no estimate disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        yield


def _config(tmp_path, name):
    with open(tp01.PRACTICAL_3D) as f:
        cfg = json.load(f)
    cfg.update(REDUCED, functionalFile=str(tmp_path / f"func_{name}.txt"))
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps(cfg))
    return path


def test_config_parse(tmp_path):
    """The committed configuration parses to the same parameters in both
    packages, with the derived defaults (n_timesteps_at_once_min 4,
    fe_degree_min 1, the inverted time_before_space)."""
    jp = JParameters.parse(str(tp01.PRACTICAL_3D), 3)
    tp = Parameters.parse(str(tp01.PRACTICAL_3D), 3)
    for name in ("type", "problem", "coarsening_type", "poly_coarsening"):
        assert getattr(tp, name).name == getattr(jp, name).name
    for name in ("fe_degree", "fe_degree_min", "n_timesteps_at_once",
                 "n_timesteps_at_once_min", "subdivisions", "refinement",
                 "time_before_space", "space_time_level_first", "use_pmg",
                 "space_time_conv_test", "distort_coeff", "source",
                 "rel_tol", "extrapolate", "end_time"):
        assert getattr(tp, name) == getattr(jp, name), name
    for name in ("smoothing_range", "smoothing_steps", "relaxation",
                 "coarse_grid_smoother_type", "variable",
                 "skip_identity_levels", "smoothing_eig_cg_n_iterations",
                 "eig_safety_factor", "eig_exact", "level_bf16",
                 "eig_proxy_cells"):
        assert getattr(tp.mg_data, name) == getattr(jp.mg_data, name), name
    assert (tp.n_timesteps_at_once_min, tp.fe_degree_min) == (4, 1)
    assert tp.time_before_space


@pytest.fixture(scope="module")
def hierarchies(tmp_path_factory):
    path = _config(tmp_path_factory.mktemp("h"), "h")
    jp, tp = JParameters.parse(str(path), 3), Parameters.parse(str(path), 3)
    sub, lo, hi = tp.subdivisions, tp.hyperrect_lower_left, \
        tp.hyperrect_upper_right
    args = (2, 3, None, 2, 1.0 / 16)
    kw = dict(time_before_space=tp.time_before_space,
              space_time_level_first=tp.space_time_level_first,
              use_pmg=tp.use_pmg, fe_degree_min=1)
    jg = jbuild(JMesh(sub, lo, hi, refinement=1), *args[:2], jp.type,
                *args[3:], params=jp.mg_data, dtype=jnp.float32,
                coarsening_type=jp.coarsening_type,
                laplace_coefficient=JCoefficient(sub, lo, hi, 0.5), **kw)
    tg = build_stmg(StructuredMesh(sub, lo, hi, refinement=1), *args[:2],
                    tp.type, *args[3:], params=tp.mg_data,
                    dtype=torch.float32, device="cpu",
                    coarsening_type=tp.coarsening_type,
                    laplace_coefficient=Coefficient(sub, lo, hi, 0.5), **kw)
    return jg, tg


def test_ladder(hierarchies):
    jg, tg = hierarchies
    assert [m.name for m in tg.mg_type_level] == \
        [m.name for m in jg.mg_type_level] == ["tau", "k", "h"]
    assert [s.name for s in tg.precondition_sequence] == \
        [s.name for s in jg.precondition_sequence]
    assert tg.coarse == "Smoother" and tg.variable and not tg.skip_identity
    for jl, tl in zip(jg.levels, tg.levels, strict=True):
        assert (tl.n_blocks, tuple(tl.dof_shape)) == \
            (jl.n_blocks, tuple(jl.dof_shape))
        assert type(tl.smoother).__name__ == type(jl.smoother).__name__ \
            == "RelaxationSmoother"
        assert tl.smoother.precond.mode == "cell"
        assert jl.smoother.precond.Wdn is None
        assert tl.matrix.route == "grid" and jl.matrix._grid is not None


def test_arnoldi_omegas(hierarchies):
    jg, tg = hierarchies
    for jl, tl in zip(jg.levels, tg.levels):
        assert abs(tl.smoother.omega / jl.smoother.omega - 1.0) <= 1e-4, \
            (jl.smoother.omega, tl.smoother.omega)


def test_vcycle_carried(hierarchies):
    jg, tg = hierarchies
    f32 = lambda a: None if a is None else np.asarray(a, np.float32)
    for jl, tl in zip(jg.levels, tg.levels):
        jv = jl.smoother.precond
        load_vanka_cell(tl.smoother.precond, V=f32(jv.V), Ginv=f32(jv.Ginv),
                        cvec=f32(jv.cvec), TTinv=f32(jv.TTinv),
                        dinv=f32(jv.dinv))
    load_gmg(tg, [lvl.smoother.omega for lvl in jg.levels])
    lvl = tg.levels[-1]
    mask = lvl.matrix.K.mask_np
    b = (np.random.default_rng(0).standard_normal(
        (lvl.n_blocks,) + tuple(lvl.dof_shape)) * mask).astype(np.float32)
    ref = np.asarray(jax.jit(jg.vmult)(jnp.asarray(b)), np.float64)
    got = tg.vmult(torch.as_tensor(b)).double().numpy()
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) <= 1e-5


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Both packages' run_single on the reduced configuration; stfem_tpu's
    slab solves are recorded (with the Dirichlet dofs zeroed)."""
    tmp = tmp_path_factory.mktemp("run")
    jp = JParameters.parse(str(_config(tmp, "jax")), 3)
    tp = Parameters.parse(str(_config(tmp, "torch")), 3)
    slabs = []
    orig = jintegrators.TimeIntegratorFO.solve

    def solve(self, *args):
        x, stats = orig(self, *args)
        x = x * self.matrix.K.mask
        slabs.append((stats.iterations, np.asarray(x[-1])))
        return x, stats

    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        mp.setattr(jintegrators.TimeIntegratorFO, "solve", solve)
        jtp01.run_single(jp, jp.fe_degree, jp.refinement)
    res = tp01.run_single(tp, tp.fe_degree, tp.refinement, device="cpu")
    return slabs, res, jp, tp


def test_fgmres_iterations(runs):
    slabs, res, _, _ = runs
    assert len(slabs) == len(res.slab_iterations) == 2
    for (ji, _), ti in zip(slabs, res.slab_iterations):
        assert abs(ji - ti) <= 1, ([s[0] for s in slabs],
                                   res.slab_iterations)


def test_solution(runs):
    slabs, res, _, _ = runs
    xj, xt = slabs[-1][1], res.solution.numpy()
    assert np.linalg.norm(xt - xj) / np.linalg.norm(xj) <= 1e-8


def test_probes_and_functionals(runs):
    slabs, res, jp, tp = runs
    points = tp01.PROBES[3]
    jm = JMesh(jp.subdivisions, jp.hyperrect_lower_left,
               jp.hyperrect_upper_right, refinement=jp.refinement)
    tm = StructuredMesh(tp.subdivisions, tp.hyperrect_lower_left,
                        tp.hyperrect_upper_right, refinement=tp.refinement)
    vj = JPointEvaluator(jm, 3, points)(slabs[-1][1])
    vt = PointEvaluator(tm, 3, points)(res.solution)
    assert np.abs(vt - vj).max() <= 1e-8 * np.abs(vj).max()
    fj, ft = np.loadtxt(jp.functional_file), np.loadtxt(tp.functional_file)
    assert fj.shape == ft.shape == (2 * 2 * 9, 4)
    assert np.abs(ft - fj).max() <= 1e-8 * np.abs(fj).max()


def test_device_arnoldi_engine(hierarchies):
    """The device Krylov-Schur engine (levels above ARPACK_HOST_MAX_N
    unknowns) against ARPACK on every level of the port's hierarchy, on
    the same apply and start vector: the same criterion (residual <= 1e-5
    |theta|) lands within 2e-4 on these clustered complex spectra (both
    sit within ~1e-3 of the converged lambda_max)."""
    from stfem_tpu_torch.stmg import smoother as tsm

    _, tg = hierarchies
    for lvl in tg.levels:
        shape = (lvl.n_blocks,) + tuple(lvl.dof_shape)
        apply = tsm.pa_apply(lvl.matrix, lvl.smoother.precond, shape)
        v0 = tsm.start_vector(shape, lvl.matrix.K.mask_np)
        lam = [tsm.arpack_lambda_max(apply, v0, "cpu"),
               tsm.krylov_schur_lambda_max(apply, torch.as_tensor(v0))]
        assert abs(lam[1] / lam[0] - 1.0) <= 2e-4, lam


@pytest.mark.parametrize("complex_top", [False, True])
def test_krylov_schur_known_spectrum(complex_top):
    """A non-normal matrix with a known spectrum: the dominant |eigenvalue|
    (a real one, or a complex pair) to 1e-9 at a tight tolerance."""
    from stfem_tpu_torch.stmg.smoother import krylov_schur_lambda_max

    rng = np.random.default_rng(5)
    n = 300
    lam = np.linspace(0.1, 1.0, n)
    D = np.diag(lam)
    if complex_top:                       # a 2x2 rotation block of |1.2|
        D[-2:, -2:] = [[0.0, 1.2], [-1.2, 0.0]]
    X = np.eye(n) + 0.3 * rng.standard_normal((n, n)) / np.sqrt(n)
    Amat = torch.as_tensor(X @ D @ np.linalg.inv(X))
    got = krylov_schur_lambda_max(lambda v: Amat @ v,
                                  torch.as_tensor(rng.standard_normal(n)),
                                  tol=1e-12, max_matvecs=20000)
    assert abs(got - (1.2 if complex_top else 1.0)) <= 1e-9

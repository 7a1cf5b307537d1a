"""The GMGParams solver options of stfem_tpu_torch against stfem_tpu on
the CPU: the config keys, the heat hierarchy with the Chebyshev smoother
and each coarse solve, the other V-cycle options, and tp_01's config
driver with the Chebyshev keys (test_torch_tp01_chebyshev.py).

The hierarchy is stfem_tpu's test_direct_coarse_solver setup
(tests/test_stmg.py:145-180: 2 x 2 cells at refinement 2, Q2, dG(1), 4
steps at once, tau 1/16, fe_degree_min 1, float32 levels, 2 smoothing
steps, no `variable`), each package building its own.  Tolerances: the
precondition sequence equal; each level's Chebyshev (theta, delta)
within 1e-5 relative (both estimate with ARPACK on float32 sweeps); one
V-cycle on a seeded vector within 1e-5 relative with stfem_tpu's theta
and delta (and Direct inverse) carried across, the level factors being
each package's own; FGMRES iterations (FP64 operator, rel 1e-8) within 1.
The option cases fix omega (relaxation 0.6), so only Chebyshev levels
estimate (their (theta, delta) carried across as above), and also check
that the option changes the port's V-cycle."""
import copy
import dataclasses
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.config import Parameters as JParameters
from stfem_tpu.krylov import fgmres as jfgmres
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.stmg.gmg import GMG as JGMG
from stfem_tpu.stmg.gmg import GMGParams as JParams
from stfem_tpu.stmg.gmg import build_stmg as jbuild
from stfem_tpu.system import SystemMatrix as JSys
from stfem_tpu.time.tables import get_fe_time_weights
from stfem_tpu.types import SupportedSmoothers as JSmoothers
from stfem_tpu.types import TimeStepType as JT
from stfem_tpu_torch.config import Parameters
from stfem_tpu_torch.krylov import fgmres
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.stmg.gmg import GMG, GMGParams, build_stmg
from stfem_tpu_torch.system import SystemMatrix
from stfem_tpu_torch.types import SupportedSmoothers, TimeStepType
from stfem_tpu_torch.utils.carry import load_gmg

torch.set_num_threads(1)

TAU = 1 / 16
CHEB_KEYS = {"smoother": "chebyshev", "smoothingSteps": 2,
             "smoothingRange": 5.0, "coarseGridSmootherType": "GMRES"}


@pytest.fixture(autouse=True, scope="module")
def _no_estimate_memo():
    """No repo-local estimate memo for stfem_tpu's builds."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        yield


def _build(**kw):
    """(stfem_tpu's hierarchy, the port's) with the same GMGParams
    fields; a `smoother` is given by name."""
    jkw, tkw = dict(kw), dict(kw)
    if "smoother" in kw:
        jkw["smoother"] = JSmoothers[kw["smoother"]]
        tkw["smoother"] = SupportedSmoothers[kw["smoother"]]
    jm = JMesh([2, 2], [0, 0], [1, 1], refinement=2)
    tm = StructuredMesh([2, 2], [0, 0], [1, 1], refinement=2)
    jg = jbuild(jm, 1, 2, JT.DG, 4, TAU, dtype=jnp.float32, fe_degree_min=1,
                params=JParams(**jkw))
    tg = build_stmg(tm, 1, 2, TimeStepType.DG, 4, TAU, GMGParams(**tkw),
                    dtype=torch.float32, device="cpu", fe_degree_min=1)
    return jg, tg


@pytest.fixture(scope="module")
def system():
    """The FP64 slab operators of both packages and a seeded rhs."""
    jm = JMesh([2, 2], [0, 0], [1, 1], refinement=2)
    tm = StructuredMesh([2, 2], [0, 0], [1, 1], refinement=2)
    a, b, _, _ = get_fe_time_weights(JT.DG, 1, TAU, 4)
    jK, jM = (JOp(jm, 2, 3, m, l, dtype=jnp.float64)
              for m, l in ((0.0, 1.0), (1.0, 0.0)))
    tK, tM = (LaplaceMassOperator(tm, 2, 3, m, l, dtype=torch.float64,
                                  device="cpu")
              for m, l in ((0.0, 1.0), (1.0, 0.0)))
    jmat, tmat = JSys(jK, jM, a, b), SystemMatrix(tK, tM, a, b)
    x = np.random.default_rng(0).standard_normal((8,) + jK.dof_shape)
    rhs = np.array(jmat.vmult(jnp.asarray(x * jK.mask_np)))
    return jmat, tmat, rhs


def _vcycle_rel(jg, tg, rhs):
    ref = np.asarray(jg.vmult(jnp.asarray(rhs, jnp.float32)), np.float64)
    got = tg.vmult(torch.as_tensor(rhs, dtype=torch.float32)).double()
    return float(np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref))


def _chebyshev(gmg):
    return [(lvl.smoother.theta, lvl.smoother.delta)
            if hasattr(lvl.smoother, "theta") else None
            for lvl in gmg.levels]


def test_config_keys(tmp_path):
    """Every GMGParams key of stfem_tpu's parser (config.py:119-135) fills
    the same field with the same value in both packages."""
    keys = {"smoother": "chebyshev", "smoothingDegree": 3,
            "smoothingSteps": 2, "smoothingRange": 5.0, "relaxation": 0.7,
            "coarseGridSmootherType": "GMRES", "coarseGridMaxiter": 7,
            "coarseGridAbstol": 1e-14, "coarseGridReltol": 1e-3,
            "restrictIsTransposeProlongate": False, "variable": False}
    path = tmp_path / "mg.json"
    path.write_text(json.dumps(keys))
    jp, tp = JParameters.parse(str(path), 2), Parameters.parse(str(path), 2)
    fields = ("smoother", "smoothing_degree", "smoothing_steps",
              "smoothing_range", "relaxation", "coarse_grid_smoother_type",
              "coarse_grid_maxiter", "coarse_grid_abstol",
              "coarse_grid_reltol", "restrict_is_transpose_prolongate",
              "variable")
    for f in fields:
        j, t = getattr(jp.mg_data, f), getattr(tp.mg_data, f)
        if f == "smoother":
            j, t = j.name, t.name
        assert j == t, f
    assert tp.mg_data.smoother == SupportedSmoothers.Chebyshev
    # the defaults of every field the two GMGParams share
    shared = set(JParams.__dataclass_fields__) & set(
        GMGParams.__dataclass_fields__)
    assert {"smoother", "smoothing_degree", "coarse_grid_maxiter",
            "coarse_grid_abstol", "coarse_grid_reltol",
            "restrict_is_transpose_prolongate"} <= shared
    for f in shared:
        j, t = getattr(JParams(), f), getattr(GMGParams(), f)
        assert (j.name == t.name) if f == "smoother" else j == t, f
    for value in ("identity", "relaxation"):
        path.write_text(json.dumps({"smoother": value}))
        assert Parameters.parse(str(path), 2).mg_data.smoother.name == \
            JParameters.parse(str(path), 2).mg_data.smoother.name


@pytest.fixture(scope="module")
def chebyshev():
    """Both packages' Chebyshev hierarchies, built with the GMRES coarse
    solve (level 0 smoothed: it preconditions the GMRES)."""
    return _build(smoothing_steps=2, variable=False, smoother="Chebyshev",
                  coarse_grid_smoother_type="GMRES")


def _with_coarse(jg, tg, coarse):
    """GMGs on the same levels with another coarse solve."""
    if coarse == "GMRES":
        return jg, tg
    jgc = JGMG(jg.levels, jg.transfers, dataclasses.replace(
        jg.params, coarse_grid_smoother_type=coarse), jg.dtype,
        jg.precondition_sequence)
    tgc = GMG(tg.levels, tg.transfers, tg.dtype, tg.precondition_sequence,
              coarse=coarse, variable=False, skip_identity=False,
              smoothing_steps=2, coarse_maxiter=10)
    return jgc, tgc


@pytest.mark.parametrize("coarse", ["Smoother", "GMRES", "Direct"])
def test_chebyshev_hierarchy(system, chebyshev, coarse):
    jmat, tmat, rhs = system
    jg, tg = _with_coarse(*chebyshev, coarse)
    assert [s.name for s in tg.precondition_sequence] == \
        [s.name for s in jg.precondition_sequence]
    assert tg.coarse == coarse and tg.coarse_maxiter == 10
    jc, tc = _chebyshev(jg), _chebyshev(tg)
    assert sum(c is not None for c in tc) >= 4
    for j, t, lvl in zip(jc, tc, tg.levels):
        assert (j is None) == (t is None)
        if t is not None:
            assert t[0] == pytest.approx(j[0], rel=1e-5)
            assert t[1] == pytest.approx(j[1], rel=1e-5)
            assert lvl.smoother.degree == 2
    # FGMRES with each package's own hierarchy
    jres = jfgmres(jmat.vmult, jnp.asarray(rhs), jnp.zeros_like(rhs),
                   precondition=jg.vmult, maxiter=40, abstol=1e-30,
                   reltol=1e-8)
    tres = fgmres(tmat.vmult, torch.as_tensor(rhs),
                  torch.zeros(rhs.shape, dtype=torch.float64), tg.vmult,
                  maxiter=40, reltol=1e-8, abstol=1e-30)
    assert bool(jres.converged) and tres.converged
    assert abs(int(jres.iterations) - tres.iterations) <= 1
    # one V-cycle with stfem_tpu's parameters carried across (on copies
    # of the smoothers: the levels are shared between the cases)
    for lvl, c in zip(tg.levels, jc):
        if c is not None:
            lvl.smoother = copy.copy(lvl.smoother)
            lvl.smoother.theta, lvl.smoother.delta = c
    if coarse == "Direct":
        load_gmg(tg, coarse_Ainv=np.asarray(jg.coarse_Ainv))
    assert _vcycle_rel(jg, tg, rhs) <= 1e-5


def test_direct_level0_unsmoothed():
    """build_stmg gives a directly solved level 0 no smoother; the GMRES
    and Smoother coarse solves get one (stfem_tpu builds it always)."""
    tm = StructuredMesh([2, 2], [0, 0], [1, 1], refinement=2)
    kinds = {}
    for coarse in ("Direct", "GMRES"):
        tg = build_stmg(tm, 1, 2, TimeStepType.DG, 4, TAU,
                        GMGParams(relaxation=0.6,
                                  coarse_grid_smoother_type=coarse),
                        device="cpu", fe_degree_min=1)
        kinds[coarse] = type(tg.levels[0].smoother).__name__
    assert kinds == {"Direct": "IdentitySmoother",
                     "GMRES": "RelaxationSmoother"}


OPTIONS = {"identity": dict(smoother="Identity"),
           "identity_gmres": dict(smoother="Identity",
                                  coarse_grid_smoother_type="GMRES"),
           "chebyshev_range1": dict(smoother="Chebyshev"),
           "chebyshev_fixed_relaxation": dict(smoother="Chebyshev",
                                              smoothing_range=5.0),
           "chebyshev_degree3": dict(smoother="Chebyshev",
                                     smoother_inner_iterations=3),
           "chebyshev_not_variable": dict(smoother="Chebyshev",
                                          variable=False),
           "interpolated_restriction": dict(
               restrict_is_transpose_prolongate=False)}


@pytest.fixture(scope="module")
def base_vcycle(system):
    """The port's V-cycle without an option, for the cases to differ
    from."""
    _, tg = _build(smoothing_steps=2, relaxation=0.6)
    return tg.vmult(torch.as_tensor(system[2], dtype=torch.float32))


@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_vcycle_option(system, base_vcycle, option):
    rhs = system[2]
    jg, tg = _build(**dict(dict(smoothing_steps=2, relaxation=0.6),
                           **OPTIONS[option]))
    assert [s.name for s in tg.precondition_sequence] == \
        [s.name for s in jg.precondition_sequence]
    assert tg.variable == jg.params.variable
    assert (tg.coarse, tg.coarse_maxiter) == (
        jg.params.coarse_grid_smoother_type, jg.params.coarse_grid_maxiter)
    for jl, tl in zip(jg.levels, tg.levels):
        assert type(tl.smoother).__name__ == type(jl.smoother).__name__
        if hasattr(tl.smoother, "theta"):   # estimated despite relaxation
            assert tl.smoother.degree == jl.smoother.degree
            assert tl.smoother.theta == pytest.approx(jl.smoother.theta,
                                                      rel=1e-5)
            assert tl.smoother.delta == pytest.approx(jl.smoother.delta,
                                                      rel=1e-5)
            tl.smoother.theta = jl.smoother.theta
            tl.smoother.delta = jl.smoother.delta
    assert _vcycle_rel(jg, tg, rhs) <= 1e-5
    got = tg.vmult(torch.as_tensor(rhs, dtype=torch.float32))
    assert float((got - base_vcycle).norm() / base_vcycle.norm()) > 1e-4


@pytest.mark.parametrize("kind", ["DG", "CGP"])
@pytest.mark.parametrize("mgt", ["k", "tau"])
@pytest.mark.parametrize("transpose", [True, False])
def test_time_transfer_restriction(kind, mgt, transpose):
    """TimeTransfer's restriction (the transposed prolongation or the
    interpolation down) against stfem_tpu's, FP64: 1e-13 relative."""
    from stfem_tpu.stmg.transfers import TimeTransfer as JTransfer
    from stfem_tpu.types import MGType as JMG
    from stfem_tpu_torch.stmg.transfers import TimeTransfer
    from stfem_tpu_torch.types import MGType

    dg = kind == "DG"
    r_hi, r_lo = (2, 1) if mgt == "k" else (2, 2)
    n_hi, n_lo = (r_hi + 1, r_lo + 1) if dg else (r_hi, r_lo)
    jt = JTransfer(JT[kind], JMG[mgt], n_hi, n_lo, 4, transpose,
                   dtype=jnp.float64)
    tt = TimeTransfer(TimeStepType[kind], MGType[mgt], n_hi, n_lo, 4,
                      transpose, dtype=torch.float64, device="cpu")
    assert torch.equal(tt.restr, tt.prol.T) == transpose
    xf = np.random.default_rng(2).standard_normal((tt.prol.shape[0], 5, 3))
    ref = np.asarray(jt.restrict(jnp.asarray(xf)))
    got = tt.restrict(torch.as_tensor(xf)).numpy()
    assert got.shape == ref.shape
    assert np.abs(got - ref).max() <= 1e-13 * np.abs(ref).max()

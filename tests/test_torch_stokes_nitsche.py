"""The Nitsche weak faces of stfem_tpu_torch's Stokes operator, smoother
and hierarchy, and its Stokes functionals, against stfem_tpu's (CPU):
2D Q2 x DGP1 at refinement 2 (the hierarchy at refinement 1), weak
faces on all four sides and on the lid side (x = 1) only.

Tolerances: the operator apply (also reading the eliminated dofs), the
Nitsche rhs and the face element matrices in float64, 1e-12 relative
to the largest value; StokesVanka's float32 inverses and step couplings
with the face terms, 1e-5 of the largest (float32 batched inverses of
the same patches); the float32 power-estimate omegas 1e-5 relative and
one float32 V-cycle from stfem_tpu's factors 1e-5 of the largest; the
wall force on stfem_tpu's analytic case (tests/test_stokes.py:140-157)
1e-12 absolute, and the wall force and the divergence norm of a random
field 1e-12 relative."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu import types as jtypes
from stfem_tpu.blocks import BlockSlice as JBlockSlice
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.functionals import compute_divergence_norm as jdiv
from stfem_tpu.ops.functionals import compute_wall_force as jforce
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.ops.stokes import StokesOperator as JStokes
from stfem_tpu.stmg.gmg import GMGParams as JParams
from stfem_tpu.stmg.gmg import build_stmg_stokes as jbuild
from stfem_tpu.stmg.stokes_level import StokesVanka as JVanka
from stfem_tpu.time import tables as jtab
from stfem_tpu_torch import types as ttypes
from stfem_tpu_torch.blocks import BlockSlice
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.functionals import (compute_divergence_norm,
                                             compute_wall_force)
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.ops.stokes import StokesOperator
from stfem_tpu_torch.stmg.gmg import GMGParams, build_stmg_stokes
from stfem_tpu_torch.stmg.smoother import IdentitySmoother
from stfem_tpu_torch.stmg.stokes_level import StokesVanka
from stfem_tpu_torch.utils.carry import load_gmg, load_stokes_vanka

torch.set_num_threads(1)

ALL_FACES = ((0, 0), (0, 1), (1, 0), (1, 1))
LID = ((0, 1),)
FACES = pytest.mark.parametrize("faces", [ALL_FACES, LID],
                                ids=["all", "lid"])
NU, TAU, NTAO = 0.7, 0.125, 2


def _meshes(ref=2):
    return (JMesh([1, 1], [0.0, 0.0], [1.0, 1.0], refinement=ref),
            StructuredMesh([1, 1], [0.0, 0.0], [1.0, 1.0], refinement=ref))


def _ops(faces, dtype=torch.float64):
    jm, tm = _meshes()
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    return (JStokes(jm, 2, 1, 3, NU, dtype=jdt, weak_faces=faces),
            StokesOperator(tm, 2, 1, 3, NU, dtype=dtype, device="cpu",
                           weak_faces=faces))


def _rel_close(t, j, rel):
    j = np.asarray(j, np.float64)
    np.testing.assert_allclose(np.asarray(t.detach(), np.float64), j,
                               rtol=0, atol=rel * max(np.abs(j).max(),
                                                      1e-300))


@FACES
@pytest.mark.parametrize("mask_input", [True, False])
def test_apply_with_weak_faces(faces, mask_input):
    js, ts = _ops(faces)
    np.testing.assert_array_equal(ts.mask_u_np, js.mask_u_np)
    rng = np.random.default_rng(1)
    u = rng.standard_normal((3, 2) + ts.dof_shape_u)
    p = rng.standard_normal((3,) + ts.p_shape)
    jr = js.apply(jnp.asarray(u), jnp.asarray(p), mask_input=mask_input)
    tr = ts.apply(torch.tensor(u), torch.tensor(p), mask_input=mask_input)
    for t, j in zip(tr, jr):
        _rel_close(t, j, 1e-12)
    # the Nitsche terms alone
    for t, j in zip(ts.apply_nitsche(torch.tensor(u), torch.tensor(p)),
                    js.apply_nitsche(jnp.asarray(u), jnp.asarray(p))):
        _rel_close(t, j, 1e-12)


@FACES
def test_nitsche_rhs(faces):
    js, ts = _ops(faces)

    def g_jax(c, t):
        return jnp.stack([jnp.sin(3 * c[..., 0] + t), c[..., 1] ** 2 * t],
                         -1)

    def g_torch(c, t):
        return torch.stack([torch.sin(3 * c[..., 0] + t),
                            c[..., 1] ** 2 * t], -1)

    for t in (0.0, 0.4):
        for tr, jr in zip(ts.nitsche_rhs(g_torch, t),
                          js.nitsche_rhs(g_jax, t)):
            _rel_close(tr, jr, 1e-12)


@FACES
def test_face_element_matrices(faces):
    js, ts = _ops(faces)
    jf, tf = js.face_element_matrices(), ts.face_element_matrices()
    assert [f[:2] for f in tf] == [f[:2] for f in jf]
    for (_, _, tuu, tup, tpu), (_, _, juu, jup, jpu) in zip(tf, jf):
        for t, j in zip(tuu + [tup, tpu], list(juu) + [jup, jpu]):
            _rel_close(t, j, 1e-12)


@FACES
@pytest.mark.parametrize("kind", ["DG", "CGP"])
def test_vanka_inverses_with_faces(faces, kind):
    js, ts = _ops(faces, torch.float32)
    jm, tm = _meshes()
    jt = getattr(jtypes.TimeStepType, kind)
    r = 1
    nt = r + 1 if kind == "DG" else r
    A, B = jtab.get_fe_time_weights_stokes(jt, r, TAU, NTAO)[:2]
    jM = JOp(jm, 2, 3, 1.0, 0.0, dtype=jnp.float32, mask=js.mask_u_np)
    tM = LaplaceMassOperator(tm, 2, 3, 1.0, 0.0, dtype=torch.float32,
                             device="cpu", mask=ts.mask_u_np)
    jv = JVanka(js, jM, A, B, JBlockSlice(NTAO, 2, nt), dtype=jnp.float32)
    tv = StokesVanka(ts, tM, A, B, BlockSlice(NTAO, 2, nt),
                     dtype=torch.float32)
    assert tv.n_steps == jv.n_steps == NTAO
    _rel_close(tv.Binv, jv.Binv, 1e-5)
    _rel_close(tv.Kappa, jv.Kappa, 1e-5)
    x = np.random.default_rng(2).standard_normal(
        (NTAO * nt, ts.n_u + ts.n_p)).astype(np.float32)
    _rel_close(tv.vmult(torch.tensor(x)), jv.vmult(jnp.asarray(x)), 1e-5)


@pytest.fixture(scope="module")
def lid_hierarchies():
    """The lid cavity's hierarchy (weak x = 1 face) in both packages:
    refinement 1 (three levels: h, h and tau), dG(1), 2 steps per slab,
    GMGParams' defaults with smoothing range 5."""
    jm, tm = _meshes(1)
    jg = jbuild(jm, 1, jtypes.TimeStepType.DG, NTAO, TAU, viscosity=1.0,
                params=JParams(smoothing_range=5.0), fe_degree_min=1,
                weak_faces=LID)
    tg = build_stmg_stokes(tm, 1, ttypes.TimeStepType.DG, NTAO, TAU,
                           params=GMGParams(smoothing_range=5.0),
                           weak_faces=LID, device="cpu")
    return jg, tg


def test_lid_hierarchy_omegas(lid_hierarchies):
    jg, tg = lid_hierarchies
    assert [m.name for m in tg.mg_type_level] == \
        [m.name for m in jg.mg_type_level]
    assert tg.coarse == "Direct" and jg.params.coarse_direct_pinv
    n = 0
    for l, (jl, tl) in enumerate(zip(jg.levels, tg.levels)):
        if l == 0 or isinstance(tl.smoother, IdentitySmoother):
            continue
        jo, to = float(jl.smoother.omega), float(tl.smoother.omega)
        assert abs(to - jo) <= 1e-5 * abs(jo), (l, to, jo)
        _rel_close(tl.smoother.precond.Binv, jl.smoother.precond.Binv, 1e-5)
        n += 1
    assert n


def test_lid_vcycle_with_jax_factors(lid_hierarchies):
    jg, _ = lid_hierarchies
    _, tm = _meshes(1)
    tg = build_stmg_stokes(tm, 1, ttypes.TimeStepType.DG, NTAO, TAU,
                           params=GMGParams(smoothing_range=5.0),
                           weak_faces=LID, device="cpu")
    omegas = [None] * len(jg.levels)
    for l, (jl, tl) in enumerate(zip(jg.levels, tg.levels)):
        if l == 0 or isinstance(tl.smoother, IdentitySmoother):
            continue
        omegas[l] = float(jl.smoother.omega)
        jv = jl.smoother.precond
        load_stokes_vanka(tl.smoother.precond, np.asarray(jv.Binv),
                          None if jv.Kappa is None else np.asarray(jv.Kappa))
    load_gmg(tg, omegas, np.asarray(jg.coarse_Ainv),
             np.asarray(jg.coarse_null))
    top = tg.levels[-1]
    x = np.random.default_rng(9).standard_normal((top.n_blocks,)
                                                 + top.dof_shape)
    _rel_close(tg.vmult(torch.as_tensor(x, dtype=torch.float32)),
               jax.jit(jg.vmult)(jnp.asarray(x, jnp.float32)), 1e-5)


def test_wall_force_exact():
    """u = (a y, 0), p = c on the unit square: on the x = 1 wall (n = e_x)
    the traction is (c, -nu a)."""
    _, tm = _meshes()
    S = StokesOperator(tm, 2, 1, 3, viscosity=0.7, device="cpu")
    coords = tm.dof_coordinates(2)
    a, c = 1.3, 0.45
    u = np.stack([a * coords[..., 1], np.zeros(coords.shape[:-1])])
    p = np.zeros(tm.cells + (S.n_ploc,))
    p[..., 0] = c
    F = compute_wall_force(S, u, p, (0, 1))
    np.testing.assert_allclose(F.numpy(), [c, -0.7 * a], rtol=0, atol=1e-12)


@FACES
def test_functionals_random_field(faces):
    js, ts = _ops(faces)
    rng = np.random.default_rng(5)
    u = rng.standard_normal((2,) + ts.dof_shape_u)
    p = rng.standard_normal(ts.p_shape)
    for face in ALL_FACES:
        _rel_close(compute_wall_force(ts, torch.tensor(u), torch.tensor(p),
                                      face),
                   jforce(js, u, p, face), 1e-12)
    assert float(compute_divergence_norm(ts, torch.tensor(u))) == \
        pytest.approx(jdiv(js, jnp.asarray(u)), rel=1e-12)


def test_smoother_coarse_projects_nullspace(monkeypatch):
    """A coarse level above GMG.DIRECT_COARSE_MAX is solved by its own
    smoother, with the constant pressure projected out of its defect and
    solution as in stfem_tpu: one V-cycle from stfem_tpu's factors, with
    the direct solve switched off in both packages."""
    from stfem_tpu.stmg import gmg as jgmg
    from stfem_tpu_torch.stmg import gmg as tgmg
    monkeypatch.setattr(jgmg.GMG, "DIRECT_COARSE_MAX", 0)
    monkeypatch.setattr(tgmg.GMG, "DIRECT_COARSE_MAX", 0)
    jm, tm = _meshes(1)
    jg = jbuild(jm, 1, jtypes.TimeStepType.DG, NTAO, TAU, viscosity=1.0,
                params=JParams(smoothing_range=5.0), fe_degree_min=1,
                weak_faces=LID)
    tg = build_stmg_stokes(tm, 1, ttypes.TimeStepType.DG, NTAO, TAU,
                           params=GMGParams(smoothing_range=5.0),
                           weak_faces=LID, device="cpu")
    assert tg.coarse == "Smoother" and jg.coarse_Ainv is None
    assert tg.coarse_null is not None and jg.coarse_null is not None
    omegas = [None] * len(jg.levels)
    for l, (jl, tl) in enumerate(zip(jg.levels, tg.levels)):
        if isinstance(tl.smoother, IdentitySmoother):
            continue
        omegas[l] = float(jl.smoother.omega)
        jv = jl.smoother.precond
        load_stokes_vanka(tl.smoother.precond, np.asarray(jv.Binv),
                          None if jv.Kappa is None else np.asarray(jv.Kappa))
    assert omegas[0] is not None
    load_gmg(tg, omegas, coarse_null=np.asarray(jg.coarse_null))
    top = tg.levels[-1]
    x = np.random.default_rng(3).standard_normal((top.n_blocks,)
                                                 + top.dof_shape)
    _rel_close(tg.vmult(torch.as_tensor(x, dtype=torch.float32)),
               jax.jit(jg.vmult)(jnp.asarray(x, jnp.float32)), 1e-5)

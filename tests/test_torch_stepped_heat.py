"""The heat operator stack of stfem_tpu_torch on stepped, masked and mapped
meshes against stfem_tpu's (CPU, float64): the gates and factors that
choose and build the operator routes and the Vanka smoother.

- KronAssembled.supports, the route SystemMatrix takes and the Vanka mode
  follow stfem_tpu's gates on every mesh kind: Kronecker factors and the
  grid-mode Vanka on tensor (uniform or stepped) meshes only.
- SystemMatrix.vmult (the slab tables of dG(1), 2 steps) and vmult_slice
  (the rhs coupling column) within 1e-12 of the largest entry of
  stfem_tpu's, through every route the mesh admits ("kron" on stepped
  meshes, "quad" and "grid" in float64 on stepped and masked ones, "cell"
  on mapped ones); a route the mesh does not admit raises.
- KronAssembled.pair on stepped 2D and 3D meshes (kernel K2's and K3's
  plain versions here) within 1e-12.
- One PreconditionVanka apply (float64, 2 steps a slab) within 1e-12 of
  stfem_tpu's, grid mode on stepped meshes and cell mode on masked and
  mapped ones."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.kronfac import KronAssembled as JKron
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.stmg.vanka import PreconditionVanka as JVanka
from stfem_tpu.system import SystemMatrix as JSystem
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.kronfac import KronAssembled
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.stmg.vanka import PreconditionVanka, separable
from stfem_tpu_torch.system import SystemMatrix
from stfem_tpu_torch.time.tables import get_fe_time_weights
from stfem_tpu_torch.types import TimeStepType

torch.set_num_threads(1)
F64 = torch.float64


def _bend(x, stack):
    """A smooth fold-free map of the unit square (a bump along the
    diagonal), written for either array library."""
    g = 0.3 * x[..., 0] * (1 - x[..., 0]) * x[..., 1] * (1 - x[..., 1])
    return stack([x[..., 0] + g, x[..., 1] - g], -1)


def _jmap(x):
    return _bend(x, jnp.stack)


def _tmap(x):
    return _bend(x, torch.stack)


MASK = np.ones((4, 4))
MASK[1, 2] = 0.0
# (stfem_tpu mesh kwargs, port mesh kwargs) on [0, 1]^2 from 2 x 2 cells
KINDS = {
    "stepped": dict(subdivisions=None, refinement=1,
                    axis_steps=[[0.3, 0.7], [0.6, 0.15, 0.25]]),
    "masked": dict(refinement=1, cell_mask=MASK),
    "mapped": dict(refinement=1, map_exact=True),
    "q1_mapped": dict(refinement=1),
}


def meshes(kind):
    kw = dict(KINDS[kind])
    sub = kw.pop("subdivisions", [2, 2]) or [2, 2]
    jkw, tkw = dict(kw), dict(kw)
    if kind in ("mapped", "q1_mapped"):
        jkw["vertex_map"], tkw["vertex_map"] = _jmap, _tmap
    return (JMesh(sub, [0.0, 0.0], [1.0, 1.0], **jkw),
            StructuredMesh(sub, [0.0, 0.0], [1.0, 1.0], **tkw))


def port_operators(tm, k=2):
    """The port's float64 stiffness and mass operators on the CPU."""
    return (LaplaceMassOperator(tm, k, k + 1, 0.0, 1.0, dtype=F64,
                                device="cpu"),
            LaplaceMassOperator(tm, k, k + 1, 1.0, 0.0, dtype=F64,
                                device="cpu"))


def operators(jm, tm, k=2):
    return ((JOp(jm, k, k + 1, 0.0, 1.0), JOp(jm, k, k + 1, 1.0, 0.0)),
            port_operators(tm, k))


def _close(got, ref, rel=1e-12):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    ref = np.asarray(ref, np.float64)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rel * np.abs(ref).max())


TABLES = get_fe_time_weights(TimeStepType.DG, 1, 0.05, 2)


@pytest.mark.parametrize("kind", list(KINDS))
def test_gates(kind):
    jm, tm = meshes(kind)
    (jK, jM), (tK, tM) = operators(jm, tm)
    assert KronAssembled.supports(tK, tM) == JKron.supports(jK, jM)
    assert KronAssembled.supports(tK, tM) == (kind == "stepped")
    A, B = TABLES[0], TABLES[1]
    jv = JVanka(jK, jM, A, B, dtype=jnp.float64, n_steps=2)
    assert separable(tK, tM) == (jv.Wdn is not None) == (kind == "stepped")
    expect = {"stepped": "kron", "masked": "quad", "mapped": "cell",
              "q1_mapped": "cell"}[kind]
    assert SystemMatrix(tK, tM, A, B).route == expect


ROUTES = [("stepped", "kron"), ("stepped", "quad"), ("stepped", "grid"),
          ("masked", "quad"), ("masked", "grid"), ("mapped", "cell"),
          ("q1_mapped", "cell")]


@pytest.mark.parametrize("kind,route", ROUTES)
def test_system_matrix(kind, route):
    jm, tm = meshes(kind)
    (jK, jM), (tK, tM) = operators(jm, tm)
    A, B, G, _ = TABLES
    rng = np.random.default_rng(len(kind) + len(route))
    x = rng.standard_normal((A.shape[0],) + tK.dof_shape)
    got = SystemMatrix(tK, tM, A, B, route=route).vmult(torch.as_tensor(x))
    _close(got, JSystem(jK, jM, A, B).vmult(jnp.asarray(x)))
    rhs = SystemMatrix(tK, tM, np.zeros_like(G), G, route=route)
    _close(rhs.vmult_slice(torch.as_tensor(x[0])),
           JSystem(jK, jM, np.zeros_like(G), G).vmult_slice(
               jnp.asarray(x[0])))


@pytest.mark.parametrize("kind", ["mapped", "q1_mapped"])
def test_diagonal_routes_refuse_full_jacobians(kind):
    tK, tM = port_operators(meshes(kind)[1])
    A, B = TABLES[0], TABLES[1]
    for route in ("kron", "quad", "grid"):
        with pytest.raises(ValueError):
            SystemMatrix(tK, tM, A, B, route=route)


@pytest.mark.parametrize("dim,k", [(2, 3), (3, 2), (3, 4)])
def test_kron_pair_stepped(dim, k):
    steps = [[0.2, 0.5, 0.3], [0.7, 0.3], [0.1, 0.4, 0.25, 0.25]][:dim]
    lo = [0.0] * dim
    jm = JMesh([len(s) for s in steps], lo, None, axis_steps=steps)
    tm = StructuredMesh([len(s) for s in steps], lo, None, axis_steps=steps)
    (jK, jM), (tK, tM) = operators(jm, tm, k)
    x = np.random.default_rng(dim * k).standard_normal((3,) + tK.dof_shape)
    jk = JKron(jK, jM, jnp.float64)
    tk = KronAssembled(tK, tM, F64)
    for need in ((True, True), (True, False), (False, True)):
        got = tk.pair(torch.as_tensor(x), *need)
        ref = jk.pair(jnp.asarray(x), *need)
        for g, r in zip(got, ref):
            assert (g is None) == (r is None)
            if g is not None:
                _close(g, r)


@pytest.mark.parametrize("kind", list(KINDS))
def test_vanka(kind):
    jm, tm = meshes(kind)
    (jK, jM), (tK, tM) = operators(jm, tm)
    A, B = TABLES[0], TABLES[1]
    jv = JVanka(jK, jM, A, B, dtype=jnp.float64, n_steps=2)
    tv = PreconditionVanka(tK, tM, A, B, dtype=F64, n_steps=2)
    assert tv.mode == ("grid" if kind == "stepped" else "cell")
    x = (np.random.default_rng(7).standard_normal((A.shape[0],)
                                                  + tK.dof_shape)
         * tK.mask_np)
    _close(tv.vmult(torch.as_tensor(x)), jv.vmult(jnp.asarray(x)))

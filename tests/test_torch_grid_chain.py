"""Kernel K4 (the fused grid chain, stfem_tpu_torch/ops/grid_chain.py) and
the grid-mode Vanka that runs it, vs stfem_tpu's Pallas chain
(ops/pallas_grid.py, interpret mode on the CPU) and stfem_tpu's Vanka with
STFEM_PALLAS_GRID=1 (CPU).

stfem_tpu's chain_down returns the axes in chain_down_order (a Mosaic
artifact) and its chain_up takes them in that order; the port keeps the
natural order, so the tests transpose between the two.

Tolerances, relative to the reference's max norm: float64 1e-12 (the same
sums in another order); float32 1e-5 (float32 sums in another order); bf16
input 8e-3 (both round the float32 sums once to bf16: one bf16 ulp, 2^-8,
either side).  The Vanka applies: float64 1e-9 and float32 1e-5 from each
package's own build (the eigenvector signs may differ, the apply does
not); bf16 levels with the JAX factors carried 2e-2 (the bf16 roundings of
the down chain propagate through the time solve and the up chain)."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops import pallas_grid
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.stmg.vanka import PreconditionVanka as JVanka
from stfem_tpu.time.tables import (get_fe_time_weights,
                                   get_fe_time_weights_wave)
from stfem_tpu.types import TimeStepType as JT
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.grid_chain import (chain_down, chain_down_reference,
                                            chain_up, chain_up_reference)
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.stmg.vanka import PreconditionVanka
from stfem_tpu_torch.utils.carry import load_vanka

torch.set_num_threads(1)

_TOL = {"f64": 1e-12, "f32": 1e-5, "bf16": 8e-3}
_NP = {"f64": np.float64, "f32": np.float32, "bf16": np.float32}
_JDT = {"f64": jnp.float64, "f32": jnp.float32, "bf16": jnp.bfloat16}
_TDT = {"f64": torch.float64, "f32": torch.float32, "bf16": torch.bfloat16}


def _rel(got, ref):
    got = np.asarray(got.double().numpy() if torch.is_tensor(got) else got,
                     np.float64)
    ref = np.asarray(ref).astype(np.float64)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return np.max(np.abs(got - ref)) / np.max(np.abs(ref))


def _to_natural(y, dim):
    """stfem_tpu's chain_down output order -> (q_0, .., q_{dim-1})."""
    order = pallas_grid.chain_down_order(dim)
    return np.transpose(np.asarray(y),
                        (0,) + tuple(1 + order.index(d) for d in range(dim)))


def _to_chain_order(w, dim):
    """(q_0, .., q_{dim-1}) -> the order stfem_tpu's chain_up takes."""
    order = pallas_grid.chain_down_order(dim)
    return np.transpose(w, (0,) + tuple(1 + d for d in order))


def _inputs(shape, outs, kind, seed):
    """x (nb, *shape) and one (out_d, in_d) matrix per axis, as numpy in
    the test dtype (bf16 values handed over as exact float32)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(shape).astype(_NP[kind])
    mats = [rng.standard_normal((q, n)).astype(_NP[kind])
            for q, n in zip(outs, shape[1:])]
    if kind == "bf16":
        x = np.asarray(jnp.asarray(x, jnp.bfloat16), np.float32)
        mats = [np.asarray(jnp.asarray(m, jnp.bfloat16), np.float32)
                for m in mats]
    return x, mats


def _jax(a, kind):
    return jnp.asarray(a, _JDT[kind])


def _torch(a, kind):
    return torch.as_tensor(a).to(_TDT[kind])


_SHAPES = [((5, 9, 13, 11), (7, 11, 13)),        # odd, every axis differs
           ((3, 13, 13, 13), (15, 15, 15)),      # a 3^3 Q4 Vanka level
           ((4, 9, 7), (11, 5)),                 # dim 2
           ((2, 17, 17), (20, 20))]              # dim 2, Q4 4^2 cells


@pytest.mark.parametrize("kind", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("shape,outs", _SHAPES)
def test_chain_down_plain_vs_pallas(shape, outs, kind):
    x, mats = _inputs(shape, outs, kind, seed=len(shape) + sum(outs))
    dim = len(outs)
    ref = pallas_grid.chain_down(_jax(x, kind), [_jax(m, kind) for m in mats])
    got = chain_down_reference(_torch(x, kind),
                               [_torch(m, kind) for m in mats])
    assert got.dtype == _TDT[kind]
    assert _rel(got, _to_natural(ref, dim)) <= _TOL[kind]


@pytest.mark.parametrize("kind", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("shape,outs", _SHAPES)
def test_chain_up_plain_vs_pallas(shape, outs, kind):
    """The up chain maps the eigen grid back: w (nb, *outs), matrices
    (n_d, q_d)."""
    nb, ins = shape[0], shape[1:]
    w, mats = _inputs((nb,) + tuple(outs), ins, kind, seed=3 + sum(ins))
    dim = len(outs)
    ref = pallas_grid.chain_up(_jax(_to_chain_order(w, dim), kind),
                               [_jax(m, kind) for m in mats])
    got = chain_up_reference(_torch(w, kind),
                             [_torch(m, kind) for m in mats])
    assert got.shape == (nb,) + tuple(ins)
    assert _rel(got, ref) <= _TOL[kind]


def test_chain_wrappers_cpu_use_plain_version():
    """On CPU tensors the wrappers are the plain versions (no launch);
    out_dtype rounds the float32 sums once."""
    x, mats = _inputs((5, 9, 13, 11), (7, 11, 13), "bf16", seed=1)
    xt = _torch(x, "bf16")
    mt = [_torch(m, "bf16") for m in mats]
    before = (chain_down.launches, chain_up.launches)
    down = chain_down(xt, mt)
    up = chain_up(down, [m.T for m in mt], torch.float32)
    assert (chain_down.launches, chain_up.launches) == before
    assert torch.equal(down, chain_down_reference(xt, mt))
    assert up.dtype == torch.float32 and up.shape == xt.shape
    wide = chain_down_reference(xt, mt, torch.float32)
    assert torch.equal(wide.to(torch.bfloat16), down)


def test_chain_wrappers_reject_other_devices():
    x = torch.zeros((2, 3, 3, 3), device="meta")
    m = [torch.zeros((4, 3), device="meta")] * 3
    with pytest.raises(ValueError):
        chain_down(x, m)
    with pytest.raises(ValueError):
        chain_up(x, m)


def _ops(cells, k, dt):
    dim = len(cells)
    jm = JMesh(list(cells), [0.0] * dim, [1.0] * dim)
    tm = StructuredMesh(list(cells), [0.0] * dim, [1.0] * dim)
    jops = [JOp(jm, k, k + 1, m, l, dtype=_JDT[dt] if dt != "bf16"
                else jnp.float32) for m, l in ((0.0, 1.0), (1.0, 0.0))]
    tops = [LaplaceMassOperator(tm, k, k + 1, m, l,
                                dtype=_TDT[dt] if dt != "bf16"
                                else torch.float32, device="cpu")
            for m, l in ((0.0, 1.0), (1.0, 0.0))]
    return jops, tops


def _tables(kind, ns):
    if kind == "heat":
        return get_fe_time_weights(JT.DG, 2, 0.125, ns)[:2]
    A, B, G, Z = get_fe_time_weights(JT.DG, 2, 0.125, 1)
    return get_fe_time_weights_wave(JT.DG, A, B, G, Z, ns)[:2]


def _pallas_vanka(monkeypatch, cells, k, tables, ns, dt):
    monkeypatch.setenv("STFEM_PALLAS_GRID", "1")
    monkeypatch.setenv("STFEM_PALLAS_MIN_DOFS", "1")
    (jK, jM), (tK, tM) = _ops(cells, k, dt)
    A, B = tables
    bf16 = dt == "bf16"
    jv = JVanka(jK, jM, A, B, dtype=_JDT[dt], n_steps=ns,
                storage_dtype=jnp.bfloat16 if bf16 else None)
    tv = PreconditionVanka(tK, tM, A, B, dtype=_TDT[dt], n_steps=ns,
                           storage_dtype=torch.bfloat16 if bf16 else None)
    assert jv.pallas_grid and jv.n_steps == tv.n_steps
    x = np.random.default_rng(4).standard_normal(
        (A.shape[0],) + tuple(jK.dof_shape)) * jK.mask_np
    return jv, tv, x


_VANKA_CASES = [("heat", (3, 3, 3), 4, 4), ("wave", (3, 3, 3), 4, 4),
                ("wave", (4, 4), 3, 2), ("heat", (2, 3, 2), 2, 2)]


@pytest.mark.parametrize("dt", ["f64", "f32"])
@pytest.mark.parametrize("kind,cells,k,ns", _VANKA_CASES)
def test_vanka_vs_pallas_grid_own_build(monkeypatch, kind, cells, k, ns, dt):
    """Each package's own build; stfem_tpu applies its Pallas chains."""
    jv, tv, x = _pallas_vanka(monkeypatch, cells, k, _tables(kind, ns), ns,
                              dt)
    assert (tv.TTg is not None) == (kind == "wave")
    ref = jv.vmult(jnp.asarray(x, _JDT[dt]))
    got = tv.vmult(torch.as_tensor(x).to(_TDT[dt]))
    assert got.dtype == _TDT[dt]
    assert _rel(got, ref) <= {"f64": 1e-9, "f32": 1e-5}[dt]


def _natural_factor(a, cells, k):
    """stfem_tpu's Pallas-order per-position factors (last axis flattened
    over the chain_down_order axes) -> the port's natural order."""
    if a is None:
        return None
    dim = len(cells)
    order = pallas_grid.chain_down_order(dim)
    q = [int(cells[d]) * (k + 1) for d in order]
    a = np.asarray(a, np.float32)
    lead = a.shape[:-1]
    a = a.reshape(lead + tuple(q))
    perm = tuple(range(len(lead))) + tuple(len(lead) + order.index(d)
                                           for d in range(dim))
    return np.ascontiguousarray(np.transpose(a, perm)).reshape(lead + (-1,))


@pytest.mark.parametrize("dt,tol", [("f32", 1e-5), ("bf16", 2e-2)])
@pytest.mark.parametrize("kind,cells,k,ns", _VANKA_CASES[:3])
def test_vanka_vs_pallas_grid_carried(monkeypatch, kind, cells, k, ns, dt,
                                      tol):
    """stfem_tpu's factors carried across (reordered to natural order)."""
    jv, tv, x = _pallas_vanka(monkeypatch, cells, k, _tables(kind, ns), ns,
                              dt)
    f32 = lambda a: np.asarray(a, np.float32)
    load_vanka(tv, [f32(w) for w in jv.Wdn], [f32(w) for w in jv.Wup],
               *(_natural_factor(a, cells, k)
                 for a in (jv.GinvT, jv.cvecT, jv.TTg)))
    xj = jnp.asarray(x, jnp.float32)
    ref = jv.vmult(xj)
    got = tv.vmult(torch.as_tensor(np.array(xj)))
    assert got.dtype == _TDT[dt]
    assert _rel(got, ref) <= tol

"""The cell-blocked contract of kernel K4 (stfem_tpu_torch/ops/grid_chain.py)
on the CPU: the plain torch forms that follow the kernels' indexing, the
structure check, and the tile plans of K4 and K2.

- chain_down_blocked (cell-local) and chain_up_blocked (owner computes,
  with the c-1 face rule) equal the dense chain_reference to 1e-12 in
  float64 (the same products, summed in another order), on cubic and
  non-cubic cell counts, one cell, r other than k + 1 and dim 2.
- check_cell_blocks accepts the port's own Vanka Wdn / Wup and stfem_tpu's
  after load_vanka, and rejects a matrix with one nonzero off the blocks,
  also one that changed after its check.
- the tile plans cover every output row once, within the kernels' thread
  and position limits."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.stmg.vanka import PreconditionVanka as JVanka
from stfem_tpu.time.tables import get_fe_time_weights
from stfem_tpu.types import TimeStepType as JT
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops import kron_pair
from stfem_tpu_torch.ops.grid_chain import (MAX_POSITIONS, MAX_THREADS,
                                            TILE_CELLS, _require_blocks,
                                            cell_block_mask,
                                            chain_down_blocked,
                                            chain_reference, chain_up_blocked,
                                            check_cell_blocks, tile_plan)
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.stmg.vanka import PreconditionVanka
from stfem_tpu_torch.utils.carry import load_vanka

torch.set_num_threads(1)


def _blocked(rng, nc, k, r, up=False):
    m = rng.standard_normal((nc * r, nc * k + 1)) * cell_block_mask(
        nc, k, r).numpy()
    return torch.as_tensor(m.T.copy() if up else m)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


# (nb, cells per axis, k, r): the Vanka's r = k + 1 on cubic and
# non-cubic grids, one cell, r < k + 1 and r > k + 1, k = 1, dim 2
_CASES = [(3, (3, 3, 3), 4, 5), (2, (2, 3, 4), 2, 3), (4, (1, 1, 1), 2, 3),
          (2, (2, 3, 2), 3, 2), (2, (2, 1, 3), 1, 6), (3, (4, 3), 4, 5),
          (2, (1, 5), 3, 4)]


@pytest.mark.parametrize("nb,cells,k,r", _CASES)
def test_blocked_down_equals_dense(nb, cells, k, r):
    rng = np.random.default_rng(nb + 10 * k + r)
    x = torch.as_tensor(rng.standard_normal(
        (nb,) + tuple(c * k + 1 for c in cells)))
    mats = [_blocked(rng, c, k, r) for c in cells]
    got = chain_down_blocked(x, mats, cells, k)
    assert got.shape == (nb,) + tuple(c * r for c in cells)
    assert _rel(got, chain_reference(x, mats)) <= 1e-12


@pytest.mark.parametrize("nb,cells,k,r", _CASES)
def test_blocked_up_equals_dense(nb, cells, k, r):
    rng = np.random.default_rng(nb + 10 * k + r + 1)
    w = torch.as_tensor(rng.standard_normal(
        (nb,) + tuple(c * r for c in cells)))
    mats = [_blocked(rng, c, k, r, up=True) for c in cells]
    got = chain_up_blocked(w, mats, cells, k)
    assert got.shape == (nb,) + tuple(c * k + 1 for c in cells)
    assert _rel(got, chain_reference(w, mats)) <= 1e-12


def _ops(cells, k):
    dim = len(cells)
    jm = JMesh(list(cells), [0.0] * dim, [1.0] * dim)
    tm = StructuredMesh(list(cells), [0.0] * dim, [1.0] * dim)
    jops = [JOp(jm, k, k + 1, m, l, dtype=jnp.float32)
            for m, l in ((0.0, 1.0), (1.0, 0.0))]
    tops = [LaplaceMassOperator(tm, k, k + 1, m, l, dtype=torch.float32,
                                device="cpu")
            for m, l in ((0.0, 1.0), (1.0, 0.0))]
    return jops, tops


_VANKAS = [((3, 3, 3), 4, 2), ((2, 3, 2), 2, 2), ((4, 4), 3, 1)]


@pytest.mark.parametrize("cells,k,ns", _VANKAS)
def test_check_accepts_port_vanka(cells, k, ns):
    _, (tK, tM) = _ops(cells, k)
    A, B = get_fe_time_weights(JT.DG, 2, 0.125, ns)[:2]
    tv = PreconditionVanka(tK, tM, A, B, dtype=torch.float32, n_steps=ns)
    check_cell_blocks(tv.Wdn, cells, k)
    check_cell_blocks(tv.Wup, cells, k, up=True)
    # the build stamped them: the wrappers' check passes without a scan
    _require_blocks(tv.Wdn, cells, k, False, "test")
    assert all(hasattr(m, "_stfem_cell_blocks") for m in tv.Wdn + tv.Wup)


@pytest.mark.parametrize("cells,k,ns", _VANKAS)
def test_check_accepts_jax_vanka_after_load(cells, k, ns):
    (jK, jM), (tK, tM) = _ops(cells, k)
    A, B = get_fe_time_weights(JT.DG, 2, 0.125, ns)[:2]
    jv = JVanka(jK, jM, A, B, dtype=jnp.float32, n_steps=ns)
    tv = PreconditionVanka(tK, tM, A, B, dtype=torch.float32, n_steps=ns)
    f32 = lambda a: np.asarray(a, np.float32)
    load_vanka(tv, [f32(w) for w in jv.Wdn], [f32(w) for w in jv.Wup])
    assert all(np.array_equal(f32(a), b.numpy())
               for a, b in zip(jv.Wdn, tv.Wdn))
    check_cell_blocks(tv.Wdn, cells, k)
    check_cell_blocks(tv.Wup, cells, k, up=True)


@pytest.mark.parametrize("up", [False, True])
def test_check_rejects_one_off_block_nonzero(up):
    cells, k = (3, 3, 3), 2
    _, (tK, tM) = _ops(cells, k)
    A, B = get_fe_time_weights(JT.DG, 2, 0.125, 2)[:2]
    tv = PreconditionVanka(tK, tM, A, B, dtype=torch.float32, n_steps=2)
    mats = [m.numpy().copy() for m in (tv.Wup if up else tv.Wdn)]
    # row 0 (cell 0) reaching cell 2's dofs, or dof 0 reaching cell 1
    if up:
        mats[1][0, 5] = 1e-7
    else:
        mats[1][0, 6] = 1e-7
    with pytest.raises(ValueError):
        check_cell_blocks([torch.as_tensor(m) for m in mats], cells, k, up)
    with pytest.raises(ValueError):          # load_vanka checks too
        load_vanka(tv, **{("Wup" if up else "Wdn"): mats})


def test_check_rechecks_a_changed_matrix():
    rng = np.random.default_rng(0)
    m = _blocked(rng, 3, 2, 3)
    check_cell_blocks([m], (3,), 2)
    _require_blocks([m], (3,), 2, False, "test")
    m[8, 0] = 1.0                            # cell 2's row reaching dof 0
    with pytest.raises(ValueError):
        _require_blocks([m], (3,), 2, False, "test")
    with pytest.raises(ValueError):          # no structure given
        _require_blocks([m], None, None, False, "test")


@pytest.mark.parametrize("up", [False, True])
@pytest.mark.parametrize("nc1,k1,r1,width", [
    (16, 4, 5, 80), (16, 4, 5, 65), (8, 4, 5, 40), (8, 4, 5, 33),
    (1, 2, 3, 3), (3, 4, 5, 13), (7, 1, 2, 200), (5, 3, 8, 17),
    (1, 0, 1, 9), (13, 2, 3, 9)])
def test_chain_tile_plan_covers_every_row_once(up, nc1, k1, r1, width):
    t, n_tiles, threads = tile_plan(up, nc1, k1, r1, width)
    assert threads % 32 == 0 and 32 <= threads <= MAX_THREADS
    assert n_tiles == -(-nc1 // t)
    count = np.zeros(nc1 * k1 + 1 if up else nc1 * r1, np.int64)
    for tile in range(n_tiles):
        c1a, c1b = tile * t, min(tile * t + t, nc1)
        assert c1a < c1b
        if up:       # the tile's dof rows, and the last one on the last
            lo, n = c1a * k1, (c1b - c1a) * k1 + (c1b == nc1)
        else:
            lo, n = c1a * r1, (c1b - c1a) * r1
        count[lo:lo + n] += 1
        assert c1b - c1a <= TILE_CELLS and n * width <= MAX_POSITIONS
    assert (count == 1).all()


@pytest.mark.parametrize("n1,n2", [(65, 65), (33, 33), (17, 17), (9, 13),
                                   (3, 3), (5, 384), (100, 7), (1, 1)])
def test_kron_tile_plan_covers_every_row_once(n1, n2):
    t, n_tiles, threads = kron_pair.tile_plan(n1, n2)
    assert threads % 32 == 0 and t * n2 <= threads <= kron_pair.MAX_THREADS
    count = np.zeros(n1, np.int64)
    for tile in range(n_tiles):
        i1a = tile * t
        assert i1a < n1
        count[i1a:min(i1a + t, n1)] += 1
    assert (count == 1).all()


def test_kron_tile_plan_rejects_wide_rows():
    with pytest.raises(ValueError):
        kron_pair.tile_plan(4, kron_pair.MAX_THREADS + 1)

"""The owner-computes sums of stfem_tpu_torch's Stokes path against the
scatter-adds (torch's index_add_) they replace, on the CPU in float64:

- stmg/stokes_level.py::_band_flat (the banded assembly behind the Stokes
  and cell-mode heat Vanka patches), 2D and 3D, degrees 1-3, with and
  without extra per-cell terms: bitwise the index_add_ assembly on one
  CPU thread (the same additions in the same cell order);
- ops/spatial.py::layer_sum over overlapping cell layers (the Nitsche
  face layers, a corner cell in two or three): bitwise the sequence of
  index_add_ calls, whose sums it reproduces in order;
- StokesSystemMatrix's element route with Nitsche faces on every wall
  (2D and 3D; its face cells' matrices summed over their faces once, at
  setup, so its one index_add_ an apply meets each face cell once):
  within 1e-14 of the element route with each face's terms added by
  index_add_.
Each target gathers its contributions in a fixed order and reduces them,
or takes a single add, so no float atomics' order can vary a result from
run to run; that the card's results repeat bitwise is chip_smoke.py's
phase 15 check."""
import numpy as np
import pytest
import torch

from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import (LaplaceMassOperator, layer_sum,
                                         overlap_add)
from stfem_tpu_torch.ops.stokes import StokesOperator
from stfem_tpu_torch.stmg.stokes_level import _band_flat
from stfem_tpu_torch.system_stokes import StokesSystemMatrix
from stfem_tpu_torch.utils.assembly import band_indices, layer_sources

torch.set_num_threads(1)
F64 = torch.float64


def _close(got, ref, rel=1e-14):
    ref = ref.numpy()
    np.testing.assert_allclose(got.numpy(), ref, rtol=0,
                               atol=rel * np.abs(ref).max())


def band_by_index_add(op, extra_E=None):
    """The scatter-add assembly _band_flat replaced."""
    k, dim = op.degree, op.dim
    E = op.element_matrices()
    if extra_E is not None:
        E = E + extra_E
    n_off = (2 * k + 1) ** dim
    band = torch.zeros(int(np.prod(op.dof_shape)) * n_off, dtype=op.dtype)
    flat_idx = torch.as_tensor(band_indices(op.cells, k))
    band.index_add_(0, flat_idx.reshape(-1), E.reshape(-1))
    band = band.reshape(op.dof_shape + (n_off,))
    band[..., (n_off - 1) // 2] += 1.0 - op.mask
    return band.reshape(-1)


@pytest.mark.parametrize("dim,k,extra", [(2, 1, False), (2, 3, True),
                                         (3, 2, False), (3, 1, True)])
def test_band_flat(dim, k, extra):
    mesh = StructuredMesh([3, 2, 2][:dim], [0.0] * dim, [1.0] * dim,
                          refinement=1, distort=0.1)
    op = LaplaceMassOperator(mesh, k, k + 1, 0.5, 1.0, dtype=F64,
                             device="cpu")
    E = None
    if extra:
        A = (k + 1) ** dim
        E = torch.as_tensor(np.random.default_rng(k).standard_normal(
            (mesh.n_cells, A, A)))
    assert torch.equal(_band_flat(op, E), band_by_index_add(op, E))


def test_layer_sum():
    cells = np.arange(60).reshape(3, 4, 5)
    layers = [cells[0].reshape(-1), cells[-1].reshape(-1),
              cells[:, 0].reshape(-1), cells[:, :, -1].reshape(-1)]
    fc, table = layer_sources(layers)
    assert sorted(fc) == sorted(set(np.concatenate(layers)))
    assert table.shape[1] == 3                    # corners in three layers
    rng = np.random.default_rng(0)
    parts = [torch.as_tensor(rng.standard_normal((len(l), 2, 3)))
             for l in layers]
    ref = torch.zeros((60, 2, 3), dtype=F64)
    for l, p in zip(layers, parts):
        ref.index_add_(0, torch.as_tensor(l), p)
    got = torch.zeros_like(ref)
    got[torch.as_tensor(fc)] = layer_sum(parts, torch.as_tensor(table))
    assert torch.equal(got, ref)


def element_vmult_by_index_add(m, x):
    """StokesSystemMatrix's element route with each face's terms added by
    index_add_, as before the owner-computes sum."""
    S = m.S
    dim, A = S.dim, (S.u_degree + 1) ** S.dim
    P = m._mloc.shape[1]
    cell_grid = np.arange(m._mloc.shape[0]).reshape(S.cells)
    faces = []
    for d0, side, Fuu, Fup, Fpu in S.face_element_matrices():
        F = torch.zeros((Fup.shape[0], P, P), dtype=F64)
        for c in range(dim):
            F[:, c * A:(c + 1) * A, c * A:(c + 1) * A] = Fuu[c]
        F[:, :dim * A, dim * A:] = Fup
        F[:, dim * A:, :dim * A] = Fpu
        faces.append((torch.as_tensor(
            cell_grid[S._plane(d0, side)].reshape(-1)), F))
    T, C, P = x.shape[0], m._mloc.shape[0], m._mloc.shape[1]
    loc = x.index_select(-1, m._lidx).reshape((T, -1, C, P)) * m._mloc
    y = torch.bmm(loc.movedim(2, 0).reshape(C, -1, P), m._E) \
        if m._E.ndim == 3 else loc @ m._E
    if m._E.ndim == 3:
        y = y.reshape((C,) + loc.shape[:2] + (2 * P,)).movedim(0, 2)
    out = (m.a @ y[..., :P].reshape(T, -1)
           + m.b @ y[..., P:].reshape(T, -1)).reshape(loc.shape)
    for layer, F in faces:
        yf = (F @ loc.index_select(2, layer).unsqueeze(-1)).squeeze(-1)
        out.index_add_(2, layer, (m.a @ yf.reshape(T, -1)).reshape(
            yf.shape))
    out = (out * m._mloc).reshape(T, -1, C * P)
    return overlap_add(out, m._src, m.S.dim).reshape(x.shape)


@pytest.mark.parametrize("dim", [2, 3])
def test_element_route_faces(dim):
    weak = [(0, 0), (0, 1), (1, 0), (1, 1)] + [(2, 0), (2, 1)][:2 * (dim - 2)]
    mesh = StructuredMesh([2] * dim, [0.0] * dim, [1.0] * dim,
                          refinement=1)
    S = StokesOperator(mesh, 2, 1, 3, 1.0, dtype=F64, device="cpu",
                       weak_faces=weak)
    Mu = LaplaceMassOperator(mesh, 2, 3, 1.0, 0.0, dtype=F64, device="cpu",
                             mask=S.mask_u_np)
    a = np.array([[1.0, 0.2], [-0.3, 0.9]])
    m = StokesSystemMatrix(S, Mu, a, 0.5 * a.T, route="element")
    assert len(m._face_cells) == 4 ** dim - 2 ** dim    # the wall cells
    x = torch.as_tensor(np.random.default_rng(dim).standard_normal(
        (2, S.n_u + S.n_p)))
    _close(m.vmult(x), element_vmult_by_index_add(m, x))

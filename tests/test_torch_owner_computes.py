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
  index_add_; with the weak obstacle of the DFG square and cylinder too;
- the weak obstacle's apply (StokesOperator.apply_nitsche_obstacle: each
  face's local matvec summed over the faces that meet a dof or a cell),
  CIP's plane adds (each interior plane's left- and right-layer terms
  overlap-added along the axis) and the obstacle Vanka's face terms
  (stmg/stokes_level.py::patch_face_terms: the Nitsche layers and the
  obstacle faces on each cell): within 1e-14 of index_add_ over the
  faces or planes, as stfem_tpu's .at[].add;
- the continuous (FE_Q) pressure's sums: the overlap-add through
  StokesOperator.local_maps (the shared pressure nodes with the
  velocity), the neighbour-assembled Vanka coupling
  (stmg/stokes_level.py::_assemble_patch_up: the patch rows and columns
  of the coupling assembled by index_add_), the element route with its
  Nitsche faces, and the FE_Q Vanka's scatter back: within 1e-14 of
  index_add_ (the element route also within 1e-12 of the operator's
  sum-factorised apply).
Each target gathers its contributions in a fixed order and reduces them,
or takes a single add, so no float atomics' order can vary a result from
run to run; that the card's results repeat bitwise is chip_smoke.py's
phase 15 check."""
import numpy as np
import pytest
import torch

from stfem_tpu_torch.drivers.stokes import dfg_cylinder_mesh, dfg_square_mesh
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import (LaplaceMassOperator, layer_sum,
                                         overlap_add)
from stfem_tpu_torch.ops.stokes import StokesOperator
from stfem_tpu_torch.blocks import BlockSlice
from stfem_tpu_torch.stmg.stokes_level import (StokesVanka,
                                               _assemble_patch_up, _band_flat,
                                               patch_face_terms)
from stfem_tpu_torch.system_stokes import StokesSystemMatrix
from stfem_tpu_torch.time.tables import (get_fe_time_weights_sequence,
                                         get_fe_time_weights_stokes)
from stfem_tpu_torch.types import TimeStepType
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
    if S.weak_obstacle:
        # one obstacle face at a time, unsummed
        ob = S._obstacle
        n = len(ob["pidx"])
        E_up = ob["E_up"].reshape(n, dim * A, -1)
        F = torch.zeros((n, P, P), dtype=F64)
        F[:, :dim * A, :dim * A] = ob["E_uu"].permute(0, 1, 3, 2, 4).reshape(
            n, dim * A, dim * A)
        F[:, :dim * A, dim * A:] = E_up
        F[:, dim * A:, :dim * A] = -E_up.transpose(1, 2)
        faces += [(torch.as_tensor(ob["pidx"][f:f + 1]), F[f:f + 1])
                  for f in range(n)]
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


WEAK, FREE = ((0, 0), (1, 0), (1, 1)), ((0, 1),)


@pytest.fixture(scope="module", params=["square", "cylinder"])
def obstacle_op(request):
    mesh = (dfg_square_mesh if request.param == "square"
            else dfg_cylinder_mesh)(1)
    return StokesOperator(mesh, 2, 1, 3, 1e-3, dtype=F64, device="cpu",
                          weak_faces=WEAK, free_faces=FREE,
                          weak_obstacle=True)


def test_element_route_obstacle(obstacle_op):
    S = obstacle_op
    Mu = LaplaceMassOperator(S.mesh, 2, 3, 1.0, 0.0, dtype=F64,
                             device="cpu", mask=S.mask_u_np)
    a = np.array([[1.0, 0.2], [-0.3, 0.9]])
    m = StokesSystemMatrix(S, Mu, a, 0.5 * a.T, route="element")
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (2, S.n_u + S.n_p)))
    _close(m.vmult(x), element_vmult_by_index_add(m, x))


def test_obstacle_apply(obstacle_op):
    """apply_nitsche_obstacle against the same local products scattered
    by index_add_ face after face."""
    S = obstacle_op
    ob = S._obstacle
    rng = np.random.default_rng(6)
    u = torch.as_tensor(rng.standard_normal((2, 2) + S.dof_shape_u))
    p = torch.as_tensor(rng.standard_normal((2,) + S.p_shape))
    uidx, pidx = torch.as_tensor(ob["uidx"]), torch.as_tensor(ob["pidx"])
    u_loc = u.reshape(2, 2, -1)[..., uidx]
    p_loc = p.reshape(2, -1, S.n_ploc)[:, pidx]
    ru_loc = (torch.einsum("fceab,...efb->...cfa", ob["E_uu"], u_loc)
              + torch.einsum("fcam,...fm->...cfa", ob["E_up"], p_loc))
    rp_loc = -torch.einsum("fcam,...cfa->...fm", ob["E_up"], u_loc)
    ru = torch.zeros((2, 2, u.shape[2] * u.shape[3]), dtype=F64)
    ru.index_add_(2, uidx.reshape(-1), ru_loc.flatten(-2))
    rp = torch.zeros((2, S.n_p // S.n_ploc, S.n_ploc), dtype=F64)
    rp.index_add_(1, pidx, rp_loc)
    got_u, got_p = S.apply_nitsche_obstacle(u, p)
    _close(got_u, ru.reshape(u.shape))
    _close(got_p, rp.reshape(p.shape))


def cip_by_index_add(S, u, u_lin, delta0):
    """stfem_tpu's apply_cip: per axis, component and interior plane the
    left and right layer terms scattered by index_add_ (.at[].add)."""
    dim, k = S.dim, S.u_degree
    D1, D0, V1 = S._cip
    pa = k ** 3 * np.sqrt(k)
    ru = torch.zeros_like(u)
    for d0 in range(dim):
        nc = S.cells[d0]
        h0 = float(S.mesh.h[d0])
        w_oth = float(np.prod([S.mesh.h[d] for d in range(dim) if d != d0]))
        delta_K = delta0 * w_oth ** (2.0 / max(dim - 1, 1)) / pa
        lidx = torch.as_tensor((np.arange(nc - 1)[:, None] * k
                                + np.arange(k + 1)).reshape(-1))
        ridx = lidx + k
        mb = torch.movedim(u_lin[:, d0], 1 + d0, 0)
        bn = torch.einsum("a,pa...->p...", V1,
                          mb[lidx].reshape((nc - 1, k + 1) + mb.shape[1:]))
        for c in range(dim):
            mv = torch.movedim(u[:, c], 1 + d0, 0)
            sh = (nc - 1, k + 1) + mv.shape[1:]
            jump = (torch.einsum("a,pa...->p...", D1 / h0,
                                 mv[lidx].reshape(sh))
                    - torch.einsum("a,pa...->p...", D0 / h0,
                                   mv[ridx].reshape(sh)))
            t = delta_K * bn * bn * jump * w_oth
            upd = torch.zeros_like(mv)
            upd.index_add_(0, lidx, torch.einsum(
                "a,p...->pa...", D1 / h0, t).reshape((-1,) + mv.shape[1:]))
            upd.index_add_(0, ridx, torch.einsum(
                "a,p...->pa...", -D0 / h0, t).reshape((-1,) + mv.shape[1:]))
            ru[:, c] += torch.movedim(upd, 0, 1 + d0)
    return ru * S.mask_u


@pytest.mark.parametrize("k", [2, 3])
def test_cip_plane_adds(k):
    mesh = StructuredMesh([3, 2], [0.0, 0.0], [1.0, 0.7], refinement=1)
    S = StokesOperator(mesh, k, k - 1, k + 1, 1.0, dtype=F64, device="cpu",
                       delta0=0.4)
    rng = np.random.default_rng(k)
    u = torch.as_tensor(rng.standard_normal((2, 2) + S.dof_shape_u))
    ul = torch.as_tensor(rng.standard_normal((2, 2) + S.dof_shape_u))
    _close(S.apply_cip(u, ul, 0.4), cip_by_index_add(S, u, ul, 0.4))


def test_obstacle_vanka_face_terms(obstacle_op):
    """patch_face_terms against the Nitsche layers' and the obstacle
    faces' terms added by index_add_, as stfem_tpu assembles them."""
    S = obstacle_op
    dim, C = S.dim, S.mesh.n_cells
    A = (S.u_degree + 1) ** dim
    face_uu, E_up, E_pu, (oc, off) = patch_face_terms(S, F64)
    _, ref_up, ref_pu = S.element_matrices()
    ref_uu = [torch.zeros((C, A, A), dtype=F64) for _ in range(dim)]
    cell_grid = np.arange(C).reshape(S.cells)
    for d0, side, Fuu, Fup, Fpu in S.face_element_matrices():
        layer = torch.as_tensor(cell_grid[S._plane(d0, side)].reshape(-1))
        for c in range(dim):
            ref_uu[c].index_add_(0, layer, Fuu[c])
        ref_up.index_add_(0, layer, Fup)
        ref_pu.index_add_(0, layer, Fpu)
    ob = S._obstacle
    pidx = torch.as_tensor(ob["pidx"])
    for c in range(dim):
        ref_uu[c].index_add_(0, pidx, ob["E_uu"][:, c, c])
    up = ob["E_up"].reshape(len(pidx), dim * A, -1)
    ref_up.index_add_(0, pidx, up)
    ref_pu.index_add_(0, pidx, -up.transpose(1, 2))
    E_off = ob["E_uu"].clone()
    E_off[:, range(dim), range(dim)] = 0.0
    ref_off = torch.zeros((C, dim, A, dim, A), dtype=F64)
    ref_off.index_add_(0, pidx, E_off.permute(0, 1, 3, 2, 4))
    for c in range(dim):
        _close(face_uu[c], ref_uu[c])
    _close(E_up, ref_up)
    _close(E_pu, ref_pu)
    got_off = torch.zeros_like(ref_off)
    got_off[oc] = off
    _close(got_off, ref_off)


FEQ_MESHES = pytest.mark.parametrize("kind", ["square-2d", "cube-3d",
                                              "dfg-2d"])


def _feq_op(kind, weak=()):
    """An FE_Q (Taylor-Hood Q2/Q1) operator: the unit square or cube at
    refinement 1, or the masked DFG square at refinement 1."""
    if kind == "dfg-2d":
        mesh = dfg_square_mesh(1)
    else:
        dim = 2 if kind == "square-2d" else 3
        mesh = StructuredMesh([2] * dim, [0.0] * dim, [1.0] * dim,
                              refinement=1)
    return StokesOperator(mesh, 2, 1, 3, 1.0, dtype=F64, device="cpu",
                          dg_pressure=False, weak_faces=weak)


@FEQ_MESHES
def test_feq_local_overlap(kind):
    """The FE_Q overlap-add through StokesOperator.local_maps (the element
    route's and the Vanka's: velocity and the shared pressure nodes)
    against index_add_ of every cell-local entry into the flat vector."""
    S = _feq_op(kind)
    lidx, src = S.local_maps()
    C, W = lidx.shape
    assert W == S.dim * 3 ** S.dim + 2 ** S.dim
    y = torch.as_tensor(np.random.default_rng(C).standard_normal((2, C * W)))
    ref = torch.zeros((2, S.n_u + S.n_p), dtype=F64)
    ref.index_add_(1, torch.as_tensor(lidx.reshape(-1)), y)
    _close(overlap_add(y, torch.as_tensor(src.reshape(-1)), S.dim), ref)


@FEQ_MESHES
def test_feq_patch_up(kind):
    """_assemble_patch_up's neighbour sum against the assembled u-p
    coupling (index_add_ of every cell's element tensor) restricted to
    each patch's rows and columns."""
    S = _feq_op(kind)
    C, dim = S.mesh.n_cells, S.dim
    A_u = 3 ** dim
    _, E_up, _ = S.element_matrices()
    lidx, _ = S.local_maps()
    rows = lidx[:, :dim * A_u]                      # flat u dofs
    cols = lidx[:, dim * A_u:] - S.n_u              # flat p nodes
    G = torch.zeros(S.n_u * S.n_p, dtype=F64)
    G.index_add_(0, torch.as_tensor(
        (rows[:, :, None] * S.n_p + cols[:, None, :]).reshape(-1)),
        E_up.reshape(-1))
    G = G.reshape(S.n_u, S.n_p)
    ref = torch.stack([G[torch.as_tensor(rows[c])][:, torch.as_tensor(
        cols[c])] for c in range(C)])
    _close(_assemble_patch_up(E_up, S.cells, dim, 2, 1), ref)


@pytest.mark.parametrize("kind,weak", [("square-2d", ()),
                                       ("square-2d", ((0, 0), (1, 1))),
                                       ("dfg-2d", ())],
                         ids=["square", "square-nitsche", "dfg"])
def test_feq_element_route(kind, weak):
    """The FE_Q element route (shared pressure nodes overlap-added)
    against its faces added by index_add_, and against the operator's
    own sum-factorised apply."""
    S = _feq_op(kind, weak)
    Mu = LaplaceMassOperator(S.mesh, 2, 3, 1.0, 0.0, dtype=F64, device="cpu",
                             mask=S.mask_u_np)
    a = np.array([[1.0, 0.2], [-0.3, 0.9]])
    m = StokesSystemMatrix(S, Mu, a, 0.5 * a.T, route="element")
    x = torch.as_tensor(np.random.default_rng(8).standard_normal(
        (2, S.n_u + S.n_p)))
    _close(m.vmult(x), element_vmult_by_index_add(m, x))
    ref = StokesSystemMatrix(S, Mu, a, 0.5 * a.T).vmult(x)
    _close(m.vmult(x), ref, 1e-12)


@FEQ_MESHES
def test_feq_vanka_scatter(kind):
    """The FE_Q Vanka's patch gather and its scatter back (one index
    gather each way) against index_add_ of every patch entry."""
    S = _feq_op(kind)
    Mu = LaplaceMassOperator(S.mesh, 2, 3, 1.0, 0.0, dtype=F64, device="cpu",
                             mask=S.mask_u_np)
    A, B = get_fe_time_weights_sequence(
        TimeStepType.DG, 0.125, 2, [], [1],
        weight_fn=get_fe_time_weights_stokes)[0][:2]
    v = StokesVanka(S, Mu, A, B, BlockSlice(2, 2, 2), dtype=F64)
    y = torch.as_tensor(np.random.default_rng(9).standard_normal(
        v._pidx.numel()))
    ref = torch.zeros(v._T * v._n, dtype=F64)
    ref.index_add_(0, v._pidx, y)
    _close(overlap_add(y, v._src, S.dim), ref)

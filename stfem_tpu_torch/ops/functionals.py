"""Surface and volume functionals of a Stokes field (counterpart of
stfem_tpu/ops/functionals.py; reference StokesMatrixFreeOperator::
compute_drag_lift / compute_divergence, operators.h:1344-1439).

Each returns a tensor on the field's device (a [dim] force, a 0-d norm),
so a caller gathers a whole row of functionals and reads it back once.
The obstacle's drag and lift run over the faces between active and
removed cells of a masked mesh, all faces in one batched pass; on a
mapped mesh (the DFG cylinder) the weighted normal of the curved
boundary comes from Nanson's formula through the map's Jacobian."""
from __future__ import annotations

import numpy as np
import torch

from ..mesh.fe import q_nodes_1d, shape_data_1d
from ..mesh.fe_dgp import dgp_exponents, shifted_legendre_value
from ..time.quadrature import LagrangeBasis, gauss
from ..utils.assembly import cell_dof_indices
from .spatial import _sumfac, cell_gather
from .stokes import StokesOperator, face_basis, face_jacobians, obstacle_faces

__all__ = ["obstacle_faces", "compute_drag_lift", "compute_drag_lift_mapped",
           "compute_wall_force", "compute_divergence_norm"]


def _obstacle_traction(S: StokesOperator, u, p,
                       scale: float) -> torch.Tensor:
    """scale * sum over the obstacle faces of int [p n - nu (grad u +
    grad u^T) n] ds, n outward from the fluid (into the obstacle): per
    face point the Jacobian J of the cell (ops/stokes.py::face_jacobians:
    the diagonal of its steps, times the map's Jacobian on a mapped
    mesh), n ds = n_sign detJ J^{-T} e_d0 dxi
    (Nanson), grad u through J^{-1}; every face in one batched pass per
    (axis, side)."""
    mesh, dim, k, nq = S.mesh, S.dim, S.u_degree, S.n_q
    nu = S.viscosity
    u = torch.as_tensor(u, dtype=S.dtype, device=S.device)
    p = torch.as_tensor(p, dtype=S.dtype, device=S.device)
    as_t = lambda a: torch.as_tensor(a, dtype=S.dtype, device=S.device)
    qw = gauss(nq)[1]
    wq = np.ones(1)
    for _ in range(dim - 1):
        wq = (wq[:, None] * qw[None, :]).reshape(-1)
    cdofs = cell_dof_indices(mesh.cells, k)            # [C, A]
    C = mesh.n_cells
    uflat = u.reshape(dim, -1)
    pflat = p.reshape(C, -1)
    faces = obstacle_faces(mesh)
    F = torch.zeros(dim, dtype=S.dtype, device=S.device)
    for d0 in range(dim):
        for side in (0, 1):
            grp = [cidx for d, cidx, s in faces if d == d0 and s == side]
            if not grp:
                continue
            cidx = np.asarray(grp)                      # [Fg, dim]
            cflat = np.ravel_multi_index(cidx.T, mesh.cells)
            J = face_jacobians(mesh, cidx, d0, side, nq)
            detJ = np.linalg.det(J)
            Jinv = np.linalg.inv(J)                     # [Fg, Qf, xi, x]
            n_sign = 1.0 if side == 1 else -1.0
            wn = as_t(n_sign * (detJ * wq)[..., None] * Jinv[:, :, d0, :])
            _, G, P = face_basis(dim, k, nq, S.p_degree, d0, side)
            uloc = uflat[:, torch.as_tensor(cdofs[cflat],
                                            device=S.device)]  # [c, Fg, A]
            ghat = torch.einsum("cfa,eaq->fceq", uloc, as_t(G))
            g = torch.einsum("fceq,fqed->fcdq", ghat, as_t(Jinv))
            pq = pflat[torch.as_tensor(cflat, device=S.device)] @ as_t(P)
            # tau_c = p n_c - nu sum_d (d_d u_c + d_c u_d) n_d, per point
            sym = g + g.transpose(1, 2)                  # [Fg, c, d, Q]
            tau = (pq[:, None, :] * wn.permute(0, 2, 1)
                   - nu * torch.einsum("fcdq,fqd->fcq", sym, wn))
            F = F + tau.sum(dim=(0, 2))
    return scale * F


def compute_drag_lift(S: StokesOperator, u, p, scale: float) -> torch.Tensor:
    """F = scale * sum over the obstacle faces of int [p n - nu (grad u +
    grad u^T) n], n outward from the fluid; the curved path on a mapped
    mesh (reference compute_drag_lift, operators.h:1344-1389).  u: [dim,
    *grid], p: [*cells, n_ploc]; returns [dim]."""
    if S.mesh.vertex_map is not None:
        return compute_drag_lift_mapped(S, u, p, scale)
    return _obstacle_traction(S, u, p, scale)


def compute_drag_lift_mapped(S: StokesOperator, u, p,
                             scale: float) -> torch.Tensor:
    """Drag/lift over the curved obstacle boundary of a vertex-mapped mesh
    (the DFG cylinder): the base grid's face quadrature pushed through the
    map, the weighted outward normal by Nanson's formula."""
    return _obstacle_traction(S, u, p, scale)


def compute_wall_force(S: StokesOperator, u, p, face,
                       scale: float = 1.0) -> torch.Tensor:
    """Traction integral over a domain-boundary plane (axis d0, side):
    F = scale * int_face [p n - nu (grad u + grad u^T) n], n outward
    (the lid-driven practical config reports the force on the moving
    wall, reference compute_drag_lift over a boundary id, operators.h:
    1344-1389).  Non-uniform steps are taken per cell; on a mapped mesh
    the faces need the map to be the identity on the outer boundary, as
    the operator checks.  u: [dim, *grid], p: [*cells, n_ploc]; returns
    [dim]."""
    d0, side = face
    mesh, dim, k, nq = S.mesh, S.dim, S.u_degree, S.n_q
    as_t = lambda a: torch.as_tensor(
        a if torch.is_tensor(a) else np.asarray(a), dtype=S.dtype,
        device=S.device)
    u, p = as_t(u), as_t(p)
    nu = S.viscosity
    qx, qw = gauss(nq)
    edge_x = 0.0 if side == 0 else 1.0
    n_sign = -1.0 if side == 0 else 1.0
    oth = [d for d in range(dim) if d != d0]
    cells_oth = tuple(S.cells[d] for d in oth)
    m = dim - 1
    eidx = 0 if side == 0 else -1
    n_dof = S.dof_shape_u[d0]
    start = 0 if side == 0 else n_dof - k - 1
    sd = shape_data_1d(k, nq)
    S1, D1 = as_t(sd.S), as_t(sd.D)
    h0 = float(mesh.steps(d0)[eidx])
    D1e = as_t(LagrangeBasis(np.asarray(q_nodes_1d(k))).deriv_matrix(
        np.array([edge_x]))[0] / h0)
    # grad[e][c] = d u_c / d x_e at the face quadrature points, every
    # component at once: [dim, *cells_oth, *q_oth] per direction e
    uf = u.select(1 + d0, eidx)                       # [dim, *dofs_oth]
    grad = [None] * dim
    grad[d0] = S._trace_eval(
        torch.movedim(u.narrow(1 + d0, start, k + 1), 1 + d0, -1) @ D1e,
        cells_oth)
    fc = cell_gather(uf, cells_oth, k)
    for i, e in enumerate(oth):
        if mesh.axis_steps is None:
            mats = [D1 / mesh.h[d] if d == e else S1 for d in oth]
            grad[e] = _sumfac(mats, fc, m)
        else:
            mats = [D1 if d == e else S1 for d in oth]
            shape = [1] * (2 * m)
            shape[i] = S.cells[e]
            grad[e] = _sumfac(mats, fc, m) * as_t(
                1.0 / mesh.steps(e)).reshape(shape)
    # modal pressure trace of the boundary cell layer
    exps = dgp_exponents(dim, S.p_degree)
    Pq = np.ones((len(exps),) + (nq,) * m)
    for j, ex in enumerate(exps):
        Pq[j] *= shifted_legendre_value(ex[d0], np.array([edge_x]))[0]
        for i, d in enumerate(oth):
            shape = [1] * m
            shape[i] = nq
            Pq[j] = Pq[j] * shifted_legendre_value(ex[d], qx).reshape(shape)
    p_b = p.select(d0, eidx)                          # [*cells_oth, n_ploc]
    pq = (p_b @ as_t(Pq.reshape(len(exps), -1))).reshape(
        cells_oth + (nq,) * m)
    if mesh.axis_steps is None:
        wq = np.ones((nq,) * m)
        for i, d in enumerate(oth):
            shape = [1] * m
            shape[i] = nq
            wq = wq * (qw * mesh.h[d]).reshape(shape)
    else:
        wq = np.ones(cells_oth + (nq,) * m)
        for i, d in enumerate(oth):
            shape = [1] * (2 * m)
            shape[i], shape[m + i] = S.cells[d], nq
            wq = wq * (mesh.steps(d)[:, None] * qw[None, :]).reshape(shape)
    # tau_c = -nu (d_{d0} u_c + d_c u_{d0}) n + delta_{c d0} p n
    tau = -nu * (grad[d0] + torch.stack([grad[c][d0] for c in range(dim)])
                 ) * n_sign
    tau[d0] = tau[d0] + pq * n_sign
    return scale * (as_t(wq) * tau).reshape(dim, -1).sum(-1)


def compute_divergence_norm(S: StokesOperator, u) -> torch.Tensor:
    """sqrt(int_Omega (div u)^2) over the active cells (reference
    operators.h:1391-1439), a 0-d tensor; u: [dim, *grid]."""
    dim, k = S.dim, S.u_degree
    u = torch.as_tensor(u, dtype=S.dtype, device=S.device)
    C = int(np.prod(S.cells))
    uc = cell_gather(u * S.mask_u, S.cells, k).reshape(dim, C, -1)
    g = S._grad_phys(uc)                          # [c, C, d, Q]
    div = torch.diagonal(g, dim1=0, dim2=2).sum(-1)   # [C, Q]
    return torch.sqrt(torch.sum(S._wq * div ** 2))

"""Surface and volume functionals of a Stokes field (counterpart of
stfem_tpu/ops/functionals.py::compute_wall_force and
compute_divergence_norm; reference StokesMatrixFreeOperator::
compute_drag_lift / compute_divergence, operators.h:1344-1439), on the
port's uniform Cartesian meshes.

Each returns a tensor on the field's device (a [dim] force, a 0-d norm),
so a caller gathers a whole row of functionals and reads it back once.
The obstacle drag/lift of the DFG channel is not ported."""
from __future__ import annotations

import numpy as np
import torch

from ..mesh.fe import q_nodes_1d, shape_data_1d
from ..mesh.fe_dgp import dgp_exponents, shifted_legendre_value
from ..time.quadrature import LagrangeBasis, gauss
from .spatial import _sumfac, cell_gather
from .stokes import StokesOperator

__all__ = ["compute_wall_force", "compute_divergence_norm"]


def compute_wall_force(S: StokesOperator, u, p, face,
                       scale: float = 1.0) -> torch.Tensor:
    """Traction integral over a domain-boundary plane (axis d0, side):
    F = scale * int_face [p n - nu (grad u + grad u^T) n], n outward
    (the lid-driven practical config reports the force on the moving
    wall, reference compute_drag_lift over a boundary id, operators.h:
    1344-1389).  u: [dim, *grid], p: [*cells, n_ploc]; returns [dim]."""
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
    D1e = as_t(LagrangeBasis(np.asarray(q_nodes_1d(k))).deriv_matrix(
        np.array([edge_x]))[0] / mesh.h[d0])
    # grad[e][c] = d u_c / d x_e at the face quadrature points, every
    # component at once: [dim, *cells_oth, *q_oth] per direction e
    uf = u.select(1 + d0, eidx)                       # [dim, *dofs_oth]
    grad = [None] * dim
    grad[d0] = S._trace_eval(
        torch.movedim(u.narrow(1 + d0, start, k + 1), 1 + d0, -1) @ D1e,
        cells_oth)
    fc = cell_gather(uf, cells_oth, k)
    for e in oth:
        mats = [D1 / mesh.h[d] if d == e else S1 for d in oth]
        grad[e] = _sumfac(mats, fc, m)
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
    wq = np.ones((nq,) * m)
    for i, d in enumerate(oth):
        shape = [1] * m
        shape[i] = nq
        wq = wq * (qw * mesh.h[d]).reshape(shape)
    # tau_c = -nu (d_{d0} u_c + d_c u_{d0}) n + delta_{c d0} p n
    tau = -nu * (grad[d0] + torch.stack([grad[c][d0] for c in range(dim)])
                 ) * n_sign
    tau[d0] = tau[d0] + pq * n_sign
    return scale * (as_t(wq) * tau).reshape(dim, -1).sum(-1)


def compute_divergence_norm(S: StokesOperator, u) -> torch.Tensor:
    """sqrt(int_Omega (div u)^2) (reference operators.h:1391-1439), a 0-d
    tensor; u: [dim, *grid]."""
    dim, k = S.dim, S.u_degree
    u = torch.as_tensor(u, dtype=S.dtype, device=S.device)
    C = int(np.prod(S.cells))
    uc = cell_gather(u * S.mask_u, S.cells, k).reshape(dim, C, -1)
    g = S._grad_phys(uc)                          # [c, C, d, Q]
    div = torch.diagonal(g, dim1=0, dim2=2).sum(-1)   # [C, Q]
    return torch.sqrt(torch.sum(S.jxw.reshape(-1) * div ** 2))

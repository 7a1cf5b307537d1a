"""Matrix-free Stokes saddle-point operator on structured meshes
(counterpart of stfem_tpu/ops/stokes.py::StokesOperator; the
DGP-pressure, uniform-mesh, strong-Dirichlet case).

Weak form per cell (reference include/operators.h:1525-1575):
  u-row:  nu (grad u, grad v) - (p, div v)
  p-row:  (div u, q)
Velocity: vector Q_k (component axis leading), pressure: modal DGP.  The
operator acts batched over arbitrary leading axes (time positions).

Flat packing: a Stokes space-time vector is [T, n_u + n_p] with
u = x[:, :n_u].reshape(T, dim, *dofgrid) and
p = x[:, n_u:].reshape(T, *cells, n_ploc).

The quadrature is stfem_tpu's (the same 1D shape data and Gauss rule);
the per-axis sum factorization becomes one matmul against the full-cell
basis gradients (A x dim*Q, 27 x 81 for Q2 with 3 points per axis), which
computes the same sums in fewer, larger launches.  Navier modes, Nitsche
faces, the obstacle, CIP, backflow, FE_Q pressure and mapped (jinv)
meshes are not ported.
"""
from __future__ import annotations

import numpy as np
import torch

from ..mesh.fe_dgp import dgp_values_at_tensor_gauss, n_dgp_dofs
from ..mesh.grid import StructuredMesh
from .spatial import LaplaceMassOperator, cell_gather, cell_scatter

__all__ = ["StokesOperator"]


class StokesOperator:
    def __init__(self, mesh: StructuredMesh, u_degree: int, p_degree: int,
                 n_q: int, viscosity: float = 1.0, dtype=torch.float64,
                 device="cuda"):
        self.mesh = mesh
        self.dim = dim = mesh.dim
        self.u_degree = u_degree
        self.p_degree = p_degree
        self.n_q = n_q
        self.viscosity = float(viscosity)
        self.dtype = dtype
        self.device = torch.device(device)
        self.cells = mesh.cells
        self.dof_shape_u = mesh.dof_shape(u_degree)
        self.n_ploc = n_dgp_dofs(dim, p_degree)
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                         device=self.device)
        geom = mesh.geometry(n_q)
        self.jxw = as_t(geom.jxw)
        self.jinv_diag = np.asarray(geom.jinv_diag, np.float64)
        self.mask_u_np = mesh.boundary_dof_mask(u_degree)
        self.mask_u = as_t(self.mask_u_np)
        # modal pressure basis at the tensor Gauss points (reference cell)
        self.Pq = as_t(dgp_values_at_tensor_gauss(dim, p_degree, n_q))
        self.n_u = dim * int(np.prod(self.dof_shape_u))
        self.n_p = int(np.prod(self.cells)) * self.n_ploc
        # full-cell basis gradients, physical (x jinv): G[a, e*Q + q]; and
        # the integration weights folded in for the transposed apply
        lap = LaplaceMassOperator(mesh, u_degree, n_q, 0.0, 1.0,
                                  dtype=torch.float64, device="cpu")
        _, grad = lap._basis_tensors()                      # [dim, A, Q]
        A, Q = grad.shape[1], grad.shape[2]
        gphys = grad * self.jinv_diag[:, None, None]
        self._G = as_t(np.transpose(gphys, (1, 0, 2)).reshape(A, dim * Q))
        w = np.asarray(geom.jxw, np.float64).reshape(1, 1, Q)
        gw = np.transpose(gphys * w, (0, 2, 1))             # [dim, Q, A]
        self._GW = as_t(gw.reshape(dim * Q, A))
        self._eye = torch.eye(dim, dtype=dtype, device=self.device).reshape(
            dim, 1, dim, 1)

    # -- packing ------------------------------------------------------------
    def pack(self, u: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
        lead = u.shape[:-self.dim - 1]
        return torch.cat([u.reshape(lead + (self.n_u,)),
                          p.reshape(lead + (self.n_p,))], dim=-1)

    def unpack(self, x: torch.Tensor):
        lead = x.shape[:-1]
        u = x[..., :self.n_u].reshape(lead + (self.dim,) + self.dof_shape_u)
        p = x[..., self.n_u:].reshape(lead + self.p_shape)
        return u, p

    @property
    def p_shape(self) -> tuple[int, ...]:
        """Per-block pressure shape [*cells, n_ploc] (DGP modal)."""
        return self.cells + (self.n_ploc,)

    @property
    def n_ploc_cell(self) -> int:
        return self.n_ploc

    def _p_basis_at_quad(self) -> torch.Tensor:
        """[n_ploc, Q] modal pressure basis at the tensor Gauss points."""
        return self.Pq.reshape(self.n_ploc, -1)

    def _p_at_quad(self, p: torch.Tensor) -> torch.Tensor:
        """[..., *cells, n_ploc] -> [..., C, Q]."""
        lead = p.shape[:-self.dim - 1]
        C = int(np.prod(self.cells))
        return p.reshape(lead + (C, self.n_ploc)) @ self._p_basis_at_quad()

    # -- gradients at the quadrature points ----------------------------------
    def _grad_phys(self, uc: torch.Tensor) -> torch.Tensor:
        """Cell-local values [..., C, A] -> physical gradients at the quad
        points [..., C, dim, Q]."""
        return (uc @ self._G).reshape(uc.shape[:-1] + (self.dim, -1))

    def _int_grad_phys(self, t: torch.Tensor) -> torch.Tensor:
        """[..., C, dim, Q] -> sum_d (d_d v, t[d]) against the cell-local
        test functions [..., C, A] (includes the jxw measure)."""
        return t.reshape(t.shape[:-2] + (-1,)) @ self._GW

    # -- apply --------------------------------------------------------------
    def apply(self, u: torch.Tensor, p: torch.Tensor):
        """(ru, rp); u: [..., dim, *dofgrid], p: [..., *cells, n_ploc]
        (mode "none": linear Stokes)."""
        dim, k = self.dim, self.u_degree
        C = int(np.prod(self.cells))
        lead = u.shape[:-dim - 1]
        uc = cell_gather(u * self.mask_u, self.cells, k).reshape(
            lead + (dim, C, -1))
        g = self._grad_phys(uc)                    # [..., c, C, d, Q]
        div = torch.diagonal(g, dim1=-4, dim2=-2).sum(-1)   # [..., C, Q]
        p_q = self._p_at_quad(p)                   # [..., C, Q]
        wq = self.jxw.reshape(-1)
        rp = ((div * wq) @ self._p_basis_at_quad().T).reshape(
            lead + self.p_shape)
        t = self.viscosity * g - self._eye * p_q.unsqueeze(-2).unsqueeze(-4)
        ru = self._int_grad_phys(t)                # [..., c, C, A]
        ru = cell_scatter(ru.reshape(lead + (dim,) + self.cells
                                     + (k + 1,) * dim), self.cells, k)
        return ru * self.mask_u, rp

    def apply_flat(self, x: torch.Tensor) -> torch.Tensor:
        u, p = self.unpack(x)
        ru, rp = self.apply(u, p)
        return self.pack(ru, rp)

    # -- element matrices for the Vanka patches -----------------------------
    def element_matrices(self):
        """(E_uu_scalar, E_up, E_pu): E_uu_scalar = nu-scaled scalar Laplace
        element matrices [C, A, A] (identical per component, Dirichlet rows/
        cols eliminated); E_up [C, dim*A, n_ploc] (u rows component-major):
        -int d_c phi_a psi_m; E_pu [C, n_ploc, dim*A]: +int psi_m d_c
        phi_a."""
        dim, k = self.dim, self.u_degree
        lap = LaplaceMassOperator(self.mesh, k, self.n_q, 0.0,
                                  self.viscosity, dtype=self.dtype,
                                  device=self.device)
        E_uu = lap.element_matrices()
        _, Grad = lap._basis_tensors()
        C = int(np.prod(self.cells))
        A = (k + 1) ** dim
        Q = self.n_q ** dim
        wq = torch.broadcast_to(self.jxw, self.cells + (self.n_q,) * dim
                                ).reshape(C, Q)
        Pq = self._p_basis_at_quad()
        parts = []
        for c in range(dim):
            Gc = torch.as_tensor(Grad[c], dtype=self.dtype,
                                 device=self.device)
            jf = float(self.jinv_diag[c])
            parts.append(-torch.einsum("cq,aq,mq->cam", wq * jf, Gc, Pq))
        E_up = torch.cat(parts, dim=1)
        mloc = cell_gather(self.mask_u, self.cells, k).reshape(C, A)
        E_up = E_up * torch.cat([mloc] * dim, dim=1)[:, :, None]
        E_pu = -E_up.transpose(1, 2)
        return E_uu, E_up, E_pu

"""Sum-factorized matrix-free spatial operators on structured meshes
(counterpart of stfem_tpu/ops/spatial.py).

The weak form  c_M (w u, v) + c_K (w grad u, grad v)  is applied to a
whole batch of space-time blocks at once as
    gather -> per-axis 1D interpolation matmuls -> quadrature scaling
    -> transposed matmuls -> overlap-add scatter.
The block axis is a leading batch dimension.  Dirichlet conditions are
elimination masks: apply = mask . A(mask . x).  An optional coefficient
field w, evaluated once per (cell, quadrature point), multiplies both
terms.  Only the uniform Cartesian geometry (diagonal Jacobian) is ported.
"""
from __future__ import annotations

import string

import numpy as np
import torch

from ..mesh.fe import shape_data_1d
from ..mesh.grid import StructuredMesh

__all__ = ["LaplaceMassOperator", "cell_gather", "cell_scatter", "overlap_add"]


def _axis_letters(dim):
    return string.ascii_lowercase[:dim], string.ascii_lowercase[13:13 + dim]


def cell_gather(x: torch.Tensor, cells: tuple[int, ...], k: int):
    """[..., *dofshape] -> [..., *cells, *(k+1)^dim] cell-local view."""
    dim = len(cells)
    lead = x.ndim - dim
    for d in range(dim):
        axis = lead + 2 * d
        nc = cells[d]
        idx = (np.arange(nc)[:, None] * k
               + np.arange(k + 1)[None, :]).reshape(-1)
        x = torch.index_select(x, axis, torch.as_tensor(idx,
                                                        device=x.device))
        x = x.reshape(x.shape[:axis] + (nc, k + 1) + x.shape[axis + 1:])
    perm = (list(range(lead))
            + [lead + 2 * d for d in range(dim)]
            + [lead + 2 * d + 1 for d in range(dim)])
    return x.permute(perm)


def cell_scatter(y: torch.Tensor, cells: tuple[int, ...], k: int):
    """Transpose of cell_gather: overlap-add [..., *cells, *(k+1)^dim] ->
    [..., *dofshape].  The shared node of two neighbouring cells is summed
    in a fixed order (no atomics), as in stfem_tpu."""
    dim = len(cells)
    lead = y.ndim - 2 * dim
    perm = list(range(lead))
    for d in range(dim):
        perm += [lead + d, lead + dim + d]
    y = y.permute(perm)
    for d in reversed(range(dim)):
        axis = lead + 2 * d
        nc = cells[d]
        moved = torch.movedim(y, (axis, axis + 1), (-2, -1))
        lead_shape = moved.shape[:-2]
        interior = moved[..., :, :k].reshape(lead_shape + (nc * k,))
        out = torch.nn.functional.pad(interior, (0, 1))
        last = moved[..., :, k:]                          # [..., nc, 1]
        seg = torch.nn.functional.pad(last, (0, k - 1))   # [..., nc, k]
        seg = torch.nn.functional.pad(seg, (0, 0, 1, 0))  # [..., nc+1, k]
        shared = seg.reshape(lead_shape + ((nc + 1) * k,))[..., :nc * k + 1]
        y = torch.movedim(out + shared, -1, axis)
    return y


def overlap_add(y: torch.Tensor, src: torch.Tensor, dim: int):
    """[..., N] -> [..., n]: each output entry sums the entries of y that
    src (flattened (n, 2, .., 2), N where there is none) lists for it,
    over the trailing two-entry axes from the last to the first: with
    utils/assembly.py::overlap_sources, cell_scatter's sums bitwise, in a
    gather, a pad and dim reductions."""
    yp = torch.nn.functional.pad(y, (0, 1))
    out = yp.index_select(-1, src).reshape(y.shape[:-1] + (-1,)
                                           + (2,) * dim)
    for _ in range(dim):
        out = out.sum(-1)
    return out


def _sumfac(mats, x, dim, forward=True):
    """Apply 1D matrices along the last `dim` axes.  forward: x[..., a1..ad]
    -> [..., q1..qd] with mats[d] of shape (q, a); else the transpose."""
    locs, quads = _axis_letters(dim)
    in_ax = locs if forward else quads
    out_ax = quads if forward else locs
    script = [f"{out_ax[d]}{in_ax[d]}" for d in range(dim)]
    operands = [m if forward else m.T for m in mats]
    ein = ",".join(script) + f",...{''.join(in_ax)}->...{''.join(out_ax)}"
    return torch.einsum(ein, *operands, x)


class LaplaceMassOperator:
    """c_M (w u, v) + c_K (w grad u, grad v) on Q_degree elements of a
    uniform Cartesian mesh, w = 1 or the coefficient field (a callable on
    [..., dim] points, reference include/operators.h:1060-1087); tensors
    live on `device` in `dtype`."""

    def __init__(self, mesh: StructuredMesh, degree: int, n_q: int,
                 mass_scaling: float, laplace_scaling: float,
                 dtype=torch.float64, device="cuda",
                 mask: np.ndarray | None = None, coefficient=None):
        self.mesh = mesh
        self.degree = degree
        self.n_q = n_q
        self.dim = mesh.dim
        self.cells = mesh.cells
        self.dof_shape = mesh.dof_shape(degree)
        self.mass_scaling = float(mass_scaling)
        self.laplace_scaling = float(laplace_scaling)
        self.dtype = dtype
        self.device = torch.device(device)
        sd = shape_data_1d(degree, n_q)
        self._sd = sd
        self.S = torch.as_tensor(sd.S, dtype=dtype, device=self.device)
        self.D = torch.as_tensor(sd.D, dtype=dtype, device=self.device)
        geom = mesh.geometry(n_q)
        self.jxw = torch.as_tensor(geom.jxw, dtype=dtype, device=self.device)
        jinv = torch.as_tensor(geom.jinv_diag, dtype=dtype,
                               device=self.device)
        self.jfac = [jinv[e] for e in range(self.dim)]
        if mask is None:
            mask = mesh.boundary_dof_mask(degree)
        self.mask_np = np.asarray(mask)
        self.mask = torch.as_tensor(self.mask_np, dtype=dtype,
                                    device=self.device)
        # the coefficient at the quadrature points, [*cells, *q] (float64
        # numpy, for the weight tables) and its tensor
        self.coefficient = coefficient
        self.coeff_np = self.coeff = None
        if coefficient is not None:
            self.coeff_np = np.asarray(
                coefficient(mesh.quad_coordinates(n_q)), np.float64)
            self.coeff = torch.as_tensor(self.coeff_np, dtype=dtype,
                                         device=self.device)
        self.w = self.jxw if self.coeff is None else self.jxw * self.coeff

    def weights_np(self) -> np.ndarray:
        """jxw times the coefficient in float64, broadcast to [*cells,
        *q]."""
        w = self.mesh.geometry(self.n_q).jxw
        if self.coeff_np is not None:
            w = w * self.coeff_np
        return np.broadcast_to(w, tuple(self.cells) + (self.n_q,) * self.dim)

    def apply(self, x: torch.Tensor, mask_input: bool = True):
        """y = mask . A (mask . x); x has shape [..., *dofshape].
        mask_input=False reads the constrained dofs too (the strong
        Dirichlet lift, drivers/stokes.py); the output stays masked."""
        cM, cK = self.mass_scaling, self.laplace_scaling
        dim, k = self.dim, self.degree
        u = cell_gather(x * self.mask if mask_input else x, self.cells, k)
        S, D, w = self.S, self.D, self.w
        acc = None
        if cM != 0.0:
            val = _sumfac([S] * dim, u, dim) * (cM * w)
            acc = _sumfac([S] * dim, val, dim, forward=False)
        if cK != 0.0:
            for e in range(dim):
                mats = [D if d == e else S for d in range(dim)]
                t = _sumfac(mats, u, dim) * (cK * w) * self.jfac[e] ** 2
                contrib = _sumfac(mats, t, dim, forward=False)
                acc = contrib if acc is None else acc + contrib
        return cell_scatter(acc, self.cells, k) * self.mask

    def _basis_tensors(self):
        """Full-cell basis arrays Phi[A, Q], GradHat[e, A, Q] (numpy)."""
        dim, k, nq = self.dim, self.degree, self.n_q
        S, D = self._sd.S, self._sd.D
        A, Q = (k + 1) ** dim, nq ** dim
        Phi = np.ones((A, Q))
        Grad = np.ones((dim, A, Q))
        a_idx = np.stack(np.meshgrid(*[np.arange(k + 1)] * dim,
                                     indexing="ij"), -1).reshape(A, dim)
        q_idx = np.stack(np.meshgrid(*[np.arange(nq)] * dim,
                                     indexing="ij"), -1).reshape(Q, dim)
        for d in range(dim):
            Phi *= S[q_idx[:, d][None, :], a_idx[:, d][:, None]]
            for e in range(dim):
                Grad[e] *= (D if d == e else S)[q_idx[:, d][None, :],
                                                a_idx[:, d][:, None]]
        return Phi, Grad

    def element_matrices(self, masked: bool = True) -> torch.Tensor:
        """Exact per-cell element matrices E[C, A, A] with Dirichlet rows
        and columns eliminated (zeroed) unless masked is False."""
        dim, k = self.dim, self.degree
        Phi, Grad = self._basis_tensors()
        Phi = torch.as_tensor(Phi, dtype=self.dtype, device=self.device)
        Grad = torch.as_tensor(Grad, dtype=self.dtype, device=self.device)
        C = self.mesh.n_cells
        Q = self.n_q ** dim
        wq = torch.broadcast_to(self.w, self.cells + (self.n_q,) * dim
                                ).reshape(C, Q)
        cM, cK = self.mass_scaling, self.laplace_scaling
        A = (k + 1) ** dim
        E = torch.zeros((C, A, A), dtype=self.dtype, device=self.device)
        if cM != 0.0:
            E = E + cM * torch.einsum("cq,aq,bq->cab", wq, Phi, Phi)
        if cK != 0.0:
            for e in range(dim):
                E = E + cK * torch.einsum("cq,aq,bq->cab",
                                          wq * self.jfac[e] ** 2,
                                          Grad[e], Grad[e])
        if not masked:
            return E
        mloc = cell_gather(self.mask, self.cells, k).reshape(C, -1)
        return E * mloc[:, :, None] * mloc[:, None, :]

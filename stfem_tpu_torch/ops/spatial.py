"""Sum-factorized matrix-free spatial operators on structured meshes
(counterpart of stfem_tpu/ops/spatial.py).

The weak form  c_M (w u, v) + c_K (w grad u, grad v)  is applied to a
whole batch of space-time blocks at once as
    gather -> per-axis 1D interpolation matmuls -> quadrature scaling
    -> transposed matmuls -> overlap-add scatter.
The block axis is a leading batch dimension.  Dirichlet conditions are
elimination masks: apply = mask . A(mask . x).  An optional coefficient
field w, evaluated once per (cell, quadrature point), multiplies both
terms.  The geometry follows stfem_tpu's three cases: one diagonal
Jacobian for every cell (uniform, also with a cell mask), per-axis
per-cell inverse steps (a non-uniform tensor grid), or full inverse
Jacobians per (cell, quadrature point) (an exact vertex map).
"""
from __future__ import annotations

import string

import numpy as np
import torch

from ..mesh.fe import shape_data_1d
from ..mesh.grid import StructuredMesh

__all__ = ["LaplaceMassOperator", "basis_tensors", "cell_gather",
           "cell_scatter", "geometry_factors", "inverse_steps",
           "layer_sum", "overlap_add"]


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


def layer_sum(parts, table: torch.Tensor):
    """Owner-computes sum over cell layers: parts are per-layer tensors
    [C_l, ...], table utils/assembly.py::layer_sources's; the result holds
    each listed cell's contributions added one after the other in layer
    order (a gather and n_max - 1 adds, no scatter-add)."""
    cat = torch.cat(list(parts) + [parts[0].new_zeros((1,)
                                                      + parts[0].shape[1:])])
    g = cat[table]
    acc = g[:, 0]
    for i in range(1, g.shape[1]):
        acc = acc + g[:, i]
    return acc


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


def inverse_steps(geom, cells):
    """The float64 inverse step along each axis e of a diagonal-Jacobian
    Geometry: a 0-d array (uniform, also masked) or [1.., cells[e], ..1]
    broadcastable against [*cells, *q] (axis steps); None for a mapped or
    Q1 geometry (full inverse Jacobians)."""
    dim = len(cells)
    if geom.jinv is not None:
        return None
    if geom.jinv_axis is not None:
        out = []
        for e in range(dim):
            shape = [1] * (2 * dim)
            shape[e] = cells[e]
            out.append(np.asarray(geom.jinv_axis[e],
                                  np.float64).reshape(shape))
        return out
    return [np.asarray(geom.jinv_diag[e], np.float64) for e in range(dim)]


def geometry_factors(geom, cells, dtype, device):
    """(jfac, jinv) of a Geometry as tensors: jfac[e] the inverse step
    along axis e (inverse_steps) and None, or None and the inverse
    Jacobians [*cells, *q, dim, dim] (mapped or Q1)."""
    as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                     device=device)
    if geom.jinv is not None:
        return None, as_t(geom.jinv)
    return [as_t(j) for j in inverse_steps(geom, cells)], None


def basis_tensors(dim: int, k: int, nq: int):
    """Full-cell Q_k basis arrays at the tensor Gauss points: values
    Phi[A, Q] and reference gradients GradHat[e, A, Q] (numpy)."""
    sd = shape_data_1d(k, nq)
    S, D = sd.S, sd.D
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


class LaplaceMassOperator:
    """c_M (w u, v) + c_K (w grad u, grad v) on Q_degree elements of a
    structured mesh, w = 1 or the coefficient field (a callable on
    [..., dim] points, reference include/operators.h:1060-1087); tensors
    live on `device` in `dtype`.  jfac[e] is the inverse step along axis
    e (a scalar, or per cell broadcastable against [*cells, *q]); jinv
    the full inverse Jacobians of a mapped mesh (then jfac is None)."""

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
        self._set_geometry(mesh.geometry(n_q))

    def _set_geometry(self, geom):
        """The quadrature weights jxw, the inverse-Jacobian factors (see
        geometry_factors) and the folded weights w of a Geometry."""
        self.geom = geom
        self.jxw = torch.as_tensor(geom.jxw, dtype=self.dtype,
                                   device=self.device)
        self.jfac, self.jinv = geometry_factors(geom, self.cells, self.dtype,
                                                self.device)
        self.w = self.jxw if self.coeff is None else self.jxw * self.coeff

    def weights_np(self) -> np.ndarray:
        """jxw times the coefficient in float64, broadcast to [*cells,
        *q]."""
        w = self.geom.jxw
        if self.coeff_np is not None:
            w = w * self.coeff_np
        return np.broadcast_to(w, tuple(self.cells) + (self.n_q,) * self.dim)

    def stiffness_weights_np(self) -> list[np.ndarray]:
        """Per direction e, weights_np() times the square of the inverse
        step along e, cell by cell (stfem_tpu's w * jfac[e]^2), float64
        [*cells, *q]; diagonal-Jacobian geometries only."""
        steps = inverse_steps(self.geom, self.cells)
        if steps is None:
            raise ValueError("full inverse Jacobians: no per-axis weights")
        w = self.weights_np()
        return [w * j ** 2 for j in steps]

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
        if cK != 0.0 and self.jinv is None:
            for e in range(dim):
                mats = [D if d == e else S for d in range(dim)]
                t = _sumfac(mats, u, dim) * (cK * w) * self.jfac[e] ** 2
                contrib = _sumfac(mats, t, dim, forward=False)
                acc = contrib if acc is None else acc + contrib
        elif cK != 0.0:
            ji = self.jinv                               # [*cells, *q, e, d]
            mats = [[D if d == e else S for d in range(dim)]
                    for e in range(dim)]
            ghat = [_sumfac(mats[e], u, dim) for e in range(dim)]
            gphys = [sum(ghat[e] * ji[..., e, d] for e in range(dim))
                     * (cK * w) for d in range(dim)]
            for e in range(dim):
                t = sum(gphys[d] * ji[..., e, d] for d in range(dim))
                contrib = _sumfac(mats[e], t, dim, forward=False)
                acc = contrib if acc is None else acc + contrib
        return cell_scatter(acc, self.cells, k) * self.mask

    def vmult(self, x: torch.Tensor, mask_input: bool = True):
        """apply under the reference's name."""
        return self.apply(x, mask_input)

    def element_matrices(self, masked: bool = True) -> torch.Tensor:
        """Exact per-cell element matrices E[C, A, A] with Dirichlet rows
        and columns eliminated (zeroed) unless masked is False."""
        dim, k = self.dim, self.degree
        Phi, Grad = basis_tensors(dim, k, self.n_q)
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
        if cK != 0.0 and self.jinv is None:
            for e in range(dim):
                sfac = torch.broadcast_to(self.jfac[e] ** 2, self.cells
                                          + (1,) * dim).reshape(C, 1)
                E = E + cK * torch.einsum("cq,aq,bq->cab", wq * sfac,
                                          Grad[e], Grad[e])
        elif cK != 0.0:
            gphys = torch.einsum("cqed,eaq->cdaq",
                                 self.jinv.reshape(C, Q, dim, dim), Grad)
            E = E + cK * torch.einsum("cq,cdaq,cdbq->cab", wq, gphys, gphys)
        if not masked:
            return E
        mloc = cell_gather(self.mask, self.cells, k).reshape(C, -1)
        return E * mloc[:, :, None] * mloc[:, None, :]

    def diagonal(self) -> torch.Tensor:
        """The assembled matrix's diagonal on the dof grid: each element
        matrix's diagonal, overlap-added; constrained dofs get 1
        (reference include/operators.h:1092-1110)."""
        k, dim = self.degree, self.dim
        ediag = self.element_matrices().diagonal(dim1=1, dim2=2)
        d = cell_scatter(ediag.reshape(tuple(self.cells) + (k + 1,) * dim),
                         self.cells, k)
        return d * self.mask + (1.0 - self.mask)

"""Space-time slab system operator (Alpha (x) K + Beta (x) M) x
(counterpart of stfem_tpu/system.py::SystemMatrix).

The block vector is one dense tensor [n_blocks, *dofshape].  Four routes,
chosen in stfem_tpu's order (the order it ran on its accelerator):
  "kron"  when the geometry separates (KronAssembled.supports: diagonal
          Jacobians, no coefficient, cell mask or explicit vertices): one
          Kronecker pair (K x, M x) over the whole batch, then the small
          Alpha/Beta mixing matrices over the block axis;
  "cell"  when the mesh has full inverse Jacobians (distorted, Q1-mapped
          or exactly mapped; stfem_tpu/system.py:323-348): one gather of
          every cell's dofs, the Alpha/Beta premix over the block axis,
          the values and reference gradients at the quadrature points by
          one full-cell-basis product each, the mass weights and the
          per-point metric w J^-1 J^-T, the transposed products, and the
          overlap-add -- plain torch ops, as stfem_tpu leaves this route
          to XLA (it sum-factorises; the full-cell basis takes ~10 launches
          an apply where sum factorisation takes ~150, and the V-cycle on
          a distorted mesh is bound by launches);
  "quad"  otherwise for a float64 operator (stfem_tpu's route 3, which its
          emulated-FP64 operators took): cell_gather, the Alpha/Beta premix
          as one dense matmul over the block axis, the full-cell-basis
          quadrature middle (kernel K5, ops/quad_middle.py), cell_scatter;
  "grid"  otherwise (float32/bf16 levels): ops/gridsumfac.py's per-axis
          global matmuls with the mixing at the quadrature level.
"quad" and "grid" weight each direction by the cell's inverse step
squared, so stepped and masked meshes take them as they are.  A route may
also be asked for by name (the tests; chip_smoke.py's independent FP64
residual check); "kron", "quad" and "grid" raise on full inverse
Jacobians.
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.gridsumfac import GridSumFac, promote
from .ops.kronfac import KronAssembled
from .ops.quad_middle import quad_middle
from .ops.spatial import (LaplaceMassOperator, basis_tensors, cell_gather,
                          cell_scatter, overlap_add)
from .utils.assembly import cell_dof_indices, overlap_sources
from .utils.precision import full_precision

ROUTES = ("kron", "cell", "quad", "grid")


class SystemMatrix:
    """dst = (Alpha (x) K + Beta (x) M) src for a stiffness operator K
    (laplace_scaling=1, mass_scaling=0) and a mass operator M (1, 0) on one
    mesh.  Alpha/Beta are (n_blocks, n_blocks) for the LHS or (n_blocks, 1)
    columns for the previous-slab rhs coupling (vmult_slice).

    precision="highest" (the outer operator and the rhs coupling) runs every
    apply under utils.precision.full_precision: never TF32.  Level
    operators inside the preconditioner pass precision=None.  route: one
    of ROUTES, or None for stfem_tpu's choice (module docstring)."""

    def __init__(self, K_op: LaplaceMassOperator, M_op: LaplaceMassOperator,
                 Alpha, Beta, precision: str | None = "highest",
                 route: str | None = None):
        assert K_op.mesh is M_op.mesh and K_op.degree == M_op.degree
        self.K, self.M = K_op, M_op
        self.precision = precision
        self.dtype, self.device = K_op.dtype, K_op.device
        A_np, B_np = np.asarray(Alpha), np.asarray(Beta)
        self.Alpha = torch.as_tensor(A_np, dtype=self.dtype,
                                     device=self.device)
        self.Beta = torch.as_tensor(B_np, dtype=self.dtype,
                                    device=self.device)
        self.alpha_is_zero = bool(np.all(A_np == 0.0))
        self.beta_is_zero = bool(np.all(B_np == 0.0))
        self.n_blocks = A_np.shape[0]

        # previous-slab coupling columns feed only the first step's rows:
        # apply the slice to the nonzero rows only
        self._slice_reduced = None
        self._slice_nz = None
        if A_np.ndim == 2 and A_np.shape[1] == 1:
            nz = np.where((np.abs(A_np) + np.abs(B_np)).sum(1) != 0.0)[0]
            if 0 < len(nz) <= self.n_blocks // 2:
                self._slice_nz = tuple(int(i) for i in nz)
                self._slice_reduced = SystemMatrix(
                    K_op, M_op, A_np[nz], B_np[nz],
                    precision="highest" if precision is not None else None,
                    route=route)

        if route is None:
            route = ("kron" if KronAssembled.supports(K_op, M_op)
                     else "cell" if K_op.jinv is not None
                     else "quad" if self.dtype == torch.float64 else "grid")
        if route not in ROUTES:
            raise ValueError(f"SystemMatrix: unknown route {route!r}")
        if route != "cell" and K_op.jinv is not None:
            raise ValueError(f"SystemMatrix: route {route!r} takes "
                             "diagonal Jacobians only")
        self.route = route
        self._kron = self._grid = None
        if route == "kron":
            self._kron = KronAssembled(K_op, M_op, self.dtype)
        elif route == "grid":
            self._grid = GridSumFac(K_op, M_op, self.dtype)
        elif route == "quad":
            self._phig, self._phigT, self._w = self._quad_tables(K_op, M_op)
        else:
            self._cell_tables(K_op, M_op)

    def _quad_tables(self, K_op, M_op):
        """Route "quad"'s PhiG (A, (1+dim)Q), its transpose, and W (C,
        (1+dim)Q): the mass weights, then the stiffness weights with each
        direction's per-cell inverse step squared (stfem_tpu
        system.py:137-157)."""
        dim, C = K_op.dim, K_op.mesh.n_cells
        Q = K_op.n_q ** dim
        Phi, Grad = basis_tensors(K_op.dim, K_op.degree, K_op.n_q)
        PhiG = np.concatenate([Phi] + [Grad[e] for e in range(dim)], axis=1)
        W = np.concatenate([M_op.weights_np().reshape(C, Q)]
                           + [w.reshape(C, Q)
                              for w in K_op.stiffness_weights_np()], axis=1)
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                         dtype=self.dtype, device=self.device)
        return as_t(PhiG), as_t(PhiG.T), as_t(W)

    def _cell_tables(self, K_op, M_op):
        """Route "cell"'s tables: the full-cell basis values Phi (A, Q) and
        reference gradients Grad (A, dim Q) with their transposes, the
        mass weights wM (C, Q), the metric G (C, dim, dim, Q) = w J^-1
        J^-T per quadrature point (stiffness weights w), and the gather
        and overlap-add index maps."""
        dim, k, C = K_op.dim, K_op.degree, K_op.mesh.n_cells
        Q = K_op.n_q ** dim
        Phi, Grad = basis_tensors(dim, k, K_op.n_q)
        GradCat = np.concatenate(list(Grad), axis=1)
        ji = np.asarray(K_op.geom.jinv, np.float64).reshape(C, Q, dim, dim)
        wK = K_op.weights_np().reshape(C, Q)
        G = np.einsum("cqed,cqfd->cefq", ji, ji) * wK[:, None, None, :]
        as_t = lambda a: torch.as_tensor(np.array(a, np.float64),
                                         dtype=self.dtype, device=self.device)
        self._phi, self._phiT = as_t(Phi), as_t(Phi.T)
        self._grad, self._gradT = as_t(GradCat), as_t(GradCat.T)
        self._wM = as_t(M_op.weights_np().reshape(C, Q))
        self._G = as_t(G)
        ix = lambda a: torch.as_tensor(a.reshape(-1), device=self.device)
        self._idx = ix(cell_dof_indices(K_op.cells, k))
        self._src = ix(overlap_sources(K_op.cells, k))

    @staticmethod
    def _detect_step_structure(Anp, Bnp):
        """Smallest nt such that BOTH tables are block-bidiagonal in
        (nt x nt) blocks with identical diagonal / sub-diagonal blocks.
        Returns (nt, A0, A1, B0, B1) or None."""
        n = Anp.shape[0]
        if Anp.shape != (n, n) or Bnp.shape != (n, n):
            return None
        for nt in range(1, n // 2 + 1):
            if n % nt:
                continue
            s = n // nt
            if s < 2:
                break
            A0, B0 = Anp[:nt, :nt], Bnp[:nt, :nt]
            A1, B1 = Anp[nt:2 * nt, :nt], Bnp[nt:2 * nt, :nt]
            ok = True
            for i in range(s):
                for j in range(s):
                    ba = Anp[i * nt:(i + 1) * nt, j * nt:(j + 1) * nt]
                    bb = Bnp[i * nt:(i + 1) * nt, j * nt:(j + 1) * nt]
                    if i == j:
                        ok = (np.array_equal(ba, A0)
                              and np.array_equal(bb, B0))
                    elif i == j + 1:
                        ok = (np.array_equal(ba, A1)
                              and np.array_equal(bb, B1))
                    else:
                        ok = not (np.any(ba != 0.0) or np.any(bb != 0.0))
                    if not ok:
                        break
                if not ok:
                    break
            if ok:
                return nt, A0, A1, B0, B1
        return None

    def _mix(self, table: torch.Tensor, x: torch.Tensor):
        """y_j = sum_i T[j, i] x_i over the leading block axis."""
        table, x = promote(table, x)
        return torch.einsum("ji,i...->j...", table, x)

    def _apply(self, x: torch.Tensor, mask_input: bool = True):
        if self.precision is not None:
            with full_precision():
                return self._apply_impl(x, mask_input)
        return self._apply_impl(x, mask_input)

    def _masked(self, x, mask_input: bool):
        """x with its constrained dofs zeroed, or as it is (the strong
        Dirichlet lift reads them, stfem_tpu system.py:239-352)."""
        return x * self.K.mask if mask_input else x

    def _apply_impl(self, x, mask_input=True):
        if self.route == "grid":
            y = self._grid.apply(self._masked(x, mask_input),
                                 lambda v: self._mix(self.Alpha, v),
                                 lambda v: self._mix(self.Beta, v),
                                 self.alpha_is_zero, self.beta_is_zero)
            return self._zeros(x) if y is None else y * self.K.mask
        if self.route == "quad":
            return self._apply_quad(x, mask_input)
        if self.route == "cell":
            return self._apply_cell(x, mask_input)
        K, M = self.K, self.M
        xin = self._masked(x, mask_input)
        cKK, cKM = K.laplace_scaling, K.mass_scaling
        cMK, cMM = M.laplace_scaling, M.mass_scaling
        az, bz = self.alpha_is_zero, self.beta_is_zero
        need_K = (not az and cKK != 0.0) or (not bz and cMK != 0.0)
        need_M = (not az and cKM != 0.0) or (not bz and cMM != 0.0)
        Kx, Mx = self._kron.pair(xin, need_K, need_M)

        def comb(cK_, cM_):
            t = None
            if cK_ != 0.0:
                t = Kx if cK_ == 1.0 else cK_ * Kx
            if cM_ != 0.0:
                tm = Mx if cM_ == 1.0 else cM_ * Mx
                t = tm if t is None else t + tm
            return t

        y = None
        if not az:
            t = comb(cKK, cKM)
            if t is not None:
                y = self._mix(self.Alpha, t)
        if not bz:
            t = comb(cMK, cMM)
            if t is not None:
                tb = self._mix(self.Beta, t)
                y = tb if y is None else y + tb
        if y is None:
            return self._zeros(x)
        return y * K.mask

    def _zeros(self, x):
        return torch.zeros((self.n_blocks,) + x.shape[1:], dtype=self.dtype,
                           device=self.device)

    def _apply_cell(self, x, mask_input=True):
        """Route "cell": stiffness K_op (laplace 1, mass 0) and mass M_op
        (1, 0) with their weights (jxw times the coefficient); x: [n_src,
        ..., *dofshape]."""
        K = self.K
        dim = K.dim
        lead = x.shape[:x.ndim - dim]
        C, A = self._wM.shape[0], self._phi.shape[0]
        u = self._masked(x, mask_input).reshape(lead + (-1,)).index_select(
            -1, self._idx).reshape(lead + (C, A))
        acc = None
        if not self.beta_is_zero:
            ub, phi = promote(self._mix(self.Beta, u), self._phi)
            acc = ((ub @ phi) * self._wM) @ self._phiT
        if not self.alpha_is_zero:
            ua, grad = promote(self._mix(self.Alpha, u), self._grad)
            g = ua @ grad                                  # [..., C, dim Q]
            g = g.reshape(g.shape[:-1] + (dim, -1))        # [..., C, f, Q]
            t = (self._G * g.unsqueeze(-3)).sum(-2)        # [..., C, e, Q]
            t = t.reshape(t.shape[:-2] + (-1,)) @ self._gradT
            acc = t if acc is None else acc + t
        if acc is None:
            return self._zeros(x)
        y = overlap_add(acc.reshape(acc.shape[:-2] + (-1,)), self._src, dim)
        return y.reshape(acc.shape[:-2] + tuple(K.dof_shape)) * K.mask

    def _apply_quad(self, x, mask_input=True):
        """cell_gather -> premix -> K5 -> cell_scatter -> mask."""
        K = self.K
        cells, k, dim = K.cells, K.degree, K.dim
        if x.ndim != dim + 1:
            raise ValueError("route quad takes [n_blocks, *dofshape]")
        u = cell_gather(self._masked(x, mask_input), cells, k).reshape(
            x.shape[0], K.mesh.n_cells, (k + 1) ** dim)
        ub = self._mix(self.Beta, u).contiguous()
        ua = self._mix(self.Alpha, u).contiguous()
        y = quad_middle(ub, ua, self._phig, self._w, K.n_q ** dim,
                        self._phigT)
        y = y.reshape((y.shape[0],) + tuple(cells) + (k + 1,) * dim)
        return cell_scatter(y, cells, k) * K.mask

    def vmult(self, x: torch.Tensor, mask_input: bool = True):
        """x: [n_src_blocks, ..., *dofshape] -> [n_blocks, ..., *dofshape]
        (extra axes between the block axis and the dof grid are batch).
        mask_input=False reads the constrained dofs of x too (the strong
        Dirichlet lift rhs -= A x_g); the output rows stay masked on every
        route."""
        if self._slice_reduced is not None and x.shape[0] == 1:
            return self.vmult_slice(x[0], mask_input)
        return self._apply(x, mask_input)

    def vmult_slice(self, prev: torch.Tensor, mask_input: bool = True):
        """RHS assembly: dst_j = Alpha[j,0] K prev + Beta[j,0] M prev
        (reference vmult_slice_add, include/operators.h:585-611)."""
        if self._slice_reduced is not None:
            y = self._slice_reduced.vmult_slice(prev, mask_input)
            out = torch.zeros((self.n_blocks,) + y.shape[1:], dtype=y.dtype,
                              device=y.device)
            out[list(self._slice_nz)] = y
            return out
        return self._apply(prev[None], mask_input)

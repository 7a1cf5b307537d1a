"""Space-time slab system operator (Alpha (x) K + Beta (x) M) x
(counterpart of stfem_tpu/system.py::SystemMatrix).

The block vector is one dense tensor [n_blocks, *dofshape].  Three routes,
chosen in stfem_tpu's order (the order it ran on its accelerator):
  "kron"  when the geometry separates (KronAssembled.supports: no
          coefficient): one Kronecker pair (K x, M x) over the whole batch,
          then the small Alpha/Beta mixing matrices over the block axis;
  "quad"  otherwise for a float64 operator (stfem_tpu's route 3, which its
          emulated-FP64 operators took): cell_gather, the Alpha/Beta premix
          as one dense matmul over the block axis, the full-cell-basis
          quadrature middle (kernel K5, ops/quad_middle.py), cell_scatter;
  "grid"  otherwise (float32/bf16 levels): ops/gridsumfac.py's per-axis
          global matmuls with the mixing at the quadrature level.
A route may also be asked for by name (the tests; chip_smoke.py's
independent FP64 residual check).
"""
from __future__ import annotations

import numpy as np
import torch

from .ops.gridsumfac import GridSumFac, promote
from .ops.kronfac import KronAssembled
from .ops.quad_middle import quad_middle
from .ops.spatial import (LaplaceMassOperator, basis_tensors, cell_gather,
                          cell_scatter)
from .utils.precision import full_precision

ROUTES = ("kron", "quad", "grid")


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
                     else "quad" if self.dtype == torch.float64 else "grid")
        if route not in ROUTES:
            raise ValueError(f"SystemMatrix: unknown route {route!r}")
        self.route = route
        self._kron = self._grid = None
        if route == "kron":
            self._kron = KronAssembled(K_op, M_op, self.dtype)
        elif route == "grid":
            self._grid = GridSumFac(K_op, M_op, self.dtype)
        else:
            self._phig, self._phigT, self._w = self._quad_tables(K_op, M_op)

    def _quad_tables(self, K_op, M_op):
        """Route "quad"'s PhiG (A, (1+dim)Q), its transpose, and W (C,
        (1+dim)Q): the mass weights, then the stiffness weights with each
        direction's inverse-Jacobian square (stfem_tpu system.py:137-157)."""
        dim, C = K_op.dim, K_op.mesh.n_cells
        Q = K_op.n_q ** dim
        Phi, Grad = basis_tensors(K_op.dim, K_op.degree, K_op.n_q)
        PhiG = np.concatenate([Phi] + [Grad[e] for e in range(dim)], axis=1)
        wK = K_op.weights_np().reshape(C, Q)
        jinv = 1.0 / K_op.mesh.h
        W = np.concatenate([M_op.weights_np().reshape(C, Q)]
                           + [wK * jinv[e] ** 2 for e in range(dim)], axis=1)
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                         dtype=self.dtype, device=self.device)
        return as_t(PhiG), as_t(PhiG.T), as_t(W)

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

    def _apply(self, x: torch.Tensor):
        if self.precision is not None:
            with full_precision():
                return self._apply_impl(x)
        return self._apply_impl(x)

    def _apply_impl(self, x):
        if self.route == "grid":
            y = self._grid.apply(x * self.K.mask,
                                 lambda v: self._mix(self.Alpha, v),
                                 lambda v: self._mix(self.Beta, v),
                                 self.alpha_is_zero, self.beta_is_zero)
            return self._zeros(x) if y is None else y * self.K.mask
        if self.route == "quad":
            return self._apply_quad(x)
        K, M = self.K, self.M
        xin = x * K.mask
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

    def _apply_quad(self, x):
        """cell_gather -> premix -> K5 -> cell_scatter -> mask."""
        K = self.K
        cells, k, dim = K.cells, K.degree, K.dim
        if x.ndim != dim + 1:
            raise ValueError("route quad takes [n_blocks, *dofshape]")
        u = cell_gather(x * K.mask, cells, k).reshape(
            x.shape[0], K.mesh.n_cells, (k + 1) ** dim)
        ub = self._mix(self.Beta, u).contiguous()
        ua = self._mix(self.Alpha, u).contiguous()
        y = quad_middle(ub, ua, self._phig, self._w, K.n_q ** dim,
                        self._phigT)
        y = y.reshape((y.shape[0],) + tuple(cells) + (k + 1,) * dim)
        return cell_scatter(y, cells, k) * K.mask

    def vmult(self, x: torch.Tensor):
        """x: [n_src_blocks, ..., *dofshape] -> [n_blocks, ..., *dofshape]
        (extra axes between the block axis and the dof grid are batch)."""
        if self._slice_reduced is not None and x.shape[0] == 1:
            return self.vmult_slice(x[0])
        return self._apply(x)

    def vmult_slice(self, prev: torch.Tensor):
        """RHS assembly: dst_j = Alpha[j,0] K prev + Beta[j,0] M prev
        (reference vmult_slice_add, include/operators.h:585-611)."""
        if self._slice_reduced is not None:
            y = self._slice_reduced.vmult_slice(prev)
            out = torch.zeros((self.n_blocks,) + y.shape[1:], dtype=y.dtype,
                              device=y.device)
            out[list(self._slice_nz)] = y
            return out
        return self._apply(prev[None])

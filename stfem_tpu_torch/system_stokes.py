"""Space-time Stokes slab system on the flat [T, n_u+n_p] layout
(counterpart of stfem_tpu/system_stokes.py::StokesSystemMatrix; the
reference's SystemMatrixStokes::tensorproduct_eval,
include/operators.h:819-867): the Stokes operator is applied once per
time position and the tiny scalar time tables mix over the time axis:
  dst_u[t'] = sum_t a[t',t] S_u(x[t]) + b[t',t] M u[t]
  dst_p[t'] = sum_t a[t',t] S_p(x[t])
The rhs slice coupling uses the gamma/zeta columns (CGP also couples the
pressure row through gamma; DG does not).
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh.grid import StructuredMesh
from .ops.spatial import LaplaceMassOperator, layer_sum, overlap_add
from .ops.stokes import StokesOperator
from .types import TimeStepType
from .utils.assembly import layer_sources
from .utils.precision import full_precision


class StokesSystemMatrix:
    """precision="highest" (the outer operator and the rhs coupling) runs
    every apply under utils.precision.full_precision: never TF32 (the
    round-5 rhs lesson of stfem_tpu, system_stokes.py:81-102).  Level
    operators inside the preconditioner pass precision=None.

    route "sumfac": the Stokes operator's and the mass operator's own
    applies, as stfem_tpu computes them.  route "element" (vmult only):
    one gather of every cell's local (u, p) vector from the flat layout,
    one matmul with the cell's element matrices (the Stokes and velocity
    mass matrices side by side: one pair for a uniform mesh, one per cell
    otherwise, a batched matmul), the time mixing, the Nitsche face
    cells' and the weak obstacle's cells' own matrices (each face cell's
    summed over its faces at setup), and the overlap-add back (in
    cell_scatter's order): the same operator to rounding, in ~15 launches
    where the sum-factorised applies take ~230 (~380 with Nitsche faces),
    for the host-bound V-cycle's level operators."""

    def __init__(self, stokes_op: StokesOperator,
                 mass_op: LaplaceMassOperator, a, b, gamma=None, zeta=None,
                 type_: TimeStepType = TimeStepType.DG,
                 precision: str | None = "highest", route: str = "sumfac"):
        if route not in ("sumfac", "element"):
            raise ValueError(f"route {route!r}")
        self.S, self.M = stokes_op, mass_op
        self.precision = precision
        self.dtype, self.device = stokes_op.dtype, stokes_op.device
        as_t = lambda t: torch.as_tensor(np.asarray(t), dtype=self.dtype,
                                         device=self.device)
        self.a, self.b = as_t(a), as_t(b)
        self.gamma = None if gamma is None else as_t(gamma)
        self.zeta = None if zeta is None else as_t(zeta)
        self.gamma_nonzero = gamma is not None and bool(np.any(
            np.asarray(gamma) != 0.0))
        self.zeta_nonzero = zeta is not None and bool(np.any(
            np.asarray(zeta) != 0.0))
        self.type_ = type_
        self.T = self.a.shape[0]
        self.n_flat = stokes_op.n_u + stokes_op.n_p
        self.route = route
        if route == "element":
            self._element_setup()

    def _element_setup(self):
        """Element matrices, the cell-local masks and index maps of the
        element route.  On a uniform mesh the unmasked Stokes and velocity
        mass matrices of one of its cells, in float64 and then the
        operator's dtype, stand for every cell ([P, 2P]); otherwise (a
        cell mask, axis steps or a vertex map) every cell has its own
        ([C, P, 2P], built in float64 on the operator's device).  _mloc
        masks."""
        S, M = self.S, self.M
        if M.coefficient is not None or not np.array_equal(M.mask_np,
                                                           S.mask_u_np):
            raise ValueError("the element route needs a mass operator "
                             "without coefficient on the Stokes mask")
        dim, A = S.dim, (S.u_degree + 1) ** S.dim
        P = dim * A + S.n_ploc
        if S.mesh.uniform:
            lo = np.asarray(S.mesh.lower, np.float64)
            mesh = StructuredMesh([1] * dim, lo, lo + np.asarray(S.mesh.h))
            dev = torch.device("cpu")
        else:
            mesh, dev = S.mesh, self.device
        S1 = StokesOperator(mesh, S.u_degree, S.p_degree, S.n_q,
                            S.viscosity, device=dev)
        M1 = LaplaceMassOperator(mesh, M.degree, M.n_q, M.mass_scaling,
                                 M.laplace_scaling, device=dev)
        E_uu, E_up, E_pu = S1.element_matrices(masked=False)
        E_m = M1.element_matrices(masked=False)
        C1 = E_uu.shape[0]
        E_S = torch.zeros((C1, P, P), dtype=torch.float64, device=dev)
        E_M = torch.zeros_like(E_S)
        for c in range(dim):
            u = slice(c * A, (c + 1) * A)
            E_S[:, u, u], E_M[:, u, u] = E_uu, E_m
        E_S[:, :dim * A, dim * A:] = E_up
        E_S[:, dim * A:, :dim * A] = E_pu
        E = torch.cat([E_S.transpose(1, 2), E_M.transpose(1, 2)], dim=2)
        self._E = (E[0] if S.mesh.uniform else E).to(
            dtype=self.dtype, device=self.device)   # [P, 2P] or [C, P, 2P]
        lidx, src = S.local_maps()
        self._lidx = torch.as_tensor(lidx.reshape(-1), device=self.device)
        self._src = torch.as_tensor(src.reshape(-1), device=self.device)
        mflat = torch.cat([S.mask_u.reshape(-1).expand(dim, -1).reshape(-1),
                           torch.ones(S.n_p, dtype=self.dtype,
                                      device=self.device)])
        self._mloc = mflat[self._lidx].reshape(lidx.shape)      # [C, P]
        # Nitsche faces and the weak obstacle: every face cell's [P, P]
        # face matrix, summed over the layers it lies in (a corner cell
        # lies in two; an obstacle cell's faces are summed per cell by
        # S.obstacle_cell_terms) once, here, by an owner-computes sum
        # (utils/assembly.py::layer_sources)
        parts, layers = [], []
        cell_grid = np.arange(lidx.shape[0]).reshape(S.cells)
        for d0, side, Fuu, Fup, Fpu in S.face_element_matrices():
            F = torch.zeros((Fup.shape[0], P, P), dtype=self.dtype,
                            device=self.device)
            for c in range(dim):
                F[:, c * A:(c + 1) * A, c * A:(c + 1) * A] = Fuu[c]
            F[:, :dim * A, dim * A:] = Fup
            F[:, dim * A:, :dim * A] = Fpu
            parts.append(F)
            layers.append(cell_grid[S._plane(d0, side)].reshape(-1))
        obstacle = S.obstacle_cell_terms()
        if obstacle is not None:
            cells, E_uu, E_up = obstacle
            n = len(cells)
            E_up = E_up.reshape(n, dim * A, -1)
            F = torch.zeros((n, P, P), dtype=self.dtype, device=self.device)
            F[:, :dim * A, :dim * A] = E_uu.permute(0, 1, 3, 2, 4).reshape(
                n, dim * A, dim * A)
            F[:, :dim * A, dim * A:] = E_up
            F[:, dim * A:, :dim * A] = -E_up.transpose(1, 2)
            parts.append(F)
            layers.append(cells.cpu().numpy())
        self._face_cells = self._face_F = None
        if parts:
            fc, table = layer_sources(layers)
            self._face_cells = torch.as_tensor(fc, device=self.device)
            self._face_F = layer_sum(parts, torch.as_tensor(
                table, device=self.device))                # [n_fc, P, P]

    def _vmult_element(self, x):
        T, C, P = x.shape[0], self._mloc.shape[0], self._mloc.shape[1]
        loc = x.index_select(-1, self._lidx).reshape(
            (T, -1, C, P)) * self._mloc
        if self._E.ndim == 2:
            y = loc @ self._E                            # [T, B, C, 2P]
        else:
            y = torch.bmm(loc.movedim(2, 0).reshape(C, -1, P), self._E)
            y = y.reshape((C,) + loc.shape[:2] + (2 * P,)).movedim(0, 2)
        out = (self.a @ y[..., :P].reshape(T, -1)
               + self.b @ y[..., P:].reshape(T, -1)).reshape(loc.shape)
        if self._face_F is not None:
            fc = self._face_cells
            yf = (self._face_F @ loc.index_select(2, fc).unsqueeze(-1)
                  ).squeeze(-1)
            # fc holds each face cell once (summed at setup): one add per
            # target, so the result does not depend on the atomics' order
            out.index_add_(2, fc, (self.a @ yf.reshape(T, -1)).reshape(
                yf.shape))
        out = (out * self._mloc).reshape(T, -1, C * P)
        return overlap_add(out, self._src, self.S.dim).reshape(x.shape)

    def vmult(self, x: torch.Tensor, u_lin: torch.Tensor | None = None,
              mode: str = "none", mask_input: bool = True) -> torch.Tensor:
        """x: [T, ..., n_u + n_p] (axes between the time axis and the flat
        dofs are batch).  For Navier-Stokes pass u_lin ([T, dim, *grid])
        and mode "jacobian" or "form" (reference SystemMatrixStokes
        set_linearization_data + OperatorMode, operators.h:471-500): they
        go through the Stokes operator's apply, on either route;
        mask_input=False reads the eliminated velocity dofs (the strong
        Dirichlet lift)."""
        if self.precision is not None:
            with full_precision():
                return self._vmult_impl(x, u_lin, mode, mask_input)
        return self._vmult_impl(x, u_lin, mode, mask_input)

    __call__ = vmult

    def _vmult_impl(self, x, u_lin=None, mode="none", mask_input=True):
        if self.route == "element" and mode == "none" and mask_input:
            return self._vmult_element(x)
        S = self.S
        u, p = S.unpack(x)
        ru, rp = S.apply(u, p, mode=mode, u_lin=u_lin, mask_input=mask_input)
        Mu = self.M.apply(u, mask_input=mask_input)
        dst_u = (torch.einsum("ji,i...->j...", self.a, ru)
                 + torch.einsum("ji,i...->j...", self.b, Mu))
        dst_p = torch.einsum("ji,i...->j...", self.a, rp)
        return S.pack(dst_u, dst_p)

    def vmult_slice(self, prev_u: torch.Tensor, prev_p: torch.Tensor,
                    mask_input: bool = True) -> torch.Tensor:
        """rhs coupling to the previous step value (reference
        SystemMatrixStokes::vmult_slice_add, operators.h:748-782): gamma
        couples the Stokes operator (CGP only, also the p rows), zeta the
        velocity mass (DG: the jump column).  mask_input=False reads the
        eliminated velocity dofs of prev_u (the strong Dirichlet lift)."""
        if self.precision is not None:
            with full_precision():
                return self._vmult_slice_impl(prev_u, prev_p, mask_input)
        return self._vmult_slice_impl(prev_u, prev_p, mask_input)

    def _vmult_slice_impl(self, prev_u, prev_p, mask_input=True):
        S, T = self.S, self.T
        dst_u = torch.zeros((T, S.dim) + tuple(S.dof_shape_u),
                            dtype=self.dtype, device=self.device)
        dst_p = torch.zeros((T,) + tuple(S.p_shape), dtype=self.dtype,
                            device=self.device)
        if self.gamma_nonzero:
            ru, rp = S.apply(prev_u[None], prev_p[None],
                             mask_input=mask_input)
            g = self.gamma[:, 0]
            dst_u = dst_u + g.reshape((T,) + (1,) * (ru.ndim - 1)) * ru
            dst_p = dst_p + g.reshape((T,) + (1,) * (rp.ndim - 1)) * rp
        if self.zeta_nonzero:
            Mu = self.M.apply(prev_u[None], mask_input=mask_input)
            z = self.zeta[:, 0]
            dst_u = dst_u + z.reshape((T,) + (1,) * (Mu.ndim - 1)) * Mu
        return S.pack(dst_u, dst_p)

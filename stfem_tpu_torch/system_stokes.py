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

from .ops.spatial import LaplaceMassOperator
from .ops.stokes import StokesOperator
from .types import TimeStepType
from .utils.precision import full_precision


class StokesSystemMatrix:
    """precision="highest" (the outer operator and the rhs coupling) runs
    every apply under utils.precision.full_precision: never TF32 (the
    round-5 rhs lesson of stfem_tpu, system_stokes.py:81-102).  Level
    operators inside the preconditioner pass precision=None."""

    def __init__(self, stokes_op: StokesOperator,
                 mass_op: LaplaceMassOperator, a, b, gamma=None, zeta=None,
                 type_: TimeStepType = TimeStepType.DG,
                 precision: str | None = "highest"):
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

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        """x: [T, ..., n_u + n_p] (axes between the time axis and the flat
        dofs are batch)."""
        if self.precision is not None:
            with full_precision():
                return self._vmult_impl(x)
        return self._vmult_impl(x)

    __call__ = vmult

    def _vmult_impl(self, x):
        S = self.S
        u, p = S.unpack(x)
        ru, rp = S.apply(u, p)
        Mu = self.M.apply(u)
        dst_u = (torch.einsum("ji,i...->j...", self.a, ru)
                 + torch.einsum("ji,i...->j...", self.b, Mu))
        dst_p = torch.einsum("ji,i...->j...", self.a, rp)
        return S.pack(dst_u, dst_p)

    def vmult_slice(self, prev_u: torch.Tensor,
                    prev_p: torch.Tensor) -> torch.Tensor:
        """rhs coupling to the previous step value (reference
        SystemMatrixStokes::vmult_slice_add, operators.h:748-782): gamma
        couples the Stokes operator (CGP only, also the p rows), zeta the
        velocity mass (DG: the jump column)."""
        if self.precision is not None:
            with full_precision():
                return self._vmult_slice_impl(prev_u, prev_p)
        return self._vmult_slice_impl(prev_u, prev_p)

    def _vmult_slice_impl(self, prev_u, prev_p):
        S, T = self.S, self.T
        dst_u = torch.zeros((T, S.dim) + tuple(S.dof_shape_u),
                            dtype=self.dtype, device=self.device)
        dst_p = torch.zeros((T,) + tuple(S.p_shape), dtype=self.dtype,
                            device=self.device)
        if self.gamma_nonzero:
            ru, rp = S.apply(prev_u[None], prev_p[None])
            g = self.gamma[:, 0]
            dst_u = dst_u + g.reshape((T,) + (1,) * (ru.ndim - 1)) * ru
            dst_p = dst_p + g.reshape((T,) + (1,) * (rp.ndim - 1)) * rp
        if self.zeta_nonzero:
            Mu = self.M.apply(prev_u[None])
            z = self.zeta[:, 0]
            dst_u = dst_u + z.reshape((T,) + (1,) * (Mu.ndim - 1)) * Mu
        return S.pack(dst_u, dst_p)

"""Spatial right-hand-side assembly and the wave velocity recovery
(counterpart of stfem_tpu/integrators.py::ForceAssembler and of the DG
recovery of TimeIntegratorWave._solve_wave_impl; the time integrator
classes themselves are not ported -- bench_heat.py and bench_wave.py run
the time loops)."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .mesh.fe import shape_data_1d
from .mesh.grid import StructuredMesh
from .ops.spatial import _sumfac, cell_scatter
from .utils.precision import full_precision


class ForceAssembler:
    """F_i(t) = int f(x, t) phi_i dx on the Q_degree dof grid, with
    constrained dofs zeroed (reference include/time_integrators.h:73-110).
    rhs_fn(pts, t) takes pts [..., dim] and a time that broadcasts against
    pts[..., 0]."""

    def __init__(self, mesh: StructuredMesh, degree: int, n_q: int,
                 rhs_fn: Callable, mask, dtype=torch.float64, device="cuda"):
        self.mesh = mesh
        self.degree = degree
        self.dim = mesh.dim
        self.dtype = dtype
        self.device = torch.device(device)
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
        self.S = as_t(shape_data_1d(degree, n_q).S)
        self.jxw = as_t(mesh.geometry(n_q).jxw)
        self.coords = as_t(mesh.quad_coordinates(n_q))
        self.rhs_fn = rhs_fn
        self.mask = as_t(np.asarray(mask))

    def _integrate(self, fq):
        y = _sumfac([self.S] * self.dim, fq, self.dim, forward=False)
        return cell_scatter(y, self.mesh.cells, self.degree) * self.mask

    def __call__(self, t) -> torch.Tensor:
        with full_precision():
            return self._integrate(self.rhs_fn(self.coords, t) * self.jxw)

    def batched(self, ts: torch.Tensor, scales: torch.Tensor):
        """F for a whole slab: ts/scales of shape (n_blocks,) ->
        (n_blocks, *dofshape) in one integrate + scatter sweep."""
        lead = (-1,) + (1,) * (2 * self.dim)
        with full_precision():
            fq = self.rhs_fn(self.coords, ts.reshape(lead))
            fq = fq * self.jxw * scales.reshape(lead)
            return self._integrate(fq)


class WaveVelocityRecovery:
    """v = du/dt of a solved DG wave slab from its u (the Schur elimination
    of the wave tables, reference include/time_integrators.h:400-447):
    per step s, v_s = AixB u_s + AixG[:, 0] u_{s-1}[last] with
    AixB = A1^{-1} B1 and AixG = -A1^{-1} G1 from the single-step
    first-order tables, u_{-1}[last] the previous slab's u.

    all_steps() is the dense recovery of every step in float32 (the bench
    form, bench.py:646-660); last() is the last step's v in float64, which
    feeds the next slab's rhs and replaces stfem_tpu's float-float pair."""

    def __init__(self, Alpha_1, Beta_1, Gamma_1, n_steps: int,
                 device="cuda"):
        A1 = np.asarray(Alpha_1, np.float64)
        Ainv = np.linalg.inv(A1)
        AixB = Ainv @ np.asarray(Beta_1, np.float64)
        AixG = -(Ainv @ np.asarray(Gamma_1, np.float64))[:, 0]  # DG sign
        self.nt, self.n_steps = A1.shape[0], n_steps
        dev = torch.device(device)
        self.AixB = torch.as_tensor(AixB, dtype=torch.float32, device=dev)
        self.AixG = torch.as_tensor(AixG, dtype=torch.float32, device=dev)
        self.AixB_last = torch.as_tensor(AixB[-1], dtype=torch.float64,
                                         device=dev)
        self.AixG_last = float(AixG[-1])

    def all_steps(self, u: torch.Tensor, prev_u: torch.Tensor):
        """u: [n_steps * nt, *dof], prev_u: [*dof] -> v of u's shape, in
        float32."""
        us = u.to(torch.float32).reshape((self.n_steps, self.nt)
                                         + u.shape[1:])
        pu = torch.cat([prev_u.to(torch.float32)[None, None],
                        us[:-1, -1:]], dim=0)
        lead = (1, self.nt) + (1,) * (u.ndim - 1)
        v = (torch.einsum("ij,sj...->si...", self.AixB, us)
             + self.AixG.reshape(lead) * pu)
        return v.reshape(u.shape)

    def last(self, u64: torch.Tensor, prev_u64: torch.Tensor):
        """The last step's v in float64."""
        nt = self.nt
        pu = u64[-nt - 1] if self.n_steps > 1 else prev_u64
        with full_precision():
            return (torch.einsum("j,j...->...", self.AixB_last, u64[-nt:])
                    + self.AixG_last * pu)

"""Spatial right-hand-side assembly, the first-order and wave slab
integrators and the bench's wave velocity recovery (counterpart of
stfem_tpu/integrators.py: ForceAssembler, TimeIntegratorFO,
TimeIntegratorWave).  TimeIntegratorFO and TimeIntegratorWave drive the
tp_01 heat and wave cycles (drivers/heat.py); bench_heat.py and
bench_wave.py run their own time loops (the wave bench with
WaveVelocityRecovery, its DG-only recovery).  The strong-Dirichlet lift of
TimeIntegratorFO is not ported."""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from .krylov import fgmres
from .mesh.fe import shape_data_1d
from .mesh.grid import StructuredMesh
from .ops.spatial import _sumfac, cell_scatter
from .time.tables import get_time_quad
from .types import TimeStepType
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


@dataclass
class SolveStats:
    iterations: int
    residual: float
    converged: bool


class TimeIntegratorFO:
    """First-order-in-time slab integrator (reference TimeIntegratorFO,
    include/time_integrators.h:300-321; stfem_tpu integrators.py:73-177):
    the slab rhs from the previous solution (rhs_matrix.vmult) plus the
    force at the time quadrature points, then FGMRES preconditioned by
    `preconditioner` (a callable; None = unpreconditioned)."""

    def __init__(self, type_: TimeStepType, time_degree: int,
                 Alpha_1: np.ndarray, Gamma_1: np.ndarray,
                 gmres_reltol: float, matrix, preconditioner,
                 rhs_matrix, force: ForceAssembler,
                 n_timesteps_at_once: int, extrapolate: bool = True,
                 abstol: float = 1e-12, maxiter: int = 100):
        self.type_ = type_
        self.quad_time = get_time_quad(type_, time_degree)[0]
        self.Alpha_1 = np.asarray(Alpha_1)
        self.Gamma_1 = np.asarray(Gamma_1)
        self.reltol, self.abstol, self.maxiter = gmres_reltol, abstol, maxiter
        self.matrix = matrix
        self.preconditioner = preconditioner or (lambda v: v)
        self.rhs_matrix = rhs_matrix
        self.force = force
        self.n_timesteps_at_once = n_timesteps_at_once
        self.nt_dofs = (time_degree + 1 if type_ == TimeStepType.DG
                        else time_degree)
        self.extrapolate = extrapolate

    def assemble_force(self, time: float, time_step: float) -> torch.Tensor:
        """[n_blocks, *dofshape]: the force at each time quadrature point,
        weighted by the diagonal time mass (reference
        include/time_integrators.h:73-110)."""
        nt = self.nt_dofs
        parts = [None] * (nt * self.n_timesteps_at_once)

        def add(b, F, c):
            parts[b] = F * c if parts[b] is None else parts[b] + F * c

        for it in range(self.n_timesteps_at_once):
            for j, tq in enumerate(self.quad_time):
                F = self.force(time + time_step * it + time_step * tq)
                if self.type_ == TimeStepType.DG:
                    add(it * nt + j, F, self.Alpha_1[j, j])
                elif j == 0:
                    for i in range(nt):
                        add(it * nt + i, F, -self.Gamma_1[i, 0])
                else:
                    add(it * nt + j - 1, F, self.Alpha_1[j - 1, j - 1])
        return torch.stack(parts)

    def _extrapolate(self, prev_x: torch.Tensor) -> torch.Tensor:
        n_blocks = self.nt_dofs * self.n_timesteps_at_once
        if self.extrapolate:
            return prev_x.expand((n_blocks,) + prev_x.shape)
        return torch.zeros((n_blocks,) + prev_x.shape, dtype=prev_x.dtype,
                           device=prev_x.device)

    def solve(self, prev_x: torch.Tensor, time: float,
              time_step: float) -> tuple[torch.Tensor, SolveStats]:
        rhs = (self.rhs_matrix.vmult(prev_x[None])
               + self.assemble_force(time, time_step))
        res = fgmres(self.matrix.vmult, rhs, self._extrapolate(prev_x),
                     self.preconditioner, maxiter=self.maxiter,
                     reltol=self.reltol, abstol=self.abstol)
        return res.x, SolveStats(res.iterations, res.residual,
                                 res.converged)


class TimeIntegratorWave(TimeIntegratorFO):
    """Wave slab integrator (reference include/time_integrators.h:400-447;
    stfem_tpu integrators.py:191-250): the u-solve of the Schur-reduced
    tables -- rhs = rhs_matrix (prev u) + rhs_matrix_v (prev v) + force,
    then FGMRES -- and the dense v-recovery epilogue in float64, per step
        DG:  v = AixB u_s + AixG[:, 0] u_{s-1}[last]
        CGP: v = AixB u_s + AixG[:, 0] v_{s-1}[last] + AixZ[:, 0] u_{s-1}[last]
    with AixB = A1^{-1} B1, AixG = A1^{-1} G1 (negated for DG) and AixZ =
    -A1^{-1} Z1 (CGP) from the single-step first-order tables, and step
    -1's values the previous slab's u and v."""

    def __init__(self, type_: TimeStepType, time_degree: int,
                 Alpha_1, Beta_1, Gamma_1, Zeta_1, gmres_reltol: float,
                 matrix, preconditioner, rhs_matrix, rhs_matrix_v,
                 force: ForceAssembler, n_timesteps_at_once: int,
                 extrapolate: bool = True, abstol: float = 1e-12,
                 maxiter: int = 100):
        super().__init__(type_, time_degree, Alpha_1, Gamma_1, gmres_reltol,
                         matrix, preconditioner, rhs_matrix, force,
                         n_timesteps_at_once, extrapolate, abstol, maxiter)
        self.rhs_matrix_v = rhs_matrix_v
        Ainv = np.linalg.inv(np.asarray(Alpha_1, np.float64))
        sign = -1.0 if type_ == TimeStepType.DG else 1.0
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float64,
                                         device=matrix.device)
        self.AixB = as_t(Ainv @ np.asarray(Beta_1, np.float64))
        self.AixG = as_t(sign * (Ainv @ np.asarray(Gamma_1, np.float64))[:, 0])
        self.AixZ = as_t(-(Ainv @ np.asarray(Zeta_1, np.float64))[:, 0])

    def recover_v(self, u: torch.Tensor, prev_u: torch.Tensor,
                  prev_v: torch.Tensor) -> torch.Tensor:
        """v of every block of the slab, [n_blocks, *dof], in float64."""
        nt, S = self.nt_dofs, self.n_timesteps_at_once
        us = u.reshape((S, nt) + u.shape[1:])
        starts = torch.cat([prev_u[None], us[:-1, -1]])     # u_{s-1}[last]
        lead = (1, nt) + (1,) * prev_u.ndim
        with full_precision():
            v = torch.einsum("ij,sj...->si...", self.AixB, us)
            if self.type_ == TimeStepType.DG:
                v = v + self.AixG.reshape(lead) * starts[:, None]
            else:
                v = v + self.AixZ.reshape(lead) * starts[:, None]
                # v_{s-1}[last] feeds step s: a recurrence over the steps
                pv = prev_v
                for s in range(S):
                    v[s] += self.AixG.reshape(lead[1:]) * pv[None]
                    pv = v[s, -1]
        return v.reshape(u.shape)

    def solve_wave(self, prev_u: torch.Tensor, prev_v: torch.Tensor,
                   time: float, time_step: float):
        """(u, v, SolveStats) of one slab."""
        rhs = (self.rhs_matrix.vmult(prev_u[None])
               + self.rhs_matrix_v.vmult(prev_v[None])
               + self.assemble_force(time, time_step))
        res = fgmres(self.matrix.vmult, rhs, self._extrapolate(prev_u),
                     self.preconditioner, maxiter=self.maxiter,
                     reltol=self.reltol, abstol=self.abstol)
        return (res.x, self.recover_v(res.x, prev_u, prev_v),
                SolveStats(res.iterations, res.residual, res.converged))


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

"""The Stokes application's cycles (counterpart of
stfem_tpu/drivers/stokes.py; the reference's tests/tp_03stokes.cc):
Q_{k+1}^2 velocity x DGP(k) pressure on the unit square (run_stokes_cycle
also with the continuous Q_k pressure, dg_pressure=False), DG or CGP in
time, FP64 FGMRES with the float32 STMG V-cycle.

run_stokes_cycle: the convergence mode -- the manufactured solution as the
initial value and in the rhs, strong (or, with nitsche_boundary, weak
zero) Dirichlet faces, the mean pressure removed per time block, and the
space-time error norms of u (L2, Linf, H1-semi, Hdiv-semi) and p (L2,
Linf, H1-semi).  run_lid_driven: the practical lid-driven cavity -- the
x = 1 wall moves tangentially with u_y = u_max sin(pi t / 4), weakly
(Nitsche) or strongly (interpolated block values, with or without the
consistent lift), and the functionals file gets the probe velocity, the
moving wall's force and the divergence norm per time dof.
run_dfg_square: the DFG channel (flow around the obstacle, reference
stokes_dfg.json) on the dfgBenchmarkSquare grid or its cylinder morph --
weak inflow with the DFG profile, weak walls, a do-nothing outflow, the
strong or the weak (Nitsche) obstacle -- with the obstacle's drag and
lift and the divergence norm per slab.  run_navier_stokes_cycle: the
convergence mode with convection -- per slab a Picard iteration of Oseen
solves (the operator's "form" mode at the last iterate), started from
the previous value or from the extrapolation predictor.

Everything runs on `device` (the card unless the caller asks for the
CPU); each slab reads back its error norms or its functionals rows once.
"""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass, field

import numpy as np
import torch

from ..errors import SpatialEvaluator
from ..krylov import fgmres
from ..mesh.fe import shape_data_1d
from ..mesh.fe_dgp import (dgp_gradients_at_tensor_gauss,
                           dgp_values_at_tensor_gauss)
from ..mesh.grid import StructuredMesh
from ..ops.spatial import (LaplaceMassOperator, _sumfac, basis_tensors,
                           cell_scatter)
from ..ops.stokes import StokesOperator
from ..problems import stokes as stokes_problem
from ..system_stokes import StokesSystemMatrix
from ..time.quadrature import gauss
from ..time.tables import (get_extrapolation_matrix, get_fe_time_weights,
                           get_time_basis, get_time_quad)
from ..types import TimeStepType

F64 = torch.float64


@dataclass
class StokesCycleResult:
    n_cells: int
    n_dofs_u: int
    n_dofs_p: int
    n_blocks: int
    n_timesteps: int
    total_iterations: int
    avg_iterations: float
    l2_l2_u: float
    linf_linf_u: float
    l2_h1_u: float
    l2_hdiv_u: float
    l2_l2_p: float
    linf_linf_p: float
    l2_h1_p: float
    slab_iterations: list = field(default_factory=list)


class StokesErrorCalculator:
    """u errors at QGauss(u_degree + 1), p errors at QGauss(p_degree + 1)
    (reference tp_03stokes.cc:833-848).  Every time quadrature point of
    every step of a slab goes through one batched pass; the norms are 0-d
    tensors (the caller reads them back once per slab)."""

    def __init__(self, S: StokesOperator, type_: TimeStepType,
                 time_degree: int, dtype=F64):
        self.S, self.type_ = S, type_
        dev, mesh, dim = S.device, S.mesh, S.dim
        self.nt = time_degree + 1 if type_ == TimeStepType.DG else \
            time_degree
        self.tq, self.tw = gauss(time_degree + 1)
        self.phi = torch.as_tensor(
            get_time_basis(type_, time_degree).eval_matrix(self.tq),
            dtype=dtype, device=dev)
        self.ev_u = SpatialEvaluator(mesh, S.u_degree, S.u_degree + 1,
                                     dtype, dev)
        nqp = S.p_degree + 1
        self.nqp = nqp
        n_pl = S.n_ploc_cell
        if S.dg_pressure:
            P = dgp_values_at_tensor_gauss(dim, S.p_degree, nqp)
            dP = dgp_gradients_at_tensor_gauss(dim, S.p_degree, nqp)
        else:
            # the nodal Q_kp basis of a cell (stfem_tpu drivers/stokes.py:
            # 76-80, 145-160)
            P, G = basis_tensors(dim, S.p_degree, nqp)
            dP = np.moveaxis(G, 0, -1)
        jinv = mesh.geometry(nqp).jinv_diag
        self.Pq = torch.as_tensor(P.reshape(n_pl, -1), dtype=dtype,
                                  device=dev)
        # physical gradients of the pressure basis, [n_ploc_cell, Qp, dim]
        self.dPq = torch.as_tensor(
            dP.reshape(n_pl, -1, dim) * np.asarray(jinv)[None, None, :],
            dtype=dtype, device=dev)
        self.jxw_p = torch.as_tensor(mesh.geometry(nqp).jxw, dtype=dtype,
                                     device=dev)
        self.coords_p = torch.as_tensor(mesh.quad_coordinates(nqp),
                                        dtype=dtype, device=dev)

    def _reconstruct(self, x, prev, n_at_once):
        """[steps * n_tq, ...]: the field at every time quadrature point of
        every step (a CGP step's coefficients start with its start value:
        prev for the first step, else the previous step's last block)."""
        coef = x.reshape((n_at_once, self.nt) + x.shape[1:])
        if self.type_ == TimeStepType.CGP:
            start = torch.cat([prev[None], coef[:-1, -1]])
            coef = torch.cat([start[:, None], coef], dim=1)
        return torch.einsum("qi,si...->sq...", self.phi, coef).flatten(0, 1)

    def evaluate(self, time, tau, u_time, p_time, prev_u, prev_p,
                 n_at_once) -> torch.Tensor:
        """[7] tensor: the slab's time-integrated squared L2, H1-semi and
        Hdiv-semi errors of u, its Linf error of u, the squared L2 and
        H1-semi errors of p and its Linf error of p, in the order
        (l2_u, h1_u, hdiv_u, linf_u, l2_p, h1_p, linf_p).
        u_time: [T, dim, *grid], p_time: [T, *p_shape]."""
        S, ev, dim = self.S, self.ev_u, self.S.dim
        u = self._reconstruct(u_time, prev_u, n_at_once) * S.mask_u
        p = self._reconstruct(p_time, prev_p, n_at_once)
        if not S.dg_pressure:
            # [n, *cells, n_ploc_cell]: the masked nodes of each cell
            p = S._p_local(p).reshape(p.shape[:1] + S.cells + (-1,))
        n = u.shape[0]
        ts = (time + tau * (np.arange(n_at_once)[:, None]
                            + self.tq[None, :])).reshape(-1)
        t = torch.as_tensor(ts, dtype=u.dtype, device=u.device).reshape(
            (-1,) + (1,) * (2 * dim))
        wt = torch.as_tensor(np.tile(tau * self.tw, n_at_once),
                             dtype=u.dtype, device=u.device)
        sp = tuple(range(1, 2 * dim + 1))
        # u: values [n, c, *cells, *q], gradients [..., e]
        du = torch.movedim(ev.values(u), 1, -1) - stokes_problem.exact_u(
            ev.coords, t)                          # [n, *cells, *q, c]
        gu = torch.movedim(ev.gradients(u), 1, -2) \
            - stokes_problem.exact_grad_u(ev.coords, t)  # [..., c, e]
        jxw = ev.jxw[..., None]
        l2 = wt @ torch.sum(jxw * du ** 2, dim=sp + (2 * dim + 1,))
        h1 = wt @ torch.sum(jxw[..., None] * gu ** 2,
                            dim=sp + (2 * dim + 1, 2 * dim + 2))
        ddiv = torch.diagonal(gu, dim1=-2, dim2=-1).sum(-1)
        hdiv = wt @ torch.sum(ev.jxw * ddiv ** 2, dim=sp)
        # p: values and gradients at QGauss(p_degree + 1)
        qshape = (self.nqp,) * dim
        pv = (p @ self.Pq).reshape(p.shape[:-1] + qshape)
        dp = (p @ self.dPq.reshape(self.dPq.shape[0], -1)).reshape(
            p.shape[:-1] + qshape + (dim,))
        ep = pv - stokes_problem.exact_p(self.coords_p, t)
        egp = dp - stokes_problem.exact_grad_p(self.coords_p, t)
        l2p = wt @ torch.sum(self.jxw_p * ep ** 2, dim=sp)
        h1p = wt @ torch.sum(self.jxw_p[..., None] * egp ** 2,
                             dim=sp + (2 * dim + 1,))
        return torch.stack([l2, h1, hdiv, du.abs().amax(), l2p, h1p,
                            ep.abs().amax()])


def _step_geometry(refinement: int, end_time: float, min_steps: int = 0):
    """The unit-square mesh and the time step of tp_03stokes.cc:105-109:
    the step from min(unrefined cell diameter, T), refined with the
    mesh."""
    mesh = StructuredMesh([1, 1], [0.0, 0.0], [1.0, 1.0],
                          refinement=refinement)
    step_ = min(mesh.coarse_cell_diameter, end_time)
    n_steps = max(int(end_time / step_), min_steps)
    return mesh, end_time * 2.0 ** (-(refinement + 1)) / n_steps


def _time_rows(type_, fe_degree, tau, n_at_once):
    """(times [steps * n_tq], weights [T, steps * n_tq]): the slab's time
    quadrature points and the diagonal-Alpha rule of the reference's
    force and Nitsche assembly (stfem_tpu drivers/stokes.py:237-262,
    time_integrators.h:126-171), block i = sum_j W[i, j] f(t_j)."""
    a1, _, g1, _ = get_fe_time_weights(type_, fe_degree, tau, 1)
    tq = get_time_quad(type_, fe_degree)[0]
    nt = fe_degree if type_ == TimeStepType.CGP else fe_degree + 1
    nq = len(tq)
    W = np.zeros((nt * n_at_once, nq * n_at_once))
    for it in range(n_at_once):
        for j in range(nq):
            col = it * nq + j
            if type_ == TimeStepType.DG:
                W[it * nt + j, col] += a1[j, j]
            elif j == 0:
                for i in range(nt):
                    W[it * nt + i, col] += -g1[i, 0]
            else:
                W[it * nt + j - 1, col] += a1[j - 1, j - 1]
    times = np.array([tau * it + tau * float(q) for it in range(n_at_once)
                      for q in tq])
    return times, W


def _force_assembler(S: StokesOperator, type_, fe_degree, tau, n_at_once,
                     viscosity, navier=False):
    """time -> [T, n_u + n_p]: the manufactured momentum force (with the
    convection term when navier) at QGauss(u_degree + 1), like the
    operator, integrated per time quadrature point and combined by the
    diagonal-Alpha rule (_time_rows); zero pressure rows."""
    mesh, dim, dev = S.mesh, S.dim, S.device
    S1 = torch.as_tensor(shape_data_1d(S.u_degree, S.n_q).S, dtype=F64,
                         device=dev)
    fcoords = torch.as_tensor(mesh.quad_coordinates(S.n_q), dtype=F64,
                              device=dev)
    t_off, Wf = _time_rows(type_, fe_degree, tau, n_at_once)
    Wf = torch.as_tensor(Wf, dtype=F64, device=dev)
    zero_p = torch.zeros((Wf.shape[0], S.n_p), dtype=F64, device=dev)

    def assemble_force(time):
        t = torch.as_tensor(time + t_off, dtype=F64, device=dev).reshape(
            (-1,) + (1,) * (2 * dim))
        f = torch.movedim(stokes_problem.rhs_u(fcoords, t, viscosity,
                                               navier=navier),
                          -1, 1) * S.jxw        # [n_tq, c, *cells, *q]
        F = cell_scatter(_sumfac([S1] * dim, f, dim, forward=False),
                         mesh.cells, S.u_degree) * S.mask_u
        return torch.cat([Wf @ F.reshape(F.shape[0], -1), zero_p], 1)

    return assemble_force


def _add_errors(acc: torch.Tensor, e: torch.Tensor) -> None:
    """Accumulate a slab's StokesErrorCalculator.evaluate row into acc:
    the squared norms summed, the Linf norms maxed."""
    acc[:3] += e[:3]
    acc[3] = max(acc[3], e[3])
    acc[4:6] += e[4:6]
    acc[6] = max(acc[6], e[6])


def _cycle_result(mesh, S, T, iters, acc) -> StokesCycleResult:
    l2, h1, hdiv, linf, l2p, h1p, linfp = acc.tolist()
    return StokesCycleResult(
        n_cells=mesh.n_cells, n_dofs_u=S.n_u, n_dofs_p=S.n_p,
        n_blocks=2 * T, n_timesteps=len(iters),
        total_iterations=sum(iters), avg_iterations=sum(iters) / len(iters),
        l2_l2_u=float(np.sqrt(l2)), linf_linf_u=linf,
        l2_h1_u=float(np.sqrt(h1)), l2_hdiv_u=float(np.sqrt(hdiv)),
        l2_l2_p=float(np.sqrt(l2p)), linf_linf_p=linfp,
        l2_h1_p=float(np.sqrt(h1p)), slab_iterations=iters)


def run_stokes_cycle(refinement: int, fe_degree: int,
                     type_: TimeStepType = TimeStepType.DG,
                     n_timesteps_at_once: int = 1,
                     viscosity: float = 1.0, end_time: float = 1.0,
                     mean_pressure: bool = True,
                     preconditioner_factory=None, gmres_maxiter: int = 200,
                     rel_tol: float = 1e-12, extrapolate: bool = True,
                     nitsche_boundary: bool = False,
                     dg_pressure: bool = True, device="cuda", timer=None,
                     on_slab=None,
                     n_slabs_max: int | None = None) -> StokesCycleResult:
    """One tp_03stokes convergence cycle (reference tp_03stokes.cc).
    dg_pressure=False takes the continuous Q_k pressure (Taylor-Hood;
    its mean is the jxw-weighted one at the quadrature points).

    preconditioner_factory(ctx) builds the preconditioner from the cycle
    context (None: unpreconditioned FGMRES).  timer: an optional
    utils.timer.TimerOutput, given the scopes "setup" (everything before
    the time loop), "setup:gmg" and "step" (one slab solve, synchronized).
    on_slab(info), if given, is called after each slab's solve with the
    slab's FGMRES problem and result (matrix, rhs, x0, x, stats, time,
    time_step, preconditioner) and `resolve`, which solves the slab again.
    n_slabs_max, if given, stops the march after that many slabs (the
    error norms then cover those slabs)."""
    device = torch.device(device)
    scope = timer.scope if timer is not None else (lambda *a, **k:
                                                   nullcontext())
    dim = 2
    is_cgp = type_ == TimeStepType.CGP
    u_degree, p_degree = fe_degree + 1, fe_degree
    n_q = u_degree + 1
    nt = fe_degree if is_cgp else fe_degree + 1
    T = nt * n_timesteps_at_once
    with scope("setup"):
        mesh, tau = _step_geometry(refinement, end_time)
        # all boundaries weak (zero Dirichlet data: no extra rhs)
        weak_faces = (tuple((d, s) for d in range(dim) for s in (0, 1))
                      if nitsche_boundary else ())
        S = StokesOperator(mesh, u_degree, p_degree, n_q, viscosity,
                           device=device, weak_faces=weak_faces,
                           dg_pressure=dg_pressure)
        Mu = LaplaceMassOperator(mesh, u_degree, n_q, 1.0, 0.0,
                                 device=device, mask=S.mask_u_np)
        a, b, g, z = get_fe_time_weights(type_, fe_degree, tau,
                                         n_timesteps_at_once)
        matrix = StokesSystemMatrix(S, Mu, a, b)
        rhs_matrix = StokesSystemMatrix(S, Mu, a, b,
                                        gamma=g if is_cgp else None,
                                        zeta=z if is_cgp else g, type_=type_)
        assemble_force = _force_assembler(S, type_, fe_degree, tau,
                                          n_timesteps_at_once, viscosity)

        precond = None
        if preconditioner_factory is not None:
            ctx = dict(mesh=mesh, fe_degree=fe_degree, u_degree=u_degree,
                       p_degree=p_degree, type_=type_, viscosity=viscosity,
                       n_timesteps_at_once=n_timesteps_at_once,
                       time_step=tau, n_q=n_q, refinement=refinement,
                       weak_faces=weak_faces, dg_pressure=dg_pressure,
                       device=device)
            with scope("setup:gmg"):
                precond = preconditioner_factory(ctx)
        err = StokesErrorCalculator(S, type_, fe_degree)
        coords_u = torch.as_tensor(mesh.dof_coordinates(u_degree),
                                   dtype=F64, device=device)
        u0 = torch.movedim(stokes_problem.exact_u(coords_u, 0.0), -1, 0)
        p0 = torch.zeros(S.p_shape, dtype=F64, device=device)  # p(0) = 0
        prev_flat = S.pack(u0, p0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def solve_slab(prev_flat, time):
        prev_u, prev_p = S.unpack(prev_flat)
        rhs = rhs_matrix.vmult_slice(prev_u, prev_p) + assemble_force(time)
        x0 = (prev_flat.expand(T, -1) if extrapolate
              else torch.zeros((T, prev_flat.numel()), dtype=F64,
                               device=device))
        res = fgmres(matrix.vmult, rhs, x0,
                     precondition=precond or (lambda v: v),
                     maxiter=gmres_maxiter, abstol=1e-12, reltol=rel_tol)
        return rhs, x0, res

    detj = float(np.prod(mesh.h))
    vol = float(np.prod(mesh.upper - mesh.lower))
    time, iters, acc = 0.0, [], torch.zeros(7, dtype=F64)
    while time < end_time - 1e-12 and (n_slabs_max is None
                                       or len(iters) < n_slabs_max):
        with scope("step", sync=device):
            rhs, x0, res = solve_slab(prev_flat, time)
        if not res.converged:
            raise RuntimeError(f"FGMRES stalled at t={time}: "
                               f"{res.iterations} iterations, residual "
                               f"{res.residual:.3e}")
        if on_slab is not None:
            on_slab(dict(matrix=matrix, rhs=rhs, x0=x0, x=res.x, stats=res,
                         time=time, time_step=tau, preconditioner=precond,
                         resolve=lambda p=prev_flat, t=time: solve_slab(p,
                                                                        t)))
        iters.append(res.iterations)
        u_time, p_time = S.unpack(res.x)
        if mean_pressure and dg_pressure:
            # the DGP constant mode carries each cell's mean: remove the
            # mean pressure of every time block
            means = p_time[..., 0].sum(dim=tuple(range(1, dim + 1))) \
                * (detj / vol)
            p_time = p_time.clone()
            p_time[..., 0] -= means.reshape((T,) + (1,) * dim)
        elif mean_pressure:
            # FE_Q: the jxw-weighted mean of every time block's pressure
            # at the quadrature points, off every node
            means = (S._p_at_quad(p_time) * S._wq).sum(dim=(1, 2)) / vol
            p_time = p_time - means.reshape((T,) + (1,) * dim)
        prev_u, prev_p = S.unpack(prev_flat)
        _add_errors(acc, err.evaluate(time, tau, u_time, p_time, prev_u,
                                      prev_p, n_timesteps_at_once).cpu())
        prev_flat = S.pack(u_time[-1], p_time[-1])
        time += n_timesteps_at_once * tau
    return _cycle_result(mesh, S, T, iters, acc)


def run_lid_driven(refinement: int = 3, fe_degree: int = 1,
                   type_: TimeStepType = TimeStepType.DG,
                   n_timesteps_at_once: int = 1, viscosity: float = 1.0,
                   end_time: float = 2.0, u_max: float = 1.0,
                   preconditioner_factory=None, gmres_maxiter: int = 100,
                   rel_tol: float = 1e-8, n_slabs_max: int | None = None,
                   strong_bc: bool = False, boundary_lift: bool = True,
                   functionals_path: str | None = None,
                   probe_points=((0.5, 0.5),), device="cuda", timer=None,
                   on_slab=None) -> dict:
    """The lid-driven cavity (reference tests/json/tf05stokes.json and
    stokes::LidDriven, stokes.h:72-99): the x = 1 wall (boundary id 1)
    moves with u_y = u_max sin(pi t / 4), the other walls are no-slip.

    Weak (the shipped config, nitscheBoundary true): the wall is a Nitsche
    face and its data enter through nitsche_rhs at every time quadrature
    point.  strong_bc: the reference's scheme (tp_03stokes.cc:1022-1046,
    operators.h:2103-2223) -- g interpolated at every block time on the
    wall's dofs without the corners (the no-slip zeros win there),
    constrained entries zeroed before the solve and the values pasted
    after; boundary_lift adds the consistent lift rhs -= A x_g with the
    previous value read unmasked (the reference omits it: its matrix-free
    operator reads constrained dofs as zero, and the interior is then not
    driven).  n_slabs_max cuts the march.  functionals_path: rows of the
    probe velocity, the moving wall's force and the divergence norm per
    time dof, resampled by the time evaluation matrix (tp_03stokes.cc:
    918-996).  timer and on_slab as in run_stokes_cycle.

    Returns dict(iterations (per slab), u, p (the last block, NumPy),
    tau, time, n_dofs (n_u + n_p), n_blocks)."""
    device = torch.device(device)
    scope = timer.scope if timer is not None else (lambda *a, **k:
                                                   nullcontext())
    dim = 2
    is_cgp = type_ == TimeStepType.CGP
    u_degree, p_degree = fe_degree + 1, fe_degree
    n_q = u_degree + 1
    nt = fe_degree if is_cgp else fe_degree + 1
    T = nt * n_timesteps_at_once
    with scope("setup"):
        mesh, tau = _step_geometry(refinement, end_time, min_steps=1)
        # x = x_max: the moving wall; strong mode eliminates it
        weak_faces = () if strong_bc else ((0, 1),)
        S = StokesOperator(mesh, u_degree, p_degree, n_q, viscosity,
                           device=device, weak_faces=weak_faces)
        Mu = LaplaceMassOperator(mesh, u_degree, n_q, 1.0, 0.0,
                                 device=device, mask=S.mask_u_np)
        a, b, g, z = get_fe_time_weights(type_, fe_degree, tau,
                                         n_timesteps_at_once)
        matrix = StokesSystemMatrix(S, Mu, a, b)
        rhs_matrix = StokesSystemMatrix(S, Mu, a, b,
                                        gamma=g if is_cgp else None,
                                        zeta=z if is_cgp else g, type_=type_)

        def lid_g(coords, t):
            gy = torch.full(coords.shape[:-1], u_max * float(np.sin(
                np.pi * t / 4.0)), dtype=F64, device=coords.device)
            return torch.stack([torch.zeros_like(gy), gy], dim=-1)

        t_off, Wn = _time_rows(type_, fe_degree, tau, n_timesteps_at_once)
        Wn = torch.as_tensor(Wn, dtype=F64, device=device)

        def assemble_nitsche_rhs(time):
            """The weak lid's data per time quadrature point, combined by
            the diagonal-Alpha rule (reference TimeIntegrator::
            assemble_nitsche, time_integrators.h:126-171)."""
            rows = [S.pack(*S.nitsche_rhs(lid_g, time + float(dt)))
                    for dt in t_off]
            return Wn @ torch.stack(rows)

        precond = None
        if preconditioner_factory is not None:
            ctx = dict(mesh=mesh, fe_degree=fe_degree, u_degree=u_degree,
                       p_degree=p_degree, type_=type_, viscosity=viscosity,
                       n_timesteps_at_once=n_timesteps_at_once,
                       time_step=tau, n_q=n_q, refinement=refinement,
                       weak_faces=weak_faces, device=device)
            with scope("setup:gmg"):
                precond = preconditioner_factory(ctx)

        u_mask_flat = torch.cat([
            S.mask_u.expand((dim,) + S.dof_shape_u).reshape(-1),
            torch.ones(S.n_p, dtype=F64, device=device)])
        if strong_bc:
            from ..ops.boundary import slab_time_offsets
            cu = mesh.dof_coordinates(u_degree)
            on_wall = np.isclose(cu[..., 0], 1.0)
            on_other = (np.isclose(cu[..., 0], 0.0)
                        | np.isclose(cu[..., 1], 0.0)
                        | np.isclose(cu[..., 1], 1.0))
            lid = torch.as_tensor((on_wall & ~on_other).astype(float),
                                  dtype=F64, device=device)
            t_blocks = slab_time_offsets(type_, fe_degree, tau,
                                         n_timesteps_at_once)

            def xg_blocks(time):
                """[T, n_u + n_p] wall-supported g at every block time."""
                amps = torch.as_tensor(u_max * np.sin(
                    np.pi * (time + t_blocks) / 4.0), dtype=F64,
                    device=device)
                gy = amps[:, None, None] * lid[None]
                gu = torch.stack([torch.zeros_like(gy), gy], dim=1)
                return torch.cat([gu.reshape(T, -1),
                                  torch.zeros((T, S.n_p), dtype=F64,
                                              device=device)], dim=1)

        pe = writer = None
        if functionals_path is not None:
            from ..ops.functionals import (compute_divergence_norm,
                                           compute_wall_force)
            from ..utils.probes import FunctionalsWriter, PointEvaluator
            pe = PointEvaluator(mesh, u_degree, probe_points)
            writer = FunctionalsWriter(functionals_path, type_, fe_degree)

            def functional_rows(u_b, p_b):
                """[n, 2 n_points + 3] (probe u per component, wall force,
                divergence norm) of blocks u_b [n, dim, *grid], p_b [n,
                *cells, n_ploc], read back once."""
                rows = [torch.cat([pe.tensor(u).reshape(-1),
                                   compute_wall_force(S, u, p, (0, 1)),
                                   compute_divergence_norm(S, u)[None]])
                        for u, p in zip(u_b, p_b)]
                return torch.stack(rows).cpu().numpy()

            prev_row = functional_rows(
                torch.zeros((1, dim) + S.dof_shape_u, dtype=F64,
                            device=device),
                torch.zeros((1,) + S.p_shape, dtype=F64, device=device))[0]
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def solve_slab(prev_flat, time):
        prev_u, prev_p = S.unpack(prev_flat)
        if strong_bc:
            x_g = xg_blocks(time)
            if boundary_lift:
                rhs = rhs_matrix.vmult_slice(prev_u, prev_p,
                                             mask_input=False)
                rhs = rhs - matrix.vmult(x_g, mask_input=False)
            else:
                rhs = rhs_matrix.vmult_slice(prev_u, prev_p)
            x0 = (prev_flat * u_mask_flat).expand(T, -1)
        else:
            rhs = (rhs_matrix.vmult_slice(prev_u, prev_p)
                   + assemble_nitsche_rhs(time))
            x0 = prev_flat.expand(T, -1)
        res = fgmres(matrix.vmult, rhs, x0,
                     precondition=precond or (lambda v: v),
                     maxiter=gmres_maxiter, abstol=1e-12, reltol=rel_tol)
        return rhs, x0, res

    detj = float(np.prod(mesh.h))
    prev_flat = torch.zeros(S.n_u + S.n_p, dtype=F64, device=device)
    time, iters = 0.0, []
    n_slabs = int(round(end_time / (n_timesteps_at_once * tau)))
    if n_slabs_max is not None:
        n_slabs = min(n_slabs, n_slabs_max)
    for _ in range(n_slabs):
        with scope("step", sync=device):
            rhs, x0, res = solve_slab(prev_flat, time)
        if not res.converged:
            raise RuntimeError(f"FGMRES stalled at t={time}: "
                               f"{res.iterations} iterations, residual "
                               f"{res.residual:.3e}")
        if on_slab is not None:
            on_slab(dict(matrix=matrix, rhs=rhs, x0=x0, x=res.x, stats=res,
                         time=time, time_step=tau, preconditioner=precond,
                         resolve=lambda p=prev_flat, t=time: solve_slab(p,
                                                                        t)))
        iters.append(res.iterations)
        # the eliminated dofs zeroed (the weak lid's corners, which the
        # wall force reads; the reference's constraints.distribute()), and
        # the strong lid's data pasted (its set_inhomogeneity)
        x = res.x * u_mask_flat
        if strong_bc:
            x = x + xg_blocks(time)
        u_time, p_time = S.unpack(x)
        means = p_time[..., 0].sum(dim=tuple(range(1, dim + 1))) * detj
        p_time = p_time.clone()
        p_time[..., 0] -= means.reshape((T,) + (1,) * dim)
        if writer is not None:
            for it in range(n_timesteps_at_once):
                rows = functional_rows(u_time[it * nt:(it + 1) * nt],
                                       p_time[it * nt:(it + 1) * nt])
                writer.write_step(time + it * tau, tau, rows,
                                  prev_row if is_cgp else None)
                prev_row = rows[-1]
        prev_flat = S.pack(u_time[-1], p_time[-1])
        time += n_timesteps_at_once * tau
    u, p = S.unpack(prev_flat)
    return dict(iterations=iters, u=u.cpu().numpy(), p=p.cpu().numpy(),
                tau=tau, time=time, n_dofs=S.n_u + S.n_p, n_blocks=T)


def run_navier_stokes_cycle(refinement: int, fe_degree: int,
                            type_: TimeStepType = TimeStepType.DG,
                            n_timesteps_at_once: int = 1,
                            viscosity: float = 1.0, end_time: float = 1.0,
                            n_picard: int = 3, preconditioner_factory=None,
                            gmres_maxiter: int = 200, rel_tol: float = 1e-10,
                            delta0: float = 0.0,
                            nonlinear_extrapolation=None,
                            n_slabs_max: int | None = None, device="cuda",
                            timer=None, on_slab=None) -> StokesCycleResult:
    """The Navier-Stokes convergence cycle (stfem_tpu drivers/stokes.py::
    run_navier_stokes_cycle): the manufactured solution with the
    convection term in the rhs (exact_solution.h:287-317) and, per slab,
    n_picard Oseen solves, each with the operator's "form" mode at the
    previous iterate u_lin; the preconditioner is built once, from the
    factory, for the whole cycle.  The first u_lin of a slab is the
    previous value broadcast (the Constant predictor), or with
    nonlinear_extrapolation (a types.NonlinearExtrapolation) the
    extrapolation matrix applied to the previous slab's start value and
    time dofs (the reference's extrapolate_nonlinear, fe_time.h:
    1223-1240; single-step slabs only).  The iterations counted are the
    last Picard solve's, the mean pressure is removed per time block and
    the error norms are run_stokes_cycle's.  n_slabs_max cuts the march.

    timer: as in run_stokes_cycle, with "picard" (one Oseen solve,
    synchronized) inside each "step" (the slab's Picard iteration).
    on_slab(info), if given, is called after each Oseen solve with its
    FGMRES problem and result (matrix, u_lin -- the linearization it
    solved with --, rhs, x0, x, stats, time, time_step, preconditioner,
    picard: the solve's index in the slab) and `resolve`, which solves
    it again."""
    device = torch.device(device)
    scope = timer.scope if timer is not None else (lambda *a, **k:
                                                   nullcontext())
    dim = 2
    is_cgp = type_ == TimeStepType.CGP
    u_degree, p_degree = fe_degree + 1, fe_degree
    n_q = u_degree + 1
    nt = fe_degree if is_cgp else fe_degree + 1
    T = nt * n_timesteps_at_once
    with scope("setup"):
        mesh, tau = _step_geometry(refinement, end_time)
        S = StokesOperator(mesh, u_degree, p_degree, n_q, viscosity,
                           device=device, delta0=delta0)
        Mu = LaplaceMassOperator(mesh, u_degree, n_q, 1.0, 0.0,
                                 device=device, mask=S.mask_u_np)
        a, b, g, z = get_fe_time_weights(type_, fe_degree, tau,
                                         n_timesteps_at_once)
        matrix = StokesSystemMatrix(S, Mu, a, b)
        rhs_matrix = StokesSystemMatrix(S, Mu, a, b,
                                        gamma=g if is_cgp else None,
                                        zeta=z if is_cgp else g, type_=type_)
        assemble_force = _force_assembler(S, type_, fe_degree, tau,
                                          n_timesteps_at_once, viscosity,
                                          navier=True)

        precond = None
        if preconditioner_factory is not None:
            ctx = dict(mesh=mesh, fe_degree=fe_degree, u_degree=u_degree,
                       p_degree=p_degree, type_=type_, viscosity=viscosity,
                       n_timesteps_at_once=n_timesteps_at_once,
                       time_step=tau, n_q=n_q, refinement=refinement,
                       weak_faces=(), device=device)
            with scope("setup:gmg"):
                precond = preconditioner_factory(ctx)
        E_extra = None
        if nonlinear_extrapolation is not None:
            assert n_timesteps_at_once == 1, \
                "extrapolation predictor wired for single-step slabs"
            E_extra = torch.as_tensor(get_extrapolation_matrix(
                type_, nonlinear_extrapolation, fe_degree, 1.0, 0.0, 0.0),
                dtype=F64, device=device)
        err = StokesErrorCalculator(S, type_, fe_degree)
        coords_u = torch.as_tensor(mesh.dof_coordinates(u_degree),
                                   dtype=F64, device=device)
        u0 = torch.movedim(stokes_problem.exact_u(coords_u, 0.0), -1, 0)
        p0 = torch.zeros(S.p_shape, dtype=F64, device=device)  # p(0) = 0
        prev_flat = S.pack(u0, p0)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def solve_oseen(prev_flat, u_lin, time):
        prev_u, prev_p = S.unpack(prev_flat)
        rhs = rhs_matrix.vmult_slice(prev_u, prev_p) + assemble_force(time)
        x0 = prev_flat.expand(T, -1)
        res = fgmres(lambda v: matrix.vmult(v, u_lin=u_lin, mode="form"),
                     rhs, x0, precondition=precond or (lambda v: v),
                     maxiter=gmres_maxiter, abstol=1e-12, reltol=rel_tol)
        return rhs, x0, res

    detj = float(np.prod(mesh.h))
    time, iters, acc = 0.0, [], torch.zeros(7, dtype=F64)
    prev_slab_u = prev_slab_start = None
    while time < end_time - 1e-12 and (n_slabs_max is None
                                       or len(iters) < n_slabs_max):
        with scope("step", sync=device):
            if E_extra is not None and prev_slab_u is not None:
                src = torch.cat([prev_slab_start[None], prev_slab_u])
                u_lin = torch.einsum("ij,j...->i...", E_extra, src)
            else:
                u_lin = S.unpack(prev_flat)[0].expand(
                    (T, dim) + S.dof_shape_u)
            for i in range(n_picard):
                with scope("picard", sync=device):
                    rhs, x0, res = solve_oseen(prev_flat, u_lin, time)
                if on_slab is not None:
                    on_slab(dict(matrix=matrix, u_lin=u_lin, rhs=rhs, x0=x0,
                                 x=res.x, stats=res, time=time,
                                 time_step=tau, preconditioner=precond,
                                 picard=i,
                                 resolve=lambda p=prev_flat, ul=u_lin,
                                 t=time: solve_oseen(p, ul, t)))
                u_lin = S.unpack(res.x)[0]
        if not res.converged:
            raise RuntimeError(f"FGMRES stalled at t={time}: "
                               f"{res.iterations} iterations, residual "
                               f"{res.residual:.3e}")
        iters.append(res.iterations)
        u_time, p_time = S.unpack(res.x)
        means = p_time[..., 0].sum(dim=tuple(range(1, dim + 1))) * detj
        p_time = p_time.clone()
        p_time[..., 0] -= means.reshape((T,) + (1,) * dim)
        prev_u, prev_p = S.unpack(prev_flat)
        _add_errors(acc, err.evaluate(time, tau, u_time, p_time, prev_u,
                                      prev_p, n_timesteps_at_once).cpu())
        prev_slab_start, prev_slab_u = prev_u, u_time
        prev_flat = S.pack(u_time[-1], p_time[-1])
        time += n_timesteps_at_once * tau
    return _cycle_result(mesh, S, T, iters, acc)


def dfg_square_mesh(refinement: int = 1, dim: int = 2, vertex_map=None,
                    map_exact: bool = False) -> StructuredMesh:
    """The dfgBenchmarkSquare channel: a non-uniform tensor subdivision
    with the cell column around the obstacle removed (reference
    grids.h:243-323; 2D: [0,2.2]x[0,0.41], obstacle [0.15,0.25]^2; 3D:
    [0,2.5]x[0,0.41]^2, the obstacle column at x,y = (0.5, 0.2))."""
    if dim == 2:
        x_steps = [0.15, 0.1, 0.15, 0.2, 0.25, 0.3, 0.35, 0.35, 0.35]
        y_steps = [0.15, 0.1, 0.16]
        base_mask = np.ones((len(x_steps), len(y_steps)))
        base_mask[1, 1] = 0.0
        steps = [x_steps, y_steps]
    else:
        x_steps = [0.3, 0.15, 0.1, 0.15, 0.25, 0.25, 0.25, 0.25, 0.25,
                   0.25, 0.3]
        y_steps = [0.15, 0.1, 0.16]
        z_steps = [0.41 / 3] * 3
        base_mask = np.ones((len(x_steps), len(y_steps), len(z_steps)))
        base_mask[2, 1, :] = 0.0
        steps = [x_steps, y_steps, z_steps]
    cm = base_mask
    for d in range(dim):
        cm = np.repeat(cm, 2 ** refinement, axis=d)
    return StructuredMesh([1] * dim, [0.0] * dim, None,
                          refinement=refinement, cell_mask=cm,
                          axis_steps=steps, vertex_map=vertex_map,
                          map_exact=map_exact)


def dfg_cylinder_map(center, half_width: float = 0.05, radius: float = 0.05,
                     support: float = 0.14):
    """A smooth, compactly supported morph (x, y) -> (x, y) that carries
    the square obstacle boundary {max(|x - cx|, |y - cy|) = half_width}
    onto the circle of the given radius and is the identity from distance
    `support` on (stfem_tpu drivers/stokes.py::dfg_cylinder_map; the
    analogue of the reference's dfgBenchmark manifolds, grids.h:196-242).
    Acts on the leading two coordinates of [..., dim] float64 tensors
    (the 3D channel's z passes through); torch.func differentiates it."""
    cx, cy = center

    def fmap(x):
        dx = x[..., 0] - cx
        dy = x[..., 1] - cy
        r = torch.sqrt(torch.clamp(dx * dx + dy * dy, min=1e-30))
        m = torch.maximum(torch.abs(dx), torch.abs(dy))
        # distance along the ray to the square obstacle boundary
        r_sq = half_width * r / torch.clamp(m, min=1e-30)
        un = torch.clamp((r - r_sq) / (support - r_sq), 0.0, 1.0)
        w = 1.0 - un * un * (3.0 - 2.0 * un)     # smoothstep decay
        s = 1.0 + w * (radius - r_sq) / r
        # inside the obstacle the pure radial rescale, so the removed
        # cells deform with their boundary
        s = torch.where(r < r_sq, radius / torch.clamp(r_sq, min=1e-30), s)
        out = [cx + dx * s, cy + dy * s]
        out += [x[..., d] for d in range(2, x.shape[-1])]
        return torch.stack(out, dim=-1)

    return fmap


def dfg_cylinder_mesh(refinement: int = 1, dim: int = 2,
                      map_exact: bool = True) -> StructuredMesh:
    """The DFG cylinder channel (reference gridDescriptor dfgBenchmark):
    the dfgBenchmarkSquare grid morphed so that the obstacle is the
    cylinder of diameter 0.1 at (0.2, 0.2) (2D; x,y = (0.5, 0.2) through
    z in 3D)."""
    center = (0.2, 0.2) if dim == 2 else (0.5, 0.2)
    return dfg_square_mesh(refinement, dim,
                           vertex_map=dfg_cylinder_map(center),
                           map_exact=map_exact)


def run_dfg_square(refinement: int = 1, fe_degree: int = 1,
                   type_: TimeStepType = TimeStepType.DG,
                   viscosity: float = 1e-3, u_mean: float = 0.2,
                   dfg_benchmark: int = 3, end_time: float = 8.0,
                   tau: float = 1.0 / 16.0, n_slabs: int = 4,
                   preconditioner_factory=None, gmres_maxiter: int = 100,
                   rel_tol: float = 1e-8, cylinder: bool = False,
                   weak_obstacle: bool = False, device="cuda", timer=None,
                   on_slab=None) -> dict:
    """Flow around the obstacle (the DFG 2D benchmark's geometry,
    reference tests/tp_03stokes.cc + stokes_dfg.json): weak (Nitsche)
    inflow with the DFG parabolic profile (sin(pi t / 8) for
    dfg_benchmark 3, else a 0.1 s ramp), weak no-slip walls, a do-nothing
    outflow and the strongly eliminated obstacle, from rest, one step of
    tau per slab, n_slabs slabs (end_time does not cut the march, as in
    stfem_tpu).  cylinder: the dfgBenchmark grid (the curved cylinder
    through the exact map) instead of dfgBenchmarkSquare.  weak_obstacle:
    the obstacle's no-slip by Nitsche terms on its (curved) faces, the
    reference's scheme (operators.h:1658-1751), its boundary dofs free;
    the factory's ctx carries the flag.  timer and on_slab as in
    run_stokes_cycle.

    Returns dict(iterations (per slab), u, p (the last block, NumPy),
    mesh, time, drag_lift [n_slabs, dim] (scaled by 2 / (D u_mean^2 H),
    D = 0.1, H = 0.41), divergence (per slab), tau, n_dofs, n_blocks)."""
    device = torch.device(device)
    scope = timer.scope if timer is not None else (lambda *a, **k:
                                                   nullcontext())
    dim = 2
    is_cgp = type_ == TimeStepType.CGP
    u_degree, p_degree = fe_degree + 1, fe_degree
    n_q = u_degree + 1
    T = fe_degree if is_cgp else fe_degree + 1
    u_max = u_mean * 1.5   # 2D (reference stokes.h:41)
    weak_faces = ((0, 0), (1, 0), (1, 1))   # inflow + both walls
    free_faces = ((0, 1),)                   # do-nothing outflow
    with scope("setup"):
        mesh = dfg_cylinder_mesh(refinement) if cylinder \
            else dfg_square_mesh(refinement)
        S = StokesOperator(mesh, u_degree, p_degree, n_q, viscosity,
                           device=device, weak_faces=weak_faces,
                           free_faces=free_faces, weak_obstacle=weak_obstacle)
        Mu = LaplaceMassOperator(mesh, u_degree, n_q, 1.0, 0.0,
                                 device=device, mask=S.mask_u_np)
        a, b, g, z = get_fe_time_weights(type_, fe_degree, tau, 1)
        matrix = StokesSystemMatrix(S, Mu, a, b)
        rhs_matrix = StokesSystemMatrix(S, Mu, a, b,
                                        gamma=g if is_cgp else None,
                                        zeta=z if is_cgp else g, type_=type_)

        def g_inflow(coords, t):
            y, x = coords[..., 1], coords[..., 0]
            if dfg_benchmark == 3:
                factor = float(np.sin(np.pi * t / 8.0))
            else:
                factor = (0.5 - 0.5 * float(np.cos(10.0 * np.pi * t))
                          if t < 0.1 else 1.0)
            prof = 4.0 * u_max * y * (0.41 - y) / 0.41 ** 2
            gx = torch.where(x < 1e-8, prof * factor, 0.0)
            return torch.stack([gx, torch.zeros_like(gx)], dim=-1)

        t_off, Wn = _time_rows(type_, fe_degree, tau, 1)
        Wn = torch.as_tensor(Wn, dtype=F64, device=device)

        def assemble_nitsche_rhs(time):
            rows = [S.pack(*S.nitsche_rhs(g_inflow, time + float(dt)))
                    for dt in t_off]
            return Wn @ torch.stack(rows)

        precond = None
        if preconditioner_factory is not None:
            ctx = dict(mesh=mesh, fe_degree=fe_degree, u_degree=u_degree,
                       p_degree=p_degree, type_=type_, viscosity=viscosity,
                       n_timesteps_at_once=1, time_step=tau, n_q=n_q,
                       refinement=refinement, weak_faces=weak_faces,
                       free_faces=free_faces, weak_obstacle=weak_obstacle,
                       device=device)
            with scope("setup:gmg"):
                precond = preconditioner_factory(ctx)
        from ..ops.functionals import (compute_divergence_norm,
                                       compute_drag_lift)
        # the reference's drag/lift scale 2 / (D u_mean^2 H)
        # (tp_03stokes.cc:914-917)
        dl_scale = 2.0 / (0.1 * u_mean ** 2 * 0.41)
        u_mask_flat = torch.cat([
            S.mask_u.expand((dim,) + S.dof_shape_u).reshape(-1),
            torch.ones(S.n_p, dtype=F64, device=device)])
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    def solve_slab(prev_flat, time):
        prev_u, prev_p = S.unpack(prev_flat)
        rhs = (rhs_matrix.vmult_slice(prev_u, prev_p)
               + assemble_nitsche_rhs(time))
        x0 = prev_flat.expand(T, -1)
        res = fgmres(matrix.vmult, rhs, x0,
                     precondition=precond or (lambda v: v),
                     maxiter=gmres_maxiter, abstol=1e-12, reltol=rel_tol)
        return rhs, x0, res

    prev_flat = torch.zeros(S.n_u + S.n_p, dtype=F64, device=device)
    time, iters, rows = 0.0, [], []
    for _ in range(n_slabs):
        with scope("step", sync=device):
            rhs, x0, res = solve_slab(prev_flat, time)
        if not res.converged:
            raise RuntimeError(f"FGMRES stalled at t={time}: "
                               f"{res.iterations} iterations, residual "
                               f"{res.residual:.3e}")
        if on_slab is not None:
            on_slab(dict(matrix=matrix, rhs=rhs, x0=x0, x=res.x, stats=res,
                         time=time, time_step=tau, preconditioner=precond,
                         resolve=lambda p=prev_flat, t=time: solve_slab(p,
                                                                        t)))
        iters.append(res.iterations)
        # the eliminated (obstacle) dofs zeroed: the drag reads them
        u_time, p_time = S.unpack(res.x * u_mask_flat)
        rows.append(torch.cat([
            compute_drag_lift(S, u_time[-1], p_time[-1], dl_scale),
            compute_divergence_norm(S, u_time[-1])[None]]).cpu())
        prev_flat = S.pack(u_time[-1], p_time[-1])
        time += tau
    u, p = S.unpack(prev_flat)
    rows = torch.stack(rows).numpy() if rows else np.zeros((0, dim + 1))
    return dict(iterations=iters, u=u.cpu().numpy(), p=p.cpu().numpy(),
                mesh=mesh, time=time, drag_lift=rows[:, :dim],
                divergence=[float(v) for v in rows[:, dim]], tau=tau,
                n_dofs=S.n_u + S.n_p, n_blocks=T)

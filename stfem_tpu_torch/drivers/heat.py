"""The tp_01 heat and wave cycle (counterpart of stfem_tpu/drivers/heat.py;
the reference's tests/tp_01.cc): one call = one (refinement, degree)
cycle -- build the mesh, operators, tables and preconditioner, march the
slabs, accumulate the error norms, write the probes.

Ported: the heat equation (DG and CGP) with an optional coefficient
field, initial value and rhs override, and the acoustic wave (DG and
CGP, the Schur-reduced u-solve with the velocity recovered per slab);
the space-time error norms against the manufactured solution (or
exact_override), point probes, a timer, and one binary VTK file of the
slab's last time block per slab.  Strong inhomogeneous Dirichlet data
and mesh distortion are not ported and raise.
Everything runs on `device` (the card unless the caller asks for the
CPU)."""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from ..errors import ErrorCalculator
from ..integrators import ForceAssembler, TimeIntegratorFO, TimeIntegratorWave
from ..mesh.grid import StructuredMesh
from ..ops.spatial import LaplaceMassOperator
from ..problems import heat as heat_problem
from ..system import SystemMatrix
from ..time.tables import get_fe_time_weights, get_fe_time_weights_wave
from ..types import ProblemType, TimeStepType
from ..utils.vtk import write_vtk


def stmg_preconditioner_factory(dtype=torch.float32, params=None,
                                **build_kwargs):
    """A preconditioner_factory building the STMG V-cycle (a float32
    preconditioner under the FP64 outer solve, tp_01.cc:801-806) on the
    cycle's device, with the cycle's coefficient on every level."""
    from ..stmg.gmg import build_stmg

    def factory(ctx):
        return build_stmg(ctx["mesh"], ctx["fe_degree"], ctx["space_degree"],
                          ctx["type_"], ctx["n_timesteps_at_once"],
                          ctx["time_step"], params=params, dtype=dtype,
                          device=ctx["device"], problem=ctx["problem"],
                          laplace_coefficient=ctx.get("coefficient"),
                          **build_kwargs)

    return factory


@dataclass
class CycleResult:
    n_cells: int
    n_dofs: int
    n_blocks: int
    n_timesteps: int
    total_iterations: int
    avg_iterations: float
    slab_iterations: list
    solution: torch.Tensor        # the last time block's field
    l2_l2: float = 0.0            # error norms (compute_errors)
    linf_linf: float = -1.0
    l2_h1: float = 0.0

    @property
    def st_dofs(self):
        return self.n_timesteps * self.n_dofs * self.n_blocks


def run_heat_cycle(refinement: int, fe_degree: int,
                   type_: TimeStepType = TimeStepType.DG,
                   problem: ProblemType = ProblemType.heat,
                   n_timesteps_at_once: int = 2,
                   subdivisions=(1, 1), lower=(0.0, 0.0), upper=(1.0, 1.0),
                   end_time: float = 1.0, frequency: float = 1.0,
                   preconditioner_factory=None, gmres_maxiter: int = 100,
                   rel_tol: float = 1e-12, extrapolate: bool = True,
                   distort_grid: float = 0.0, coefficient=None,
                   compute_errors: bool = True, initial_fn=None,
                   rhs_fn_override=None, do_output: bool = False,
                   output_prefix: str = "solution",
                   timer=None, dirichlet_g=None, exact_override=None,
                   initial_v_fn=None, probe_points=None,
                   functionals_path: str | None = None,
                   device="cuda", on_slab=None) -> CycleResult:
    """One tp_01 cycle (reference tp_01.cc:56-725).

    preconditioner_factory(ctx) -> callable builds the preconditioner from
    the cycle context dict; None runs unpreconditioned FGMRES.
    initial_fn(coords), initial_v_fn(coords) (wave) and
    rhs_fn_override(pts, t) take float64 tensors of points [..., dim] on
    `device`; exact_override = (exact_fn, exact_grad_fn) replaces the
    manufactured solution in the error norms (and as the initial value).
    timer: an optional utils.timer.TimerOutput, given the scopes "setup"
    (everything before the time loop), "setup:gmg" (the preconditioner)
    and "step" (one slab solve, synchronized).  on_slab(integrator, time,
    time_step, prev_x, x, stats), if given, is called after each slab,
    outside the timed scope (chip_smoke.py's independent residual check
    and profiled slab).  do_output writes the last time block of each slab
    n (from 1) on the dof grid to {output_prefix}_{n:04d}.vtk."""
    if dirichlet_g is not None or distort_grid != 0.0:
        raise NotImplementedError("inhomogeneous Dirichlet data and mesh "
                                  "distortion are not ported")
    device = torch.device(device)
    f64 = torch.float64
    scope = timer.scope if timer is not None else (lambda *a, **k:
                                                   nullcontext())
    dim = len(subdivisions)
    wave = problem == ProblemType.wave
    is_cgp = type_ == TimeStepType.CGP
    space_degree = fe_degree + 1
    n_q = space_degree + 1
    nt_dofs = fe_degree if is_cgp else fe_degree + 1
    n_blocks = nt_dofs * n_timesteps_at_once
    f = frequency
    if exact_override is not None:
        exact_fn, exact_grad_fn = exact_override
    else:
        exact_fn = lambda p, t: heat_problem.exact_solution(p, t, f)
        exact_grad_fn = lambda p, t: heat_problem.exact_gradient(p, t, f)

    with scope("setup"):
        mesh = StructuredMesh(subdivisions, lower, upper,
                              refinement=refinement)
        # reference tp_01.cc:87,105-108: the step from the UNREFINED cell
        # size; short horizons get one step
        spc_step = mesh.coarse_cell_diameter / np.sqrt(dim)
        n_steps = max(int(end_time / spc_step), 1)
        time_step = end_time * 2.0 ** (-(refinement + 1)) / n_steps

        K = LaplaceMassOperator(mesh, space_degree, n_q, 0.0, 1.0,
                                dtype=f64, device=device,
                                coefficient=coefficient)
        M = LaplaceMassOperator(mesh, space_degree, n_q, 1.0, 0.0,
                                dtype=f64, device=device)
        Alpha_1, Beta_1, Gamma_1, Zeta_1 = get_fe_time_weights(
            type_, fe_degree, time_step, 1)
        if wave:
            A_lhs, B_lhs, rhs_uK, rhs_uM, rhs_vM = get_fe_time_weights_wave(
                type_, Alpha_1, Beta_1, Gamma_1, Zeta_1, n_timesteps_at_once)
            matrix = SystemMatrix(K, M, A_lhs, B_lhs)
            rhs_matrix = SystemMatrix(K, M, rhs_uK, rhs_uM)
            rhs_matrix_v = SystemMatrix(K, M, np.zeros_like(rhs_vM), rhs_vM)
            rhs_fn = lambda p, t: heat_problem.wave_rhs(p, t, f)
        else:
            Alpha, Beta, Gamma, Zeta = get_fe_time_weights(
                type_, fe_degree, time_step, n_timesteps_at_once)
            matrix = SystemMatrix(K, M, Alpha, Beta)
            rhs_matrix = SystemMatrix(
                K, M, Gamma if is_cgp else np.zeros_like(Gamma),
                Zeta if is_cgp else Gamma)
            rhs_fn = lambda p, t: heat_problem.rhs(p, t, f)
        rhs_fn = rhs_fn_override or rhs_fn
        force = ForceAssembler(mesh, space_degree, n_q, rhs_fn, K.mask_np,
                               dtype=f64, device=device)
        precond = None
        if preconditioner_factory is not None:
            ctx = dict(mesh=mesh, fe_degree=fe_degree,
                       space_degree=space_degree, type_=type_,
                       n_timesteps_at_once=n_timesteps_at_once,
                       time_step=time_step, problem=problem, n_q=n_q,
                       refinement=refinement, coefficient=coefficient,
                       device=device)
            with scope("setup:gmg"):
                precond = preconditioner_factory(ctx)
        if wave:
            step = TimeIntegratorWave(type_, fe_degree, Alpha_1, Beta_1,
                                      Gamma_1, Zeta_1, rel_tol, matrix,
                                      precond, rhs_matrix, rhs_matrix_v,
                                      force, n_timesteps_at_once,
                                      extrapolate, maxiter=gmres_maxiter)
        else:
            step = TimeIntegratorFO(type_, fe_degree, Alpha_1, Gamma_1,
                                    rel_tol, matrix, precond, rhs_matrix,
                                    force, n_timesteps_at_once, extrapolate,
                                    maxiter=gmres_maxiter)
        # the reference under-integrates the error norms with
        # QGauss(fe_degree + 1) (its ErrorCalculator gets the time degree
        # as space degree, tp_01.cc:809-815): kept for golden parity
        err = (ErrorCalculator(mesh, type_, fe_degree, space_degree,
                               exact_fn, exact_grad_fn, n_q=fe_degree + 1,
                               device=device)
               if compute_errors else None)
        coords = torch.as_tensor(mesh.dof_coordinates(space_degree),
                                 dtype=f64, device=device)
        # initial value: nodal interpolation of the exact solution at t = 0
        prev_x = (initial_fn(coords).to(f64) if initial_fn is not None
                  else exact_fn(coords, 0.0))
        prev_v = None
        if wave:
            prev_v = (initial_v_fn(coords).to(f64) if initial_v_fn
                      is not None else heat_problem.wave_exact_v(coords, 0.0,
                                                                 f))

        # point probes -> functionals file (reference tp_01.cc:449-481,
        # 584-635); appends across cycles like the reference
        pe = writer = None
        if probe_points is not None:
            from ..utils.probes import FunctionalsWriter, PointEvaluator
            pe = PointEvaluator(mesh, space_degree, probe_points)
            writer = FunctionalsWriter(functionals_path, type_, fe_degree)
            prev_probe = pe(prev_x)
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    time, iters = 0.0, []
    l2 = h1 = 0.0
    linf = -1.0
    while time < end_time - 1e-12:
        with scope("step", sync=device):
            if wave:
                x, v, stats = step.solve_wave(prev_x, prev_v, time,
                                              time_step)
            else:
                x, stats = step.solve(prev_x, time, time_step)
        if not stats.converged:
            raise RuntimeError(f"FGMRES stalled at t={time}: {stats}")
        # the constrained dofs take their (zero) Dirichlet value, as the
        # reference's constraints.distribute() sets them: the operator
        # never reads them, so FGMRES leaves rounding noise there
        x = x * K.mask
        if on_slab is not None:
            on_slab(step, time, time_step, prev_x, x, stats)
        iters.append(stats.iterations)
        if err is not None:
            e = err.evaluate_error(time, time_step, x, prev_x,
                                   n_timesteps_at_once)
            # one host sync per slab for the three norms
            el2, eh1, elinf = torch.stack(
                [e["l2"], e["h1_semi"], e["linf"]]).tolist()
            l2, h1, linf = l2 + el2, h1 + eh1, max(linf, elinf)
        if pe is not None:
            vals = pe(x)                            # (n_blocks, n_points)
            for it in range(n_timesteps_at_once):
                pv = vals[it * nt_dofs:(it + 1) * nt_dofs]
                writer.write_step(time + it * time_step, time_step, pv,
                                  prev_probe if is_cgp else None)
                prev_probe = pv[-1]
        prev_x = x[-1]
        if wave:
            prev_v = v[-1]
        time += n_timesteps_at_once * time_step
        if do_output:
            # reference tp_01.cc:636-644, stfem_tpu drivers/heat.py:241-246
            write_vtk(f"{output_prefix}_{len(iters):04d}.vtk",
                      mesh.dof_coordinates(space_degree),
                      prev_x.cpu().numpy())

    return CycleResult(
        n_cells=mesh.n_cells, n_dofs=mesh.n_dofs(space_degree),
        n_blocks=n_blocks, n_timesteps=len(iters),
        total_iterations=sum(iters), avg_iterations=sum(iters) / len(iters),
        slab_iterations=iters, solution=prev_x, l2_l2=float(np.sqrt(l2)),
        linf_linf=linf, l2_h1=float(np.sqrt(h1)))

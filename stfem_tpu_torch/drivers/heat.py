"""The tp_01 heat cycle (counterpart of stfem_tpu/drivers/heat.py; the
reference's tests/tp_01.cc): one call = one (refinement, degree) cycle --
build the mesh, operators, tables and preconditioner, march the slabs,
write the probes.

Ported for first-order problems: the heat equation with an optional
coefficient field, initial value and rhs override, point probes and a
timer.  The wave problem, strong inhomogeneous Dirichlet data, mesh
distortion, error norms (errors.py) and VTK output are not ported and
raise.  Everything runs on `device` (the card unless the caller asks for
the CPU)."""
from __future__ import annotations

from contextlib import nullcontext
from dataclasses import dataclass

import numpy as np
import torch

from ..integrators import ForceAssembler, TimeIntegratorFO
from ..mesh.grid import StructuredMesh
from ..ops.spatial import LaplaceMassOperator
from ..problems import heat as heat_problem
from ..system import SystemMatrix
from ..time.tables import get_fe_time_weights
from ..types import ProblemType, TimeStepType


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
                   timer=None, dirichlet_g=None, probe_points=None,
                   functionals_path: str | None = None,
                   device="cuda", on_slab=None) -> CycleResult:
    """One tp_01 cycle (reference tp_01.cc:56-725).

    preconditioner_factory(ctx) -> callable builds the preconditioner from
    the cycle context dict; None runs unpreconditioned FGMRES.
    initial_fn(coords) and rhs_fn_override(pts, t) take float64 tensors
    of points [..., dim] on `device`.  timer: an optional
    utils.timer.TimerOutput, given the scopes "setup" (everything before
    the time loop), "setup:gmg" (the preconditioner) and "step" (one slab
    solve, synchronized).  on_slab(integrator, time, time_step, prev_x, x,
    stats), if given, is called after each slab, outside the timed scope
    (chip_smoke.py's independent residual check and profiled slab)."""
    if problem != ProblemType.heat:
        raise NotImplementedError("the wave cycle is not ported")
    if dirichlet_g is not None or distort_grid != 0.0:
        raise NotImplementedError("inhomogeneous Dirichlet data and mesh "
                                  "distortion are not ported")
    if compute_errors or do_output:
        raise NotImplementedError("error norms (errors.py) and VTK output "
                                  "are not ported")
    device = torch.device(device)
    f64 = torch.float64
    scope = timer.scope if timer is not None else (lambda *a, **k:
                                                   nullcontext())
    dim = len(subdivisions)
    is_cgp = type_ == TimeStepType.CGP
    space_degree = fe_degree + 1
    n_q = space_degree + 1
    nt_dofs = fe_degree if is_cgp else fe_degree + 1
    n_blocks = nt_dofs * n_timesteps_at_once

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
        Alpha_1, _, Gamma_1, _ = get_fe_time_weights(type_, fe_degree,
                                                     time_step, 1)
        Alpha, Beta, Gamma, Zeta = get_fe_time_weights(
            type_, fe_degree, time_step, n_timesteps_at_once)
        matrix = SystemMatrix(K, M, Alpha, Beta)
        rhs_matrix = SystemMatrix(K, M,
                                  Gamma if is_cgp else np.zeros_like(Gamma),
                                  Zeta if is_cgp else Gamma)
        f = frequency
        rhs_fn = rhs_fn_override or (lambda p, t: heat_problem.rhs(p, t, f))
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
        step = TimeIntegratorFO(type_, fe_degree, Alpha_1, Gamma_1, rel_tol,
                                matrix, precond, rhs_matrix, force,
                                n_timesteps_at_once, extrapolate,
                                maxiter=gmres_maxiter)
        coords = torch.as_tensor(mesh.dof_coordinates(space_degree),
                                 dtype=f64, device=device)
        if initial_fn is not None:
            prev_x = initial_fn(coords).to(f64)
        else:
            prev_x = heat_problem.exact_solution(coords, 0.0, f)

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
    while time < end_time - 1e-12:
        with scope("step", sync=device):
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
        if pe is not None:
            vals = pe(x)                            # (n_blocks, n_points)
            for it in range(n_timesteps_at_once):
                v = vals[it * nt_dofs:(it + 1) * nt_dofs]
                writer.write_step(time + it * time_step, time_step, v,
                                  prev_probe if is_cgp else None)
                prev_probe = v[-1]
        prev_x = x[-1]
        time += n_timesteps_at_once * time_step

    return CycleResult(
        n_cells=mesh.n_cells, n_dofs=mesh.n_dofs(space_degree),
        n_blocks=n_blocks, n_timesteps=len(iters),
        total_iterations=sum(iters), avg_iterations=sum(iters) / len(iters),
        slab_iterations=iters, solution=prev_x)

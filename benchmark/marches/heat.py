"""The march of the configurations whose problemType is "heat": the
user's application, a closed-loop march of heat slabs through the port's
public library calls, one flow, each slab starting from the previous
slab's last time block.

Per slab (inside the measured window, nothing untimed):
  1. the FP64 force of the slab's time blocks (`ForceAssembler.batched`);
  2. the float32 rhs: the previous value through the rhs operator plus
     the force rounded to float32;
  3. the first solve: preconditioned Richardson (`richardson_solve`) with
     the bf16 STMG V-cycle (`build_stmg(..., bench_params(...))`) to
     rtol1;
  4. `ir_passes` iterative-refinement passes: the FP64 residual
     (`SlabResidual64`, kernels K2 and K3), a float32 Richardson
     correction solve of the unit-scaled residual to ir_rtol, and the
     FP64 update;
  5. the carry: the slab's last time block, in FP64 and float32.
rtol1 and ir_rtol come from a probe solve of the first slab run to its
float32 floor.  The composition is that of bench_heat.run, kept here so
that the yardstick does not move with the library.  It differs in three
places: the float32 rhs takes the FP64 force rounded (one assembly a
slab, and times in FP64 however long the march); the force scales are
the FP64 time masses; and the first solve stops relative to its rhs, as
the floor is measured, with the two solves' tolerances split evenly
(`March.probe`): bench_heat's rtol1 = 1.4 floor, relative to the first
residual, lies under the float32 floor of one slab in ten to twenty,
which then runs to maxiter.

`Program` is everything that does not depend on the seed (operators,
hierarchy, residual); `march(program, traffic, seed)` is one seeded run
of it.  Spans are torch.profiler record_function ranges, on only while a
stretch is traced.  The interface that `benchmark/cell.py` drives is
described in `benchmark/marches/__init__.py`.
"""
from __future__ import annotations

import contextlib
import time

import numpy as np
import torch

from stfem_tpu_torch.integrators import ForceAssembler
from stfem_tpu_torch.krylov import richardson_solve
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.kronfac import KronAssembled
from stfem_tpu_torch.ops.slab_residual import SlabResidual64
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.stmg.gmg import bench_params, build_stmg
from stfem_tpu_torch.system import SystemMatrix
from stfem_tpu_torch.time.tables import get_fe_time_weights, get_time_quad
from stfem_tpu_torch.types import SupportedSmoothers, TimeStepType

from .. import data as slab_data
from ..cell import sync
from ..reference.heat_slab import HeatSlabReference

F32, F64 = torch.float32, torch.float64
SPANS = ("slab", "force", "rhs", "first_solve", "vcycle", "fp64_residual",
         "correction_solve", "carry")


def cells_of(config: dict) -> list[int]:
    return [int(s) * 2 ** int(config["refinement"])
            for s in config["subdivisions"]]


def gmg_params(config: dict):
    kw = dict(config["solver"]["gmg"])
    if "smoother" in kw:
        kw["smoother"] = SupportedSmoothers[kw["smoother"]]
    return bench_params(**kw)


def reference_for(config: dict, device) -> HeatSlabReference:
    return HeatSlabReference(
        cells_of(config), config["hyperRectLowerLeft"],
        config["hyperRectUpperRight"], config["space_degree"],
        config["space_quadrature_points"], config["time_degree"],
        config["timeStepSize"], config["nTimestepsAtOnce"],
        config["laplace_coefficient"], device=device)


class Program:
    """The seed-independent part of a configuration: float32 and FP64
    operators, the slab and rhs matrices, the STMG hierarchy and the FP64
    residual.  timings["hierarchy_build_s"] is build_stmg's wall
    (synchronized)."""

    def __init__(self, config: dict, device):
        if config["problemType"] != "heat" or config["timeType"] != "DG":
            raise ValueError("the march runs dG heat configurations")
        self.config = config
        self.device = torch.device(device)
        self.k = int(config["space_degree"])
        self.r = int(config["time_degree"])
        self.n_q = int(config["space_quadrature_points"])
        self.tau = float(config["timeStepSize"])
        self.n_steps = int(config["nTimestepsAtOnce"])
        coef = float(config["laplace_coefficient"])
        self.mesh = StructuredMesh(list(config["subdivisions"]),
                                   list(config["hyperRectLowerLeft"]),
                                   list(config["hyperRectUpperRight"]),
                                   refinement=int(config["refinement"]))
        ops = {dt: (LaplaceMassOperator(self.mesh, self.k, self.n_q, 0.0,
                                        coef, dtype=dt, device=self.device),
                    LaplaceMassOperator(self.mesh, self.k, self.n_q, 1.0,
                                        0.0, dtype=dt, device=self.device))
               for dt in (F32, F64)}
        K, M = ops[F32]
        self.mask_np = K.mask_np
        Alpha, Beta, Gamma, _ = get_fe_time_weights(
            TimeStepType.DG, self.r, self.tau, self.n_steps)
        self.matrix = SystemMatrix(K, M, Alpha, Beta)
        self.rhs_matrix = SystemMatrix(K, M, np.zeros_like(Gamma), Gamma)
        sync(self.device)
        t0 = time.perf_counter()
        self.gmg = build_stmg(self.mesh, self.r, self.k, TimeStepType.DG,
                              self.n_steps, self.tau, gmg_params(config),
                              dtype=F32, device=self.device)
        sync(self.device)
        self.timings = {"hierarchy_build_s": time.perf_counter() - t0}
        self.resid = SlabResidual64(KronAssembled(*ops[F64], F64),
                                    self.mask_np, Alpha, Beta, Gamma)
        n_blocks = Alpha.shape[0]
        self.shape = (n_blocks,) + tuple(self.mesh.dof_shape(self.k))
        self.dofs_per_slab = int(np.prod(self.shape))
        tq = get_time_quad(TimeStepType.DG, self.r)[0]
        nt = len(tq)
        self.nt = nt
        self.t_rows = torch.as_tensor(
            [self.tau * (row // nt + float(tq[row % nt]))
             for row in range(n_blocks)], dtype=F64, device=self.device)
        self.scales = torch.as_tensor(np.diag(Alpha).copy(), dtype=F64,
                                      device=self.device)
        self.slab_duration = self.tau * self.n_steps

    def free(self) -> None:
        """Drop the program's device state (before the reference runs)."""
        for name in ("gmg", "matrix", "rhs_matrix", "resid"):
            setattr(self, name, None)


def march(program: Program, traffic: dict, seed: int,
          ir_passes: int | None = None) -> "March":
    """One seeded march of `program` under the traffic mix."""
    data = slab_data.make(seed, traffic, program.slab_duration)
    return March(program, data, ir_passes)


class March:
    """One seeded march of `program`: set up its force, probe the
    tolerances and solve slab after slab (`slab()`).  ir_passes = 0 is the
    program's float32-only path (the control).  `vcycles` counts the
    calls of the V-cycle callable handed to the solver and `vcycle_host_s`
    the host's time inside them (the enqueue, and any wait in it)."""

    def __init__(self, program: Program, data: slab_data.SlabData,
                 ir_passes: int | None = None):
        self.p = program
        self.data = data
        self.config = cfg = program.config
        solver = cfg["solver"]
        self.maxiter = int(solver["maxiter"])
        self.ir_passes = (int(solver["ir_passes"]) if ir_passes is None
                          else int(ir_passes))
        dev = program.device
        self.device = dev
        self.force = ForceAssembler(program.mesh, program.k, program.n_q,
                                    slab_data.ForcingField(data.forcing),
                                    program.mask_np, dtype=F64, device=dev)
        self.u0 = slab_data.initial_state(data, cells_of(cfg), program.k,
                                          dev)
        self.vcycles = 0
        self.vcycle_host_s = 0.0
        self.solves = []    # per slab: (first, correction...) SolveResults
        self.spans = False
        self.index = 0
        self.prev64 = self.u0
        self.prev32 = self.u0.to(F32)
        self.rtol1 = self.ir_rtol = self.probe_floor = None
        self.probe_vcycles = 0

    @property
    def start(self) -> torch.Tensor:
        """What the next slab starts from (the previous end value)."""
        return self.prev64

    def tail(self, x: torch.Tensor) -> torch.Tensor:
        """The part of slab solution x that the next slab starts from."""
        return x[-self.p.nt:].clone()

    def reset_counters(self) -> None:
        self.vcycles, self.vcycle_host_s = 0, 0.0

    def span(self, name: str):
        return (torch.profiler.record_function(name) if self.spans
                else contextlib.nullcontext())

    def vcycle(self, r: torch.Tensor) -> torch.Tensor:
        self.vcycles += 1
        t0 = time.perf_counter()
        with self.span("vcycle"):
            out = self.p.gmg.vmult(r)
        self.vcycle_host_s += time.perf_counter() - t0
        return out

    def slab_force(self, index: int) -> torch.Tensor:
        t = self.p.t_rows + index * self.p.slab_duration
        return self.force.batched(t, self.p.scales)

    def _rhs(self, f64: torch.Tensor) -> torch.Tensor:
        with self.span("rhs"):
            return self.p.rhs_matrix.vmult(self.prev32[None]) + f64.to(F32)

    def _first_solve(self, f64: torch.Tensor, bound: float):
        """The float32 first solve from the previous value: stop at
        ||r|| <= bound ||rhs||."""
        rhs = self._rhs(f64)
        abstol = bound * float(torch.linalg.vector_norm(rhs.reshape(-1)))
        with self.span("first_solve"):
            return richardson_solve(self.p.matrix.vmult, rhs,
                                    self.prev32.expand(self.p.shape),
                                    self.vcycle, maxiter=self.maxiter,
                                    reltol=0.0, abstol=abstol)

    def _stall_solve(self, f64: torch.Tensor, gate: float):
        """The first solve's Richardson iteration from the previous value,
        run until a step no longer lowers the float32 residual once that
        is at most gate times the rhs (its float32 floor is reached; the
        first steps from the previous value may lower it only a little,
        or raise it) or to maxiter."""
        rhs = self._rhs(f64)
        A = self.p.matrix.vmult
        norm = lambda v: float(torch.linalg.vector_norm(v.reshape(-1)))
        below = gate * norm(rhs)
        x = self.prev32.expand(self.p.shape)
        r = rhs - A(x)
        res = norm(r)
        for _ in range(self.maxiter):
            x = x + self.vcycle(r)
            r = rhs - A(x)
            new = norm(r)
            if new >= res and res <= below:
                break
            res = new
        return x

    def probe(self) -> dict:
        """Solve slab 0 in float32 to its stall (watched once the residual
        is under max_floor); its TRUE FP64 residual relative to the rhs is
        the float32 floor.  With refinement the
        reduction to ir_target splits evenly between the two solves,
        neither asked for less than rtol1_factor times the floor:
        rtol1 = max(sqrt(ir_target), rtol1_factor floor) (relative to the
        rhs) and ir_rtol = ir_target / rtol1, so that the refined residual
        is at most ir_target wherever both solves reach their tolerance.
        Without (the float32 path) the first solve goes to
        rtol1_factor floor.  -> {"floor", "rtol1", "ir_rtol", "vcycles"}."""
        pr = self.config["solver"]["probe"]
        f64 = self.slab_force(0)
        n0 = self.vcycles
        xp = self._stall_solve(f64, float(pr["max_floor"]))
        self.probe_vcycles = self.vcycles - n0
        _, rn, bn = self.p.resid.residual(self.prev64, xp.to(F64), f64)
        floor = float(rn) / float(bn)
        if not floor <= float(pr["max_floor"]):
            raise RuntimeError(f"the float32 Richardson probe stalls at "
                               f"rel {floor:.3e}: the V-cycle is not "
                               "contractive on this slab")
        self.probe_floor = floor
        near = float(pr["rtol1_factor"]) * floor
        if self.ir_passes == 0:
            self.rtol1 = near
        else:
            target = float(pr["ir_target"])
            self.rtol1 = max(target ** 0.5, near)
            self.ir_rtol = target / self.rtol1
        return {"floor": floor, "rtol1": self.rtol1, "ir_rtol": self.ir_rtol,
                "vcycles": self.probe_vcycles}

    def slab(self):
        """Solve the next slab -> (index, its FP64 solution, the converged
        flags of its solves)."""
        i = self.index
        with self.span("slab"):
            with self.span("force"):
                f64 = self.slab_force(i)
            res = self._first_solve(f64, self.rtol1)
            x64, ok = res.x.to(F64), bool(res.converged)
            stats = [res]
            for _ in range(self.ir_passes):
                with self.span("fp64_residual"):
                    r, rn, _ = self.p.resid.residual(self.prev64, x64, f64)
                with self.span("correction_solve"):
                    c = richardson_solve(
                        self.p.matrix.vmult, (r / rn).to(F32),
                        torch.zeros(self.p.shape, dtype=F32,
                                    device=self.p.device),
                        self.vcycle, maxiter=self.maxiter,
                        reltol=self.ir_rtol)
                x64 = x64 + rn * c.x.to(F64)
                ok = ok and bool(c.converged)
                stats.append(c)
            with self.span("carry"):
                self.prev64 = x64[-1].contiguous()
                self.prev32 = self.prev64.to(F32)
        self.index += 1
        self.solves.append([(s.iterations, bool(s.converged),
                             float(s.residual)) for s in stats])
        return i, x64, ok

    def free(self) -> None:
        """Drop the march's and the program's device state; the data and
        the configuration stay for `judge`."""
        self.force = None
        self.prev32 = None
        self.p.free()

    def judge(self, judged: list) -> dict:
        """{check name: {"value", "limit"}}: the reference's TRUE relative
        residual of each judged (label, slab index, solution, what it
        started from: the initial state or the previous slab's tail)."""
        config = self.config
        limit = float(config["accuracy"]["true_rel_residual_max"])
        ref = reference_for(config, self.device)
        duration = config["timeStepSize"] * config["nTimestepsAtOnce"]
        out = {}
        for label, index, x, before in judged:
            u_prev = (before if before.ndim == x.ndim - 1
                      else ref.end_value(before))
            rel = ref.residual(x, u_prev, self.data.forcing,
                               index * duration)["rel"]
            out[f"res_{label}"] = {"value": rel, "limit": limit}
        return out

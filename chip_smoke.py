#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (stfem_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises and exits non-zero):
  1. device: nvidia-smi name and power limit, torch and CUDA versions;
  2. build: nvcc builds the hand-written kernels from csrc/, one process
     per source, in parallel (-Xptxas -v);
  3. K1 parity: time_solve kernel vs its plain torch version at the bench
     shape (S=32, nt=3, N=512,000), bf16 and f32, at the coefficient
     path's cell-local Vanka shapes (S=8, nt=3 and S=4, nt=2 at
     N=262,144), f32, at the distorted path's finest cell-mode level
     (S=2, nt=2, N=32^3 x 27), f32, and at nt=5 (dG(4), S=2, N=96^3),
     f32, with both times;
  4. K2 parity: kron_pair kernel vs its plain torch version at n=65, k=4,
     B=128 in float64, with both times and the share of the bound;
  4b. K3 parity: banded_apply kernel vs its plain torch version along each
     of the three axes at B=128 x 65^3, k=4 (the heat factors) and at the
     Stokes shape 3 x 17^3, k=2 (the Stokes velocity factors), float64,
     with both times and the time of one dense matmul with the assembled
     1D matrix (the library yardstick), each per axis with the kernel's
     ratio to the matmul and its share of the bound; the kernels line
     carries the axis where that ratio is worst and every axis's times.
     Also Q5's k=5 (the 3D pairs K2 does not take) at 8 x 11^3 and
     8 x 81^3;
  5. K4 parity: the grid chain (chain_down, then chain_up) vs its plain
     torch version with Vanka cell-blocked matrices at the heat fine level
     (96 x 65^3 <-> 80^3) and the wave fine level (48 x 33^3 <-> 40^3),
     bf16 and f32, with both times, the einsum of the same dense matrices
     (the library yardstick; library_ms in the kernels line) and the
     kernel's ratio to it and share of the bound;
  5b. K5 parity: the quadrature middle vs its plain torch version at the
     coefficient path's outer-operator shape (T=24, C=4096, A=64, PhiG
     64 x 256 and W 4096 x 256 from the 16^3 Q3 route-3 tables), float64
     (relative 1e-12) and float32 (1e-5), and at its rhs-slice shape
     (T=3) in float64, with both times, the cuBLAS yardstick (the same
     four products as torch.matmul calls with the weight multiply between
     them, in the kernels line as library_ms) and the bound (FP64
     operations at the tensor-core rate), with the kernel's ratio to
     cuBLAS and its share of the bound;
  6. small-input checks: the heat and the wave solve at 4^3 cells,
     ntao=4 on the GPU against the same solve on the CPU (plain torch
     kernels) and against the exact solution; the Stokes solve at 4^3
     cells, ntao=4 on the GPU against the CPU (relative 1e-6, V-cycles
     within 1, TRUE <= 1e-8 on both); the tp_01 practical mode reduced to
     4^3 cells, 2 steps per slab, 2 slabs, on the GPU against the CPU
     (both converged, FGMRES iterations within 1, relative 1e-8);
  7. heat main path: bench_heat at its defaults (16^3 cells, 32 steps per
     slab) for the probe plus 2 timed slabs and one profiled, untimed
     slab; every slab must reach a TRUE relative residual <= 1e-8, and
     K1, K2 and K4 (both chains) must each launch in this run; the
     profiled slab's launches and device ms of K4, K2, K1 and K3;
  8. wave main path: bench_wave at its defaults (8^3 cells, 16 steps per
     slab) for the probe plus 1 timed slab (2 until phase 19) and one
     profiled, untimed slab; every slab must reach TRUE <= 1e-8, the
     probe's recovered v
     must agree with the dense FP64 oracle to < 1e-9, and K2 and K4 (both
     chains) must each launch in this run;
  9. Stokes main path: bench_stokes at its defaults (8^3 cells, 8 steps
     per slab) for the two probe slabs plus 1 timed slab (2 until phase
     19) and one profiled, untimed slab; every slab must reach TRUE <=
     1e-8 and K2 and
     K3 must each launch in this run.  K3 (the rhs coupling's M x) must
     launch on the heat and wave paths too.
 10. coefficient main path: drivers/tp01.run_single on
     configs/tp01_practical_3d.json (16^3 cells, Q3 x dG(2), 8 steps per
     slab, 4 slabs, distorted coefficient, FP64 FGMRES with the f32
     V-cycle), then one more slab under the profiler; per slab the FGMRES
     iterations, the slab wall (TimerOutput "step") and space-time DoF/s,
     and the mean DoF/s over the slabs that took FGMRES iterations.
     Every slab's true FP64 residual, evaluated through the GridSumFac
     route (no code shared with K5), must meet FGMRES's own stop test
     ||r|| <= max(abstol, reltol ||r0||) within a factor 2; K5 and K1 must
     each launch in this run.
 11. tp_01 convergence mode (drivers/tp01.py, errors.py) with the STMG
     V-cycle at GMGParams' defaults: (a) the 2D golden cells -- heat DG(1)
     refinements 2 and 3, heat CGP(2) refinement 2, wave DG(1) 4 steps
     at once refinement 2 -- each error within 2e-5 of the reference
     golden and the mean FGMRES iterations within stfem_tpu's bounds;
     (b) configs/tp01_convergence_3d_heat_dg1.json (4^3..32^3, Q2 x dG(1))
     and configs/tp01_convergence_3d_wave_cgp2.json (4^3..16^3, Q3 x
     CGP(2)) through run_config, with their tables; per refinement the
     slab walls, iterations, space-time DoF/s, setup and K1-K4 launches;
     every slab converges, the L2-L2 rate between the two finest
     refinements is >= 1.8 (heat) and >= 2.5 (wave), each kernel the path
     uses launches at the finest refinement, and the last heat slab is
     profiled again; (c) heat DG(1) refinement 2, wave CGP(2) refinement 1
     and heat CGP(4) (Q5: the K3 route, K1 at nt 4) refinement 1 on the
     card against the CPU, every norm within 1e-8 relative.
 12. the tp_03stokes application (drivers/tp03stokes.py, drivers/stokes.py;
     2D Q2 x DGP1, FP64 FGMRES with the f32 Stokes V-cycle at GMGParams'
     defaults, smoothing range 5): (a) the golden cells DG(1) refinements
     1 and 2, every norm within 2e-5 of the reference golden (Hdiv 2e-4)
     and the mean iterations at most golden + 2; (b)
     configs/tp03stokes_convergence_2d_dg1.json (4^2..64^2 cells, 4 steps
     per slab) through run_config with its table, per refinement the slab
     walls, iterations, space-time DoF/s and setup, every slab converged
     and an L2-L2(u) rate >= 1.8 between the two finest refinements; (c)
     configs/tp03stokes_lid_2d.json (the Nitsche lid-driven cavity at
     256^2 cells, 1,445,892 unknowns per slab) for 2 slabs (4 until the
     smoke took phase 16, 3 until phase 19): per slab the
     iterations, wall, DoF/s, and a true FP64 residual (StokesSystemMatrix
     .vmult) within 2x of FGMRES's stop test; the functionals file's rows
     have 6 finite columns; the last slab again and one V-cycle alone
     under the profiler (device busy share, launches per V-cycle); (d)
     DG(1) and CGP(1) refinement 2 and the weak lid at refinement 3 (2
     slabs; u, p and the functionals rows) on the card against the CPU
     within 1e-8, iterations within 1.
     The path runs none of K1-K5 (launches_by_path "tp03stokes": zeros).
 13. the DFG channel of tp_03stokes (drivers/tp03stokes.py::run_practical
     on configs/tp03stokes_dfg_2d.json: 2D Q2 x DGP1, dG(1), weak inflow
     and walls, do-nothing outflow, strong obstacle): (a) the
     dfgBenchmarkSquare grid at refinement 5 (288 x 96 cells, 611,332
     unknowns a slab) for 3 slabs (4 until phase 19): per slab the
     iterations, wall, DoF/s, a true FP64 residual within 2x of FGMRES's
     stop test, c_D, c_L and the divergence norm; the setup, the
     hierarchy setup and the peak device memory; the last slab again and
     one V-cycle alone under the
     profiler; (b) the cylinder (gridDescriptor dfgBenchmark) for 1 slab
     (2 until phase 16), the same lines without the profile; (c) both
     grids at
     refinement 2 (2 slabs) on the card against the CPU: u and p within
     1e-8 of their largest entry, c_D and c_L within 1e-8 relative,
     iterations within 1.  The path runs none of K1-K5 (launches_by_path
     "dfg": zeros).
 14. the solver options (configs/*_chebyshev.json: "smoother" chebyshev,
     "smoothingSteps" 2, "smoothingRange" 5 and, for tp_01,
     "coarseGridSmootherType" GMRES; otherwise the configs of phases 10-12):
     (a) tp_01 practical mode at 16^3 as phase 10, with each level's theta
     and delta and one V-cycle under the profiler; K1 and K5 must launch;
     the V-cycle's wall with the GMRES coarse solve's host read-back
     against the same V-cycle with it replayed on the device (also at
     16^3 in (b));
     (b) tp_01 convergence, heat DG(1) at 16^3 (32^3 too until phase 17)
     through run_config: the slab walls, iterations, DoF/s, setup and
     launches, each norm within 1e-4 relative of phase 11b's Relaxation
     run (two preconditioners stopped at rel 1e-12 leave different
     iterates), K1 and both K4 chains launching; the GMRES coarse solve
     runs on the 1-cell Q2 level (one free dof a block: GMRES breaks down
     after two iterations and the minimum-norm solve is exact); (c) the
     256^2 lid for 1 slab (2 until phase 16): per slab the iterations, wall,
     DoF/s and the true FP64 residual within 2x of the stop test, u on
     the free dofs and p (up to the enclosed flow's constant) within 1e-7
     of phase 12c's (of their largest entry) and the functionals rows
     within 1e-7; the coarse level goes to the pseudo-inverse by the
     routing rule; (d) the 2D heat DG(1) golden cell at refinement 2
     with (a)'s keys (its GMRES coarse level, 1-cell Q1, has no free dof:
     the defect is zero) and the weak lid at refinement 3 (2 slabs) with
     (c)'s on the card against the CPU within 1e-8, iterations within 1.
     launches_by_path gains "chebyshev practical", "chebyshev
     convergence" (the 16^3 sweep) and "chebyshev stokes" (the 256^2
     lid), each without (d)'s launches.
 15. the distorted-mesh heat path (drivers/heat.py::run_heat_cycle with
     distort_grid, the "cell" operator route, the cell-mode Vanka on
     every level) and the repaired gates: (a) a 3D Q4 mesh with graded
     steps on every axis (16^3 cells, 8 time blocks): SystemMatrix.vmult
     (route "kron", K2) and a 2D vmult_slice (K3) against the operators'
     own apply within 1e-12 relative in FP64, K2 and K3 launching, and
     one grid-mode Vanka apply (K4, K1) within 1e-5 of its plain version;
     (b) run_heat_cycle in 3D, Q2 x dG(1), 2 steps a slab, distortion
     0.15, 32^3 cells (1,098,500 unknowns a slab), 1 slab (2 until the
     smoke passed 1000 s): per slab the
     FGMRES iterations, an FP64 true residual through masked element
     matrices within 2x of FGMRES's stop test, the wall, K1's launches
     and, from the slab solved again under the profiler, K1's device time
     and the busy share; the levels' routes and Vanka modes and one
     V-cycle under the profiler; K1 must launch (launches_by_path
     "distorted": this run's alone); (c) the same cycle at 4^3 on the
     card and on the CPU: its FP64 slab operator and rhs coupling on the
     same inputs within 1e-13, the card's V-cycle given the CPU's
     omegas (its own printed beside them), one float32 V-cycle within
     1e-5, equal FGMRES iterations, the solutions and l2 norms within
     1e-10; (d) the bench
     Stokes hierarchy and phase 17's FE_Q hierarchy at 32^2 each built
     twice, one V-cycle of each bitwise equal, and bench_stokes once more
     with phase 9's first-slab V-cycles.
 16. nonlinear and weak-obstacle Stokes (drivers/stokes.py::
     run_navier_stokes_cycle: Picard / Oseen solves in the operator's
     "form" mode; run_dfg_square(weak_obstacle=True): the Nitsche
     obstacle): (a) stfem_tpu's Navier cells, DG(1) at refinements 1 and
     2 (n_picard 2, tests/test_stokes.py:21-27's V-cycle): the error
     norms, iterations and slab walls, the mean iterations within 1.5 of
     stfem_tpu's CPU counts and the L2-L2(u) rate > 2.0; DG(2) at
     refinement 1 with the Polynomial predictor against the Constant one
     (l2 within 1e-3, iterations at most + 2); (b) the 256^2 Navier path
     (2D Q2 x DGP1, DG(1), 1,445,892 unknowns a slab, tau 2^-9, 3 Picard
     solves a slab, 1 slab (2 until phase 19)): per solve the iterations
     and wall, per slab
     a true FP64 Oseen residual (StokesSystemMatrix.vmult(mode="form") at
     the last u_lin) within 2x of FGMRES's stop test; the setup and the
     errors; one "form" apply and one "none" apply (element route), the
     last solve again and one V-cycle under the profiler; (c) the weak
     obstacle on the dfgBenchmarkSquare grid at refinement 5 (611,332
     unknowns a slab), 2 slabs: per slab the iterations, wall, true
     residual within 2x of the stop test, c_D, c_L, the divergence norm
     and c_D's distance from phase 13(a)'s strong obstacle (finite; the 2%
     criterion of stfem_tpu's test beside it); (d) Navier-Stokes at
     refinement 1 and the weak square and cylinder at refinement 2 (1
     slab) on the card against the CPU within 1e-8, iterations within 1,
     and the weak square twice on the card, bitwise.  The paths run none
     of K1-K5 (launches_by_path "navier" and "weak obstacle": zeros).
 17. the continuous (FE_Q, Taylor-Hood Q2/Q1) pressure and strong
     inhomogeneous Dirichlet heat: (a) drivers/stokes.py::
     run_stokes_cycle(dg_pressure=False, nitsche_boundary=True), DG(1),
     4 steps a slab, refinements 2-6 (4^2..64^2; 300,056 unknowns a slab
     at 64^2), stfem_tpu's test_feq_pressure_stmg V-cycle: per
     refinement the iterations a slab, slab walls, setup with the patch
     pseudo-inverses' share, u and p L2-L2 errors and one V-cycle's
     launches, the rates between whole refinements (u > 2.0, p > 1.5);
     (b) refinements 1 and 2, one step at once, the card's iterations and
     norms the CPU's (1e-8), the CPU's stfem_tpu's (FEQ_CPU);
     (c) run_heat_cycle with tp_01's 3D heat DG(1) discretisation on
     [0.25, 1.25]^3 with heat "solution 2" as dirichlet_g and the lift,
     4^3..32^3: per slab a true FP64 residual against the lifted rhs
     within 2x of the stop test, the constrained dofs equal to g (1e-12),
     the L2-L2 rate >= 1.8, K1-K4 launching at the finest refinement.
     FEQ_CUTS and DIRICHLET_CUTS list the refinements whose march is cut.
 18. bench.py's switches (switches_phase): (a) bench_heat.run at 8^3
     cells, 8 steps a slab, the probe and 1 timed slab, at the defaults,
     with outer fgmres, with ir off (the float32-only FGMRES to a Givens
     1e-8), with outer chebyshev, with nopost_fine and post_inner 1,
     variable with vcap 2, smoothall, and the bf16 Vanka on float32
     levels (K4's float32-vector, bf16-matrix instance, also held against
     its plain version): the iterations and walls, every IR slab at TRUE
     <= 1e-8, K1-K4 launching (launches_by_path "switches"); (b) python
     -m stfem_tpu_torch.bench at heat 8^3, wave 4^3, Stokes 4^3, 1 slab
     each, in a subprocess: exit 0, all three sections in the summary,
     the heat metric last; (c) the bench's 16^3 heat hierarchy built
     twice with a fresh estimate cache: no estimate the second time,
     bitwise-equal omegas, both setup times; (d) a one-rank NCCL group:
     make_sharded_vmult bitwise SystemMatrix.vmult, psum_dot the plain
     dot.  Phases 1-17 run with STFEM_EIG_CACHE=0 (no estimate cache);
     18(a) and (b) share a fresh cache file (the cases whose levels are
     alike estimate once), 18(c) has its own.
 19. the sharded whole solve (sharded_phase; parallel/minibench.py
     through parallel/dryrun.py): 8 gloo processes share the card, each
     computing its slab there, the halo planes and scalar reductions
     staged through the host -- a correctness result, not a scaling
     figure.  (a) stfem_tpu's dry-run size, cells 8, ntao 8 (24 blocks x
     33^3, 862,488 unknowns) on the (2, 2, 2) mesh: converged (TRUE <=
     1e-8), iteration parity with rank 0's single-device run, the
     gathered solution within minibench.SOLUTION_RTOL of rank 0's
     single-device one, halo exchanges > 0 and all-reduces <= max(100,
     exchanges // 4) (the budget of tests/test_multichip_bench.py, read
     as call counts); the slab walls and K1/K2/K4 launches summed over
     the ranks (launches_by_path "sharded", from (a) and (b)); (b) the
     headline size, cells 16, ntao 32 (96 blocks x 65^3, 26.4 M
     unknowns): TRUE <= 1e-8, parity and the solution, both walls.
     After each of (a) and (b), in this process, K2 on the residual's
     pair input of a rank's sub-mesh (rel 1e-14) and, on every sharded
     level, the sliced Vanka's K4 down, K1 and K4 up (rel 1e-5) against
     their plain versions at the shapes and with the matrices the path
     gives them (sharded_kernel_checks).  (c) a one-rank NCCL group running
     (a)'s solve in this process: the same iterations and the solution
     bitwise the unsharded one's, no collective.  Its estimates go
     through a fresh cache file that (a) fills and (c) reads.
Then it prints the smoke's total wall, the nvidia-smi line, a JSON line
describing the kernels (launches over all main paths and by path), and,
last, {"ok": true, "device": {...}}.  Without a CUDA device, or
without the stfem_tpu_torch package beside it, it exits non-zero and
prints no result.
"""
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np


def _smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    idx = os.environ.get("CUDA_VISIBLE_DEVICES", "0").split(",")[0]
    return out[int(idx)] if idx.isdigit() and int(idx) < len(out) else out[0]


def _cuda_ms(fn, n: int) -> float:
    """Mean device time of fn() over n runs (CUDA events, after a warm-up
    run)."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


# NVIDIA H100 SXM data sheet: HBM3 3.35 TB/s; FP32 67 TFLOP/s outside the
# tensor cores; FP64 67 TFLOP/s on the tensor cores (DMMA; 34 outside them)
HBM_BPS, PEAK_FLOPS = 3.35e12, {"f32": 67e12, "f64": 67e12}


def _bound(n_bytes: float, flops: float, kind: str):
    """(bound_ms, bound_by): the least time for this work on the card --
    the larger of the bytes over the memory rate and the operations over
    the peak rate of their type."""
    t_bytes, t_ops = n_bytes / HBM_BPS, flops / PEAK_FLOPS[kind]
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _vanka_band(nc: int, k: int, gen, dev):
    """A random (nc(k+1), nc k + 1) matrix with the Vanka down band: row
    c(k+1)+a reads dofs ck..ck+k (stmg/vanka.py)."""
    import torch
    m = torch.zeros((nc * (k + 1), nc * k + 1), device=dev)
    for c in range(nc):
        m[c * (k + 1):(c + 1) * (k + 1), c * k:c * k + k + 1] = torch.randn(
            (k + 1, k + 1), generator=gen, device=dev)
    return m


# reference tests/tp_01.output (linf, l2, h1; None: not in the repository)
# and stfem_tpu's own bounds on the mean FGMRES iterations
# (tests/test_heat_endtoend.py:12-15, :55-57; tests/test_stmg.py:16-45;
# SURVEY.md:382: heat DG(1) 7 / 9 + 1.05)
GOLDEN_2D = [
    ("heat DG(1) ref 2", dict(refinement=2, fe_degree=1, kind="DG",
                              problem="heat", n_at_once=2),
     False, (5.53197e-02, 1.78760e-02, 1.35366e-01), 8.05),
    ("heat DG(1) ref 3", dict(refinement=3, fe_degree=1, kind="DG",
                              problem="heat", n_at_once=2),
     False, (9.41838e-03, 3.24200e-03, 2.66020e-02), 10.05),
    ("heat CGP(2) ref 2", dict(refinement=2, fe_degree=2, kind="CGP",
                               problem="heat", n_at_once=2),
     False, (4.36348e-03, 1.57444e-03, 1.16973e-02), 14.0),
    ("wave DG(1) ref 2", dict(refinement=2, fe_degree=1, kind="DG",
                              problem="wave", n_at_once=4),
     True, (7.45999e-02, 2.07852e-02, None), 13.0)]

# the slabs of the earlier phases' marches, each cut by one when phase 19
# came (the smoke passed 950 s): the wave and Stokes benches' timed slabs
# (phases 8-9 and 15(d)), the 256^2 lid (12(c)), the DFG square (13(a)),
# the 256^2 Navier cycle (16(b)); FEQ_CUTS and DIRICHLET_CUTS below
MAIN_CUTS = {"wave": 1, "stokes": 1, "lid": 2, "dfg square": 3, "navier": 1}

K_NAMES = (("K1", ("time_solve",)), ("K2", ("kron_pair",)),
           ("K3", ("banded_apply",)), ("K4", ("chain_down", "chain_up")))


def _k_counts(wrappers) -> dict:
    """K1-K4 launches since the counts were last set to 0."""
    return {k: sum(wrappers[n].launches for n in names)
            for k, names in K_NAMES}


def _vanka_levels(gmg) -> str:
    """Which levels of a V-cycle run K1 (a multi-step Vanka), which the
    dense per-position T x T solve, and which are Identity levels."""
    k1, dense, ident = [], [], []
    for lvl, level in enumerate(gmg.levels):
        vanka = getattr(level.smoother, "precond", None)
        if vanka is None:
            ident.append(lvl)
        else:
            (k1 if vanka.n_steps > 1 else dense).append(lvl)
    return (f"K1 on levels {k1}, dense T x T on {dense}, Identity {ident} "
            f"of 0..{len(gmg.levels) - 1}")


def practical_phase(wrappers, dev, path, label, vcycle=False) -> dict:
    """Phase 10 (and 14a): tp_01 practical mode through
    drivers/tp01.run_single on the config at `path` (16^3 cells, 4 slabs),
    then slab 0 again under the profiler and, with vcycle, each level's
    smoother parameters and one V-cycle under the profiler.  Per slab the
    FGMRES iterations, wall, DoF/s and the true FP64 residual through the
    GridSumFac route (no code shared with K5), which must meet FGMRES's
    stop test within a factor 2.  Returns the launches of every wrapper
    over the run (set to 0 first)."""
    import torch
    from stfem_tpu_torch import bench_heat
    from stfem_tpu_torch.config import Parameters
    from stfem_tpu_torch.drivers import tp01
    from stfem_tpu_torch.system import SystemMatrix
    from stfem_tpu_torch.time.tables import get_fe_time_weights
    from stfem_tpu_torch.types import TimeStepType
    from stfem_tpu_torch.utils.timer import TimerOutput

    for w in wrappers.values():
        w.launches = 0
    timer, slabs = TimerOutput(), []
    with tempfile.TemporaryDirectory() as tmpd:
        p = Parameters.parse(str(path), 3)
        p.functional_file = os.path.join(tmpd, "functionals.txt")
        wall0 = time.time()
        res = tp01.run_single(p, p.fe_degree, p.refinement, timer=timer,
                              device="cuda",
                              on_slab=lambda *a: slabs.append(a))
        wall = time.time() - wall0
        counts = {name: w.launches for name, w in wrappers.items()}
        with open(p.functional_file) as f:
            n_rows = sum(1 for line in f if line.strip())
    st_dofs = res.n_blocks * res.n_dofs
    walls = timer.times["step"]
    print(f"# {label} 16^3 Q3 ntao=8 ({st_dofs} space-time DoFs per "
          f"slab): setup {timer.totals['setup']:.2f} s (hierarchy "
          f"{timer.totals['setup:gmg']:.2f} s), phase wall {wall:.1f} s, "
          f"{n_rows} functionals rows", flush=True)
    # untimed: each slab's true FP64 residual through the GridSumFac route
    integ = slabs[0][0]
    K, M = integ.matrix.K, integ.matrix.M
    Al, Be, Ga, _ = get_fe_time_weights(TimeStepType.DG, p.fe_degree,
                                        slabs[0][2], p.n_timesteps_at_once)
    A_grid = SystemMatrix(K, M, Al, Be, route="grid")
    R_grid = SystemMatrix(K, M, np.zeros_like(Ga), Ga, route="grid")
    ok, rhs0 = True, None
    for i, ((_, t, dt, prev, x, stats), w) in enumerate(zip(slabs, walls)):
        rhs = R_grid.vmult(prev[None]) + integ.assemble_force(t, dt)
        rhs0 = rhs if rhs0 is None else rhs0
        rn = float((rhs - A_grid.vmult(x)).norm())
        r0 = float((rhs - A_grid.vmult(integ._extrapolate(prev))).norm())
        tol = max(integ.abstol, integ.reltol * r0)
        print(f"# {label} slab {i}: FGMRES iterations {stats.iterations}"
              f", slab wall {w:.4f} s, {st_dofs / w:.4e} space-time DoF/s; "
              f"true FP64 ||r|| {rn:.3e} (/||rhs|| {rn / float(rhs.norm()):.3e}"
              f", /||r0|| {rn / r0:.3e}) vs FGMRES tol {tol:.3e}, Givens "
              f"estimate {stats.residual:.3e}", flush=True)
        ok = ok and stats.converged and rn <= 2.0 * tol
    # slab 0 again: the later slabs' fields have decayed below FGMRES's
    # abstol and take no iteration
    _, t, dt, prev, _, _ = slabs[0]
    prof = bench_heat.profile_slab(lambda: integ.solve(prev, t, dt), dev,
                                   top=1000)
    k5 = [r for r in prof["top_kernels_ms"] if "quad_middle" in r[0]]
    print(f"# {label}: profile of slab 0 again (untimed): K5 "
          f"{k5} (launches, device ms); device busy "
          f"{prof['device_busy_s']:.4f} s of {prof['wall_s']:.4f} s wall "
          f"(share {prof['device_busy_share']:.4f}), "
          f"{prof['n_kernel_launches']} launches, trace stop "
          f"{prof['exit_s']:.2f} s, summary {prof['summary_s']:.2f} s; top "
          f"kernels (ms) {prof['top_kernels_ms'][:6]}; top ops (ms) "
          f"{prof['top_ops_ms'][:6]}", flush=True)
    if vcycle:
        gmg = integ.preconditioner
        print(f"# {label}: {_smoother_levels(gmg)}; coarse solve "
              f"{gmg.coarse}", flush=True)
        v = rhs0 / rhs0.norm()
        vprof = bench_heat.profile_slab(lambda: gmg(v), dev, top=8)
        port = vprof["port_kernels_ms"]
        print(f"# {label}: one V-cycle alone (untimed): "
              f"{vprof['n_kernel_launches']} launches, "
              f"{vprof['wall_s']:.4f} s wall, device busy share "
              f"{vprof['device_busy_share']:.4f}; K1 {port['time_solve']}, "
              f"K5 {port['quad_middle']} (launches, device ms); top ops "
              f"(ms) {vprof['top_ops_ms'][:5]}", flush=True)
        if gmg.coarse not in ("Direct", "Smoother"):
            _readback_ab(gmg, v, label)
    # slabs whose extrapolated start already meets abstol do no solve work
    busy = [w for (*_, stats), w in zip(slabs, walls) if stats.iterations]
    print(f"# {label} launches {counts}; slabs {len(walls)}, of which "
          f"{len(busy)} took FGMRES iterations: mean over those "
          f"{st_dofs * len(busy) / max(sum(busy), 1e-30):.4e} space-time "
          f"DoF/s", flush=True)
    if not (ok and len(walls) == 4):
        raise AssertionError(f"{label} path: a slab missed its residual")
    del slabs, integ, A_grid, R_grid
    torch.cuda.empty_cache()
    return counts


def _readback_ab(gmg, v, label, pairs=3) -> None:
    """One V-cycle of gmg with the GMRES coarse solve's host read-back
    (krylov._least_squares) against the same V-cycle with the read-back
    taken out: the least-squares solutions of a recorded V-cycle replayed
    on the device, so the launches stay and the host never waits.  Host
    wall of each (synchronized), `pairs` alternating pairs after the
    recording; the saving bounds what any read-back-free solve could
    gain."""
    import torch
    from stfem_tpu_torch import krylov

    solve, ys, pos = krylov._least_squares, [], [0]

    def record(H, beta):
        ys.append(solve(H, beta))
        return ys[-1]

    def replay(H, beta):
        pos[0] += 1
        return ys[(pos[0] - 1) % len(ys)]

    def timed(fn):
        krylov._least_squares = fn
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = gmg(v)
        torch.cuda.synchronize()
        return time.perf_counter() - t0, out

    try:
        _, ref = timed(record)
        walls = {"read-back": [], "replayed": []}
        for _ in range(pairs):
            for name, fn in (("read-back", solve), ("replayed", replay)):
                t, out = timed(fn)
                walls[name].append(t)
    finally:
        krylov._least_squares = solve
    diff = float((out - ref).norm() / ref.norm())
    a, b = (float(np.median(walls[n])) for n in ("read-back", "replayed"))
    print(f"# {label}: GMRES coarse read-back A/B over {pairs} pairs of one "
          f"V-cycle ({len(ys)} coarse solve(s) a V-cycle): with the host "
          f"read-back {[round(t, 4) for t in walls['read-back']]} s, "
          f"replayed on the device {[round(t, 4) for t in walls['replayed']]}"
          f" s; median saving {a - b:.4f} s ({(a - b) / a:.2%} of the "
          f"V-cycle); replayed V-cycle vs recorded {diff:.2e}", flush=True)


def _smoother_levels(gmg) -> str:
    """Each level's smoother and its parameters (theta, delta or omega)."""
    out = []
    for lvl, level in enumerate(gmg.levels):
        sm = level.smoother
        if hasattr(sm, "theta"):
            out.append(f"{lvl}: Chebyshev({sm.degree}) theta {sm.theta:.6g} "
                       f"delta {sm.delta:.6g}")
        elif hasattr(sm, "omega"):
            out.append(f"{lvl}: Relaxation({sm.n_iterations}) omega "
                       f"{sm.omega:.6g}")
        else:
            out.append(f"{lvl}: Identity")
    return "levels " + ", ".join(out)


def _sweep(p, name, wrappers, reset):
    """tp01.run_config on p on the card, printing per refinement the slab
    walls, iterations, space-time DoF/s, setup and K1-K4 launches.
    Returns (results by (k, ref), per-refinement rows, the finest slab's
    integrator state, wall); each row ends with the raw launches of every
    wrapper."""
    from stfem_tpu_torch.drivers import tp01
    from stfem_tpu_torch.utils.timer import TimerOutput

    timer, state, rows = TimerOutput(), {"setup": 0.0, "steps": 0}, []
    last = {}

    def on_cycle(k, ref, res):
        walls = timer.times["step"][state["steps"]:]
        setup = timer.totals["setup"] - state["setup"]
        state.update(setup=timer.totals["setup"],
                     steps=len(timer.times["step"]))
        counts = _k_counts(wrappers)
        raw = {n: w.launches for n, w in wrappers.items()}
        reset()
        st = res.n_blocks * res.n_dofs
        rows.append((ref, res.n_cells, st, res.slab_iterations,
                     sum(walls) / len(walls),
                     st * len(walls) / sum(walls), setup, counts, raw))
        print(f"# tp01 3D {name} ref {ref}: {res.n_cells} cells, {st} "
              f"space-time DoFs per slab, {len(walls)} slabs, FGMRES "
              f"iterations {res.slab_iterations}, slab wall mean "
              f"{sum(walls) / len(walls):.4f} s (max {max(walls):.4f}),"
              f" {st * len(walls) / sum(walls):.4e} space-time DoF/s, "
              f"setup {setup:.2f} s, launches {counts}", flush=True)

    def on_slab(integ, t, dt, prev, x, stats):
        last.update(integ=integ, t=t, dt=dt, prev=prev)

    reset()
    t0 = time.time()
    results = tp01.run_config(p, device="cuda", timer=timer,
                              on_cycle=on_cycle, on_slab=on_slab)
    return results, rows, last, time.time() - t0


def tp01_convergence(wrappers, dev, norms=None) -> dict:
    """Phase 11: tp_01's convergence mode on the card (drivers/tp01.py,
    drivers/heat.py, errors.py) -- (a) the 2D golden cells with the STMG
    preconditioner at GMGParams' defaults, (b) the two committed 3D
    configurations through run_config, (c) small 3D cells on the card
    against the CPU.  Returns the launches of every wrapper over the
    phase; raises on any failed check.  Sets the counts to 0 first.
    norms, if given, receives (b)'s (linf, l2, h1) by (name, ref)."""
    import torch
    from stfem_tpu_torch import bench_heat
    from stfem_tpu_torch.config import Parameters
    from stfem_tpu_torch.drivers import tp01
    from stfem_tpu_torch.drivers.heat import (run_heat_cycle,
                                              stmg_preconditioner_factory)
    from stfem_tpu_torch.stmg.gmg import GMGParams
    from stfem_tpu_torch.types import ProblemType, TimeStepType

    total = dict.fromkeys(wrappers, 0)
    for w in wrappers.values():
        w.launches = 0

    def reset():
        for name, w in wrappers.items():
            total[name] += w.launches
            w.launches = 0

    def rel(a, b):
        return abs(a / b - 1.0)

    # (a) the 2D golden cells
    for label, c, skip, golden, bound in GOLDEN_2D:
        reset()
        res = run_heat_cycle(
            refinement=c["refinement"], fe_degree=c["fe_degree"],
            type_=getattr(TimeStepType, c["kind"]),
            problem=getattr(ProblemType, c["problem"]),
            n_timesteps_at_once=c["n_at_once"], gmres_maxiter=100,
            preconditioner_factory=stmg_preconditioner_factory(
                params=GMGParams(skip_identity_levels=skip),
                fe_degree_min=1), device="cuda")
        errs = (res.linf_linf, res.l2_l2, res.l2_h1)
        worst = max(rel(e, g) for e, g in zip(errs, golden) if g)
        counts = _k_counts(wrappers)
        print(f"# tp01 2D {label}: linf {errs[0]:.6e} l2 {errs[1]:.6e} "
              f"h1 {errs[2]:.6e}, worst rel to golden {worst:.2e} (tol "
              f"2e-5); FGMRES iterations/slab {res.slab_iterations} mean "
              f"{res.avg_iterations:g} (bound {bound:g}); launches {counts}",
              flush=True)
        if not (worst <= 2e-5 and res.avg_iterations <= bound):
            raise AssertionError(f"tp01 2D {label} missed its golden")
        if not (counts["K3"] and counts["K4"]):
            raise AssertionError(f"tp01 2D {label}: K3/K4 never ran")

    # (b) the committed 3D configurations through run_config; per
    #     refinement the slab walls, iterations, DoF/s, setup, launches
    bars = {"heat_dg1": (1.8, ("K1", "K2", "K3", "K4")),
            "wave_cgp2": (2.5, ("K2", "K3", "K4"))}
    for name, path in tp01.CONVERGENCE_3D.items():
        p = Parameters.parse(str(path), 3)
        results, rows, last, wall = _sweep(p, name, wrappers, reset)
        if norms is not None:
            for (_, ref), r in results.items():
                norms[(name, ref)] = (r.linf_linf, r.l2_l2, r.l2_h1)
        l2 = [results[(p.fe_degree, r)].l2_l2
              for r in range(p.refinement, p.refinement + p.n_ref_cycles)]
        rate = float(np.log2(l2[-2] / l2[-1]))
        bar, needed = bars[name]
        used = sorted(k for k in ("K1", "K2", "K3", "K4")
                      if any(r[-2][k] for r in rows))
        print(f"# tp01 3D {name}: L2-L2 rate between the two finest "
              f"refinements {rate:.3f} (bar {bar}); kernels on this path "
              f"{used}; finest V-cycle: "
              f"{_vanka_levels(last['integ'].preconditioner)}; sweep wall "
              f"{wall:.1f} s", flush=True)
        if rate < bar:
            raise AssertionError(f"tp01 3D {name}: rate {rate} < {bar}")
        missing = [k for k in needed if not rows[-1][-2][k]]
        if missing:
            raise AssertionError(f"tp01 3D {name}: kernels never ran at "
                                 f"the finest refinement: {missing}")
        if name == "heat_dg1":
            # the last slab of the finest refinement again, profiled
            prof = bench_heat.profile_slab(
                lambda: last["integ"].solve(last["prev"], last["t"],
                                            last["dt"]), dev, top=8)
            print(f"# tp01 3D heat_dg1 finest: profile of its last slab "
                  f"again (untimed): K4 {prof['port_kernels_ms']['grid_chain']}"
                  f", K2 {prof['port_kernels_ms']['kron_pair']}, K1 "
                  f"{prof['port_kernels_ms']['time_solve']}, K3 "
                  f"{prof['port_kernels_ms']['banded_apply']} (launches, "
                  f"device ms); device busy {prof['device_busy_s']:.4f} s "
                  f"of {prof['wall_s']:.4f} s wall (share "
                  f"{prof['device_busy_share']:.4f}), "
                  f"{prof['n_kernel_launches']} launches; top ops (ms) "
                  f"{prof['top_ops_ms'][:6]}", flush=True)
        last.clear()
        del results
        torch.cuda.empty_cache()

    # (c) small 3D cells: the card against the CPU (plain kernels)
    small = [("heat_dg1", 2, {}), ("wave_cgp2", 1, {}),
             ("heat_dg1", 1, {"type": TimeStepType.CGP, "fe_degree": 4})]
    for name, ref, over in small:
        p = Parameters.parse(str(tp01.CONVERGENCE_3D[name]), 3)
        for key, val in over.items():
            setattr(p, key, val)
        label = f"{p.problem.name} {p.type.name}({p.fe_degree}) ref {ref}"
        out = {}
        for where in ("cuda", "cpu"):
            reset()
            out[where] = (tp01.run_single(p, p.fe_degree, ref, device=where),
                          _k_counts(wrappers))
        (rg, cg), (rc, _) = out["cuda"], out["cpu"]
        errs = [rel(getattr(rg, n), getattr(rc, n))
                for n in ("linf_linf", "l2_l2", "l2_h1")]
        print(f"# tp01 small 3D {label}: gpu l2 {rg.l2_l2:.10e} cpu "
              f"{rc.l2_l2:.10e}, worst rel difference of the three norms "
              f"{max(errs):.2e} (tol 1e-8); FGMRES iterations/slab gpu "
              f"{rg.slab_iterations} cpu {rc.slab_iterations}; gpu launches "
              f"{cg}", flush=True)
        if max(errs) > 1e-8:
            raise AssertionError(f"tp01 small {label}: card and CPU differ")
        if p.fe_degree == 4 and not (cg["K3"] and cg["K1"]
                                     and cg["K2"] == 0):
            raise AssertionError("tp01 small CGP(4): the Q5 pair did not "
                                 "take the K3 route with K1")
    reset()
    return total


# reference tests/tp_03stokes.output:37-41 (DG(1), Q2/DGP1; the norm
# order of STOKES_NORMS) and its mean FGMRES iterations (12)
STOKES_NORMS = ("l2_l2_u", "linf_linf_u", "l2_h1_u", "l2_hdiv_u", "l2_l2_p",
                "linf_linf_p", "l2_h1_p")
STOKES_GOLDEN = {1: ((1.65240e-02, 3.33168e-02, 2.84237e-01, 2.2158e-01,
                      3.94153e-02, 1.01821e-01, 6.16826e-01), 12),
                 2: ((3.17268e-03, 7.57276e-03, 1.05166e-01, 4.9847e-02,
                      1.83976e-02, 5.80497e-02, 3.91842e-01), 12)}


def tp03stokes_phase(wrappers, dev, lid=None) -> dict:
    """Phase 12: the tp_03stokes application on the card (drivers/
    tp03stokes.py, drivers/stokes.py, the Nitsche faces, the functionals)
    -- (a) the golden cells, (b) the convergence sweep, (c) the lid-driven
    cavity at 256^2 cells with a profiled slab, (d) small cells on the card
    against the CPU.  Returns the launches of every wrapper over the phase
    (the path runs none of K1-K5); raises on any failed check.  Sets the
    counts to 0 first.  lid, if given, receives (c)'s first two slab
    solutions ("x", on the host) and its functionals rows ("rows")."""
    import torch
    from stfem_tpu_torch import bench_heat
    from stfem_tpu_torch.config import Parameters, StokesParameters
    from stfem_tpu_torch.drivers import tp03stokes
    from stfem_tpu_torch.types import TimeStepType
    from stfem_tpu_torch.utils.timer import TimerOutput

    for w in wrappers.values():
        w.launches = 0
    extra = StokesParameters()

    def rel(a, b):
        return abs(a / b - 1.0)

    def config(path, **over):
        p = Parameters.parse(str(path), 2)
        for key, val in over.items():
            setattr(p, key, val)
        return p

    # (a) the golden cells: DG(1), one step at once, tf01stokes's V-cycle
    p1 = config(tp03stokes.CONVERGENCE_2D, n_timesteps_at_once=1)
    for ref, (golden, iters) in STOKES_GOLDEN.items():
        res = tp03stokes.run_single(p1, extra, 1, ref, device="cuda")
        errs = [getattr(res, n) for n in STOKES_NORMS]
        rels = [rel(e, g) for e, g in zip(errs, golden)]
        tols = [2e-4 if n == "l2_hdiv_u" else 2e-5 for n in STOKES_NORMS]
        print(f"# tp03stokes golden DG(1) ref {ref}: "
              f"{' '.join(f'{e:.6e}' for e in errs)} (u: L2 Linf H1 Hdiv, "
              f"p: L2 Linf H1); rel to golden "
              f"{' '.join(f'{r:.1e}' for r in rels)} (tol 2e-5, Hdiv "
              f"2e-4); FGMRES iterations/slab {res.slab_iterations} mean "
              f"{res.avg_iterations:g} (bound {iters + 2})", flush=True)
        if not (all(r <= t for r, t in zip(rels, tols))
                and res.avg_iterations <= iters + 2):
            raise AssertionError(f"tp03stokes golden ref {ref} missed")

    # (b) the convergence sweep through run_config, with its table
    p = config(tp03stokes.CONVERGENCE_2D)
    timer, state = TimerOutput(), {"setup": 0.0, "steps": 0}

    def on_cycle(k, ref, res):
        walls = timer.times["step"][state["steps"]:]
        setup = timer.totals["setup"] - state["setup"]
        state.update(setup=timer.totals["setup"],
                     steps=len(timer.times["step"]))
        st = res.n_blocks // 2 * (res.n_dofs_u + res.n_dofs_p)
        print(f"# tp03stokes sweep ref {ref}: {res.n_cells} cells, {st} "
              f"space-time DoFs per slab, {len(walls)} slabs, FGMRES "
              f"iterations {res.slab_iterations}, slab wall mean "
              f"{sum(walls) / len(walls):.4f} s (max {max(walls):.4f}), "
              f"{st * len(walls) / sum(walls):.4e} space-time DoF/s, setup "
              f"{setup:.2f} s", flush=True)

    t0 = time.time()
    results = tp03stokes.run_config(p, extra, device="cuda", timer=timer,
                                    on_cycle=on_cycle)
    l2 = [results[(1, r)].l2_l2_u
          for r in range(p.refinement, p.refinement + p.n_ref_cycles)]
    rate = float(np.log2(l2[-2] / l2[-1]))
    print(f"# tp03stokes sweep: L2-L2(u) rate between the two finest "
          f"refinements {rate:.3f} (bar 1.8); sweep wall "
          f"{time.time() - t0:.1f} s", flush=True)
    if rate < 1.8:
        raise AssertionError(f"tp03stokes sweep: rate {rate} < 1.8")
    del results
    torch.cuda.empty_cache()

    # (c) the lid-driven cavity at 256^2 cells: 2 slabs (3 until phase
    #     19), then the last again and one V-cycle under the profiler
    with tempfile.TemporaryDirectory() as tmpd:
        p = config(tp03stokes.LID_2D,
                   functional_file=os.path.join(tmpd, "functionals.txt"))
        timer, slabs = TimerOutput(), []
        t0 = time.time()
        res = tp03stokes.run_practical(p, extra, p.fe_degree, p.refinement,
                                       n_slabs_max=MAIN_CUTS["lid"],
                                       device="cuda", timer=timer,
                                       on_slab=slabs.append)
        wall = time.time() - t0
        with open(p.functional_file) as f:
            rows = [line.split() for line in f if line.strip()]
    st = res["n_blocks"] * res["n_dofs"]
    print(f"# tp03stokes lid 256^2 DG(1): {res['n_dofs']} unknowns per "
          f"block, {st} per slab; setup {timer.totals['setup']:.2f} s "
          f"(hierarchy {timer.totals['setup:gmg']:.2f} s), phase wall "
          f"{wall:.1f} s, {len(rows)} functionals rows", flush=True)
    ok = len(slabs) == MAIN_CUTS["lid"]
    for i, (s, w) in enumerate(zip(slabs, timer.times["step"])):
        m, stats = s["matrix"], s["stats"]
        rn = float((s["rhs"] - m.vmult(s["x"])).norm())
        r0 = float((s["rhs"] - m.vmult(s["x0"])).norm())
        tol = max(1e-12, p.rel_tol * r0)
        print(f"# tp03stokes lid slab {i}: FGMRES iterations "
              f"{stats.iterations}, slab wall {w:.4f} s, {st / w:.4e} "
              f"space-time DoF/s; true FP64 ||r|| {rn:.3e} (/||r0|| "
              f"{rn / r0:.3e}) vs FGMRES tol {tol:.3e}, Givens estimate "
              f"{stats.residual:.3e}", flush=True)
        ok = ok and stats.converged and rn <= 2.0 * tol
    last = slabs[-1]
    prof = bench_heat.profile_slab(last["resolve"], dev, top=8)
    v = last["rhs"] / last["rhs"].norm()
    vprof = bench_heat.profile_slab(lambda: last["preconditioner"](v), dev,
                                    top=8)
    its = last["stats"].iterations
    print(f"# tp03stokes lid: profile of slab {len(slabs) - 1} again "
          f"(untimed): device busy "
          f"{prof['device_busy_s']:.4f} s of {prof['wall_s']:.4f} s wall "
          f"(share {prof['device_busy_share']:.4f}), "
          f"{prof['n_kernel_launches']} launches over {its} FGMRES "
          f"iterations; one V-cycle alone: {vprof['n_kernel_launches']} "
          f"launches, {vprof['wall_s']:.4f} s wall, device busy share "
          f"{vprof['device_busy_share']:.4f}; top kernels (ms) "
          f"{prof['top_kernels_ms'][:5]}; top ops (ms) "
          f"{prof['top_ops_ms'][:5]}", flush=True)
    bad_rows = [r for r in rows if len(r) != 6
                or not all(np.isfinite(float(x)) for x in r)]
    if not (ok and rows and not bad_rows):
        raise AssertionError("tp03stokes lid: a slab missed its residual "
                             "or the functionals file is malformed")
    if lid is not None:
        lid.update(x=[s["x"].cpu() for s in slabs[:2]],
                   rows=np.array(rows, dtype=np.float64))
    del slabs, last, res
    torch.cuda.empty_cache()

    # (d) small cells: the card against the CPU
    for kind in ("DG", "CGP"):
        pk = config(tp03stokes.CONVERGENCE_2D, n_timesteps_at_once=1,
                    type=getattr(TimeStepType, kind))
        rg, rc = (tp03stokes.run_single(pk, extra, 1, 2, device=d)
                  for d in ("cuda", "cpu"))
        worst = max(rel(getattr(rg, n), getattr(rc, n))
                    for n in STOKES_NORMS)
        print(f"# tp03stokes small {kind}(1) ref 2: gpu l2 u "
              f"{rg.l2_l2_u:.10e} cpu {rc.l2_l2_u:.10e}, worst rel "
              f"difference of the seven norms {worst:.2e} (tol 1e-8); "
              f"FGMRES iterations/slab gpu {rg.slab_iterations} cpu "
              f"{rc.slab_iterations}", flush=True)
        if worst > 1e-8 or any(abs(a - b) > 1 for a, b in
                               zip(rg.slab_iterations, rc.slab_iterations)):
            raise AssertionError(f"tp03stokes small {kind}: card and CPU "
                                 "differ")
    with tempfile.TemporaryDirectory() as tmpd:
        out, fun = {}, {}
        for d in ("cuda", "cpu"):
            path = os.path.join(tmpd, f"f_{d}.txt")
            pl = config(tp03stokes.LID_2D, functional_file=path)
            out[d] = tp03stokes.run_practical(pl, extra, 1, 3, n_slabs_max=2,
                                              device=d)
            fun[d] = np.loadtxt(path, ndmin=2)
    worst = max(float(np.abs(out["cuda"][n] - out["cpu"][n]).max()
                      / np.abs(out["cpu"][n]).max()) for n in ("u", "p"))
    # the functionals (t, u_x(p), u_y(p), F_x, F_y, div) against the
    # largest value of their quantity: u_x at the centre and the wall's
    # normal force are rounding noise by symmetry
    m = np.abs(fun["cpu"]).max(axis=0)
    scale = np.array([m[0], *[max(m[1:3])] * 2, *[max(m[3:5])] * 2, m[5]])
    worst_f = (float((np.abs(fun["cuda"] - fun["cpu"]) / scale).max())
               if fun["cuda"].shape == fun["cpu"].shape
               and fun["cpu"].shape[1] == 6 else np.inf)
    print(f"# tp03stokes small weak lid ref 3, 2 slabs: worst difference of "
          f"u and p relative to their largest entry {worst:.2e}, of the "
          f"functionals rows relative to their quantity's largest value "
          f"{worst_f:.2e} (tol 1e-8 each); FGMRES iterations gpu "
          f"{out['cuda']['iterations']} cpu {out['cpu']['iterations']}",
          flush=True)
    if max(worst, worst_f) > 1e-8 or any(abs(a - b) > 1 for a, b in zip(
            out["cuda"]["iterations"], out["cpu"]["iterations"])):
        raise AssertionError("tp03stokes small lid: card and CPU differ")
    counts = {name: w.launches for name, w in wrappers.items()}
    print(f"# tp03stokes launches {counts}: the Stokes application runs no "
          f"port kernel -- its operator is matmuls against the full-cell "
          f"basis, its smoother batched dense Vanka solves, and stfem_tpu's "
          f"counterpart of this path reaches no Pallas kernel either",
          flush=True)
    return counts


def dfg_phase(wrappers, dev, strong=None) -> dict:
    """Phase 13: the tp_03stokes DFG channel on the card (drivers/
    tp03stokes.py::run_practical, drivers/stokes.py::run_dfg_square, the
    masked, non-uniform and mapped geometry, free faces, drag/lift) -- (a)
    configs/tp03stokes_dfg_2d.json (the dfgBenchmarkSquare grid at
    refinement 5, 288 x 96 cells, 611,332 unknowns a slab) for 3 slabs,
    the last again and one V-cycle under the profiler; (b) the cylinder
    (gridDescriptor dfgBenchmark) for 1 slab; (c) refinement 2, 2 slabs,
    square and cylinder, on the card against the CPU.  Returns the
    launches of every wrapper over the phase (the path runs none of
    K1-K5); raises on any failed check.  Sets the counts to 0 first.
    strong, if given, receives (a)'s c_D and c_L per slab
    ("drag_lift")."""
    import torch
    from stfem_tpu_torch import bench_heat
    from stfem_tpu_torch.config import Parameters
    from stfem_tpu_torch.drivers import tp03stokes
    from stfem_tpu_torch.utils.timer import TimerOutput

    for w in wrappers.values():
        w.launches = 0
    t_phase = time.time()
    extra = tp03stokes.parse_stokes_extra(str(tp03stokes.CONFIGS
                                              / "stokes_dfg.json"))

    def config(**over):
        p = Parameters.parse(str(tp03stokes.DFG_2D), 2)
        for key, val in over.items():
            setattr(p, key, val)
        return p

    def run_main(label, grid, n_slabs, profile):
        p = config(grid_descriptor=grid)
        timer, slabs = TimerOutput(), []
        torch.cuda.reset_peak_memory_stats(dev)
        t0 = time.time()
        res = tp03stokes.run_practical(p, extra, p.fe_degree, p.refinement,
                                       n_slabs_max=n_slabs, device="cuda",
                                       timer=timer, on_slab=slabs.append)
        wall = time.time() - t0
        st = res["n_blocks"] * res["n_dofs"]
        mesh = res["mesh"]
        print(f"# dfg {label} refinement {p.refinement} ({mesh.cells[0]} x "
              f"{mesh.cells[1]} cells, {int(mesh.cell_mask.sum())} "
              f"active): {res['n_dofs']} "
              f"unknowns per block, {st} per slab; setup "
              f"{timer.totals['setup']:.2f} s (hierarchy "
              f"{timer.totals['setup:gmg']:.2f} s), max memory allocated "
              f"{torch.cuda.max_memory_allocated(dev) / 2 ** 20:.1f} MiB, "
              f"run wall {wall:.1f} s", flush=True)
        ok = len(slabs) == n_slabs
        for i, (s, w) in enumerate(zip(slabs, timer.times["step"])):
            m, stats = s["matrix"], s["stats"]
            rn = float((s["rhs"] - m.vmult(s["x"])).norm())
            r0 = float((s["rhs"] - m.vmult(s["x0"])).norm())
            tol = max(1e-12, p.rel_tol * r0)
            cd, cl = (float(v) for v in res["drag_lift"][i])
            div = res["divergence"][i]
            print(f"# dfg {label} slab {i}: FGMRES iterations "
                  f"{stats.iterations}, slab wall {w:.4f} s, {st / w:.4e} "
                  f"space-time DoF/s; true FP64 ||r|| {rn:.3e} (/||r0|| "
                  f"{rn / r0:.3e}) vs FGMRES tol {tol:.3e}; c_D {cd:.8e} "
                  f"c_L {cl:.8e} divergence {div:.6e}", flush=True)
            ok = (ok and stats.converged and rn <= 2.0 * tol
                  and np.isfinite(cd) and np.isfinite(cl)
                  and np.isfinite(div))
        if not ok:
            raise AssertionError(f"dfg {label}: a slab missed its residual "
                                 "bound or a functional is not finite")
        if label == "square" and strong is not None:
            strong["drag_lift"] = np.asarray(res["drag_lift"])
        if profile:
            last = slabs[-1]
            prof = bench_heat.profile_slab(last["resolve"], dev, top=8)
            v = last["rhs"] / last["rhs"].norm()
            vprof = bench_heat.profile_slab(
                lambda: last["preconditioner"](v), dev, top=8)
            print(f"# dfg {label}: profile of slab {n_slabs - 1} again "
                  f"(untimed): device busy {prof['device_busy_s']:.4f} s "
                  f"of {prof['wall_s']:.4f} s wall (share "
                  f"{prof['device_busy_share']:.4f}), "
                  f"{prof['n_kernel_launches']} launches over "
                  f"{last['stats'].iterations} FGMRES iterations; one "
                  f"V-cycle alone: {vprof['n_kernel_launches']} launches, "
                  f"{vprof['wall_s']:.4f} s wall, device busy share "
                  f"{vprof['device_busy_share']:.4f}; top kernels (ms) "
                  f"{prof['top_kernels_ms'][:5]}; top ops (ms) "
                  f"{prof['top_ops_ms'][:5]}", flush=True)
        del slabs, res
        torch.cuda.empty_cache()

    # (a) the square at refinement 5, 4 slabs; (b) the cylinder, 1 slab
    run_main("square", "dfgBenchmarkSquare", MAIN_CUTS["dfg square"], True)
    run_main("cylinder", "dfgBenchmark", 1, False)

    # (c) refinement 2, 2 slabs: the card against the CPU
    for grid in ("dfgBenchmarkSquare", "dfgBenchmark"):
        p = config(grid_descriptor=grid, refinement=2)
        out = {d: tp03stokes.run_practical(p, extra, 1, 2, n_slabs_max=2,
                                           device=d)
               for d in ("cuda", "cpu")}
        g, c = out["cuda"], out["cpu"]
        worst = max(float(np.abs(g[n] - c[n]).max() / np.abs(c[n]).max())
                    for n in ("u", "p"))
        worst_f = float(np.max(np.abs(g["drag_lift"] - c["drag_lift"])
                               / np.abs(c["drag_lift"])))
        print(f"# dfg small {grid} refinement 2, 2 slabs: worst difference "
              f"of u and p relative to their largest entry {worst:.2e}, of "
              f"c_D and c_L relative {worst_f:.2e} (tol 1e-8 each); FGMRES "
              f"iterations gpu {g['iterations']} cpu {c['iterations']}",
              flush=True)
        if max(worst, worst_f) > 1e-8 or any(
                abs(a - b) > 1 for a, b in zip(g["iterations"],
                                               c["iterations"])):
            raise AssertionError(f"dfg small {grid}: card and CPU differ")
    counts = {name: w.launches for name, w in wrappers.items()}
    print(f"# dfg launches {counts}: the DFG channel runs no port kernel "
          f"(stfem_tpu's counterpart reaches no Pallas call); phase wall "
          f"{time.time() - t_phase:.1f} s", flush=True)
    return counts


def _velocity_pressure(S, x):
    """A Stokes slab solution [T, n_u + n_p] as FGMRES returns it, on the
    host, as the quantities a solve determines: u on the free dofs (the
    constrained ones hold what each preconditioner leaves there, until
    the driver zeroes them) and p less the per-block mean of the cells'
    constant mode (the enclosed flow fixes p only up to that constant)."""
    import torch
    x = x.cpu()
    free = torch.as_tensor(np.tile(S.mask_u_np.reshape(-1), S.dim))
    p = x[:, S.n_u:].reshape(x.shape[0], -1, S.n_ploc_cell).clone()
    p[..., 0] -= p[..., 0].mean(dim=1, keepdim=True)
    return x[:, :S.n_u] * free, p


def chebyshev_phase(wrappers, dev, relaxation, lid) -> dict:
    """Phase 14: the solver options on the card -- the Chebyshev smoother
    and the GMRES coarse solve through the applications' entry points on
    the committed *_chebyshev configs: (a) tp_01 practical mode at 16^3,
    (b) tp_01 convergence, heat DG(1) at 16^3, its norms against
    phase 11b's Relaxation run (`relaxation`, by (name, ref)), (c) the
    256^2 lid for 1 slab against phase 12c's first (`lid`), (d) small
    cells on the card against the CPU.  Returns the launches of every
    wrapper by path (each set to 0 first); raises on any failed check."""
    import torch
    from stfem_tpu_torch.config import Parameters, StokesParameters
    from stfem_tpu_torch.drivers import tp01, tp03stokes
    from stfem_tpu_torch.drivers.heat import (run_heat_cycle,
                                              stmg_preconditioner_factory)
    from stfem_tpu_torch.stmg.gmg import GMG, GMGParams
    from stfem_tpu_torch.types import SupportedSmoothers, TimeStepType
    from stfem_tpu_torch.utils.timer import TimerOutput

    by_path = {}

    def rel(a, b):
        return abs(a / b - 1.0)

    # (a) tp_01 practical mode, 16^3 Q3 x dG(2), 4 slabs
    counts = practical_phase(
        wrappers, dev, tp01.CONFIGS / "tp01_practical_3d_chebyshev.json",
        "chebyshev practical", vcycle=True)
    if not (counts["time_solve"] and counts["quad_middle"]):
        raise AssertionError("chebyshev practical: K1 or K5 never ran")
    by_path["chebyshev practical"] = counts

    # (b) tp_01 convergence, heat DG(1), refinement 4 (16^3; 32^3 cut to
    #     keep the smoke under 1000 s when phase 17 came)
    for w in wrappers.values():
        w.launches = 0
    total = dict.fromkeys(wrappers, 0)

    def reset():
        for name, w in wrappers.items():
            total[name] += w.launches
            w.launches = 0

    p = Parameters.parse(
        str(tp01.CONFIGS / "tp01_convergence_3d_heat_dg1_chebyshev.json"), 3)
    p.refinement, p.n_ref_cycles = 4, 1
    results, rows, last, wall = _sweep(p, "heat_dg1 chebyshev", wrappers,
                                       reset)
    worst = 0.0
    for (_, ref), r in results.items():
        ref_norms = relaxation[("heat_dg1", ref)]
        errs = [rel(a, b) for a, b in zip(
            (r.linf_linf, r.l2_l2, r.l2_h1), ref_norms)]
        worst = max(worst, max(errs))
        print(f"# tp01 3D heat_dg1 chebyshev ref {ref}: linf "
              f"{r.linf_linf:.10e} l2 {r.l2_l2:.10e} h1 {r.l2_h1:.10e}; "
              f"rel to phase 11b's Relaxation run {max(errs):.2e} (tol "
              f"1e-4); mean FGMRES iterations {r.avg_iterations:g}",
              flush=True)
    gmg = last["integ"].preconditioner
    lvl0 = gmg.levels[0]
    free0 = int(np.sum(lvl0.matrix.K.mask_np))
    raw = rows[-1][-1]
    print(f"# tp01 3D heat_dg1 chebyshev finest V-cycle: "
          f"{_vanka_levels(gmg)}; {_smoother_levels(gmg)}; coarse solve "
          f"{gmg.coarse} ({gmg.coarse_maxiter} iterations) on level 0 of "
          f"{lvl0.n_blocks} x {int(np.prod(lvl0.dof_shape))} unknowns, "
          f"{free0} free per block; raw launches at 16^3 {raw}; sweep wall "
          f"{wall:.1f} s", flush=True)
    if worst > 1e-4:
        raise AssertionError("tp01 heat_dg1 chebyshev: norms off phase 11b")
    if not (raw["time_solve"] and raw["chain_down"] and raw["chain_up"]):
        raise AssertionError("tp01 heat_dg1 chebyshev: K1 or K4 never ran "
                             "at 16^3")
    reset()
    by_path["chebyshev convergence"] = dict(total)
    top = gmg.levels[-1]
    v = torch.randn((top.n_blocks,) + tuple(top.dof_shape),
                    generator=torch.Generator(device="cuda").manual_seed(0),
                    dtype=torch.float64, device="cuda")
    _readback_ab(gmg, v / v.norm(), "tp01 3D heat_dg1 chebyshev 16^3")
    del results, last, gmg, lvl0, top, v
    torch.cuda.empty_cache()

    # (d) the 2D heat DG(1) golden cell at refinement 2 with (a)'s keys:
    #     the card against the CPU
    params = GMGParams(smoother=SupportedSmoothers.Chebyshev,
                       smoothing_steps=2, smoothing_range=5.0,
                       coarse_grid_smoother_type="GMRES")
    out = {}
    for d in ("cuda", "cpu"):
        out[d] = run_heat_cycle(
            refinement=2, fe_degree=1, type_=TimeStepType.DG,
            n_timesteps_at_once=2, gmres_maxiter=100, device=d,
            preconditioner_factory=stmg_preconditioner_factory(
                params=params, fe_degree_min=1))
    g, c = out["cuda"], out["cpu"]
    worst = max(rel(getattr(g, n), getattr(c, n))
                for n in ("linf_linf", "l2_l2", "l2_h1"))
    print(f"# chebyshev small heat DG(1) 2D ref 2: gpu l2 {g.l2_l2:.10e} "
          f"cpu {c.l2_l2:.10e} (golden 1.78760e-02), worst rel difference "
          f"of the three norms {worst:.2e} (tol 1e-8); FGMRES "
          f"iterations/slab gpu {g.slab_iterations} cpu {c.slab_iterations}",
          flush=True)
    if worst > 1e-8 or any(abs(a - b) > 1 for a, b in
                           zip(g.slab_iterations, c.slab_iterations)):
        raise AssertionError("chebyshev small heat: card and CPU differ")

    # (c) the 256^2 lid, 1 slab
    for w in wrappers.values():
        w.launches = 0
    extra = StokesParameters()
    lid_cfg = tp03stokes.CONFIGS / "tp03stokes_lid_2d_chebyshev.json"
    with tempfile.TemporaryDirectory() as tmpd:
        p = Parameters.parse(str(lid_cfg), 2)
        p.functional_file = os.path.join(tmpd, "functionals.txt")
        timer, slabs = TimerOutput(), []
        t0 = time.time()
        res = tp03stokes.run_practical(p, extra, p.fe_degree, p.refinement,
                                       n_slabs_max=1, device="cuda",
                                       timer=timer, on_slab=slabs.append)
        wall = time.time() - t0
        rows = np.loadtxt(p.functional_file, ndmin=2)
    gmg = slabs[0]["preconditioner"]
    lvl0 = gmg.levels[0]
    n0 = lvl0.n_blocks * int(np.prod(lvl0.dof_shape))
    st = res["n_blocks"] * res["n_dofs"]
    print(f"# chebyshev lid 256^2 DG(1): {st} unknowns per slab; setup "
          f"{timer.totals['setup']:.2f} s (hierarchy "
          f"{timer.totals['setup:gmg']:.2f} s), run wall {wall:.1f} s; "
          f"{_smoother_levels(gmg)}; coarse level {n0} unknowns <= "
          f"{GMG.DIRECT_COARSE_MAX}: solved by {gmg.coarse} (the FP64 "
          f"pseudo-inverse, by the routing rule) though the config asks "
          f"for {p.mg_data.coarse_grid_smoother_type}", flush=True)
    ok = len(slabs) == 1 and gmg.coarse == "Direct"
    worst_x = 0.0
    for i, (s, w) in enumerate(zip(slabs, timer.times["step"])):
        m, stats = s["matrix"], s["stats"]
        rn = float((s["rhs"] - m.vmult(s["x"])).norm())
        r0 = float((s["rhs"] - m.vmult(s["x0"])).norm())
        tol = max(1e-12, p.rel_tol * r0)
        dx = max(float((a - b).abs().max() / b.abs().max()) for a, b in
                 zip(_velocity_pressure(m.S, s["x"]),
                     _velocity_pressure(m.S, lid["x"][i])))
        worst_x = max(worst_x, dx)
        print(f"# chebyshev lid slab {i}: FGMRES iterations "
              f"{stats.iterations}, slab wall {w:.4f} s, {st / w:.4e} "
              f"space-time DoF/s; true FP64 ||r|| {rn:.3e} (/||r0|| "
              f"{rn / r0:.3e}) vs FGMRES tol {tol:.3e}; free u and p (up "
              f"to its constant) vs phase 12c's {dx:.2e} of their largest "
              f"entry", flush=True)
        ok = ok and stats.converged and rn <= 2.0 * tol
    ref_rows = lid["rows"][:len(rows)]
    m = np.abs(ref_rows).max(axis=0)
    scale = np.array([m[0], *[max(m[1:3])] * 2, *[max(m[3:5])] * 2, m[5]])
    worst_f = (float((np.abs(rows - ref_rows) / scale).max())
               if rows.shape == ref_rows.shape else np.inf)
    print(f"# chebyshev lid: {len(rows)} functionals rows against phase "
          f"12c's, worst difference relative to their quantity's largest "
          f"value {worst_f:.2e} (tol 1e-7); u and p {worst_x:.2e} (tol "
          f"1e-7)", flush=True)
    if not (ok and worst_f <= 1e-7 and worst_x <= 1e-7):
        raise AssertionError("chebyshev lid: a slab missed its residual or "
                             "disagrees with phase 12c")
    by_path["chebyshev stokes"] = {name: w.launches
                                   for name, w in wrappers.items()}
    del slabs, res, gmg, lvl0
    torch.cuda.empty_cache()

    # (d) the weak lid at refinement 3, 2 slabs, with (c)'s keys: the card
    #     against the CPU
    out = {}
    for d in ("cuda", "cpu"):
        p = Parameters.parse(str(lid_cfg), 2)
        p.functional_file = None
        out[d] = tp03stokes.run_practical(p, extra, 1, 3, n_slabs_max=2,
                                          device=d)
    worst = max(float(np.abs(out["cuda"][n] - out["cpu"][n]).max()
                      / np.abs(out["cpu"][n]).max()) for n in ("u", "p"))
    print(f"# chebyshev small weak lid ref 3, 2 slabs: worst difference of "
          f"u and p relative to their largest entry {worst:.2e} (tol 1e-8); "
          f"FGMRES iterations gpu {out['cuda']['iterations']} cpu "
          f"{out['cpu']['iterations']}", flush=True)
    if worst > 1e-8 or any(abs(a - b) > 1 for a, b in zip(
            out["cuda"]["iterations"], out["cpu"]["iterations"])):
        raise AssertionError("chebyshev small lid: card and CPU differ")
    return by_path


def _element_apply(E, v, cells, k):
    """y = sum over cells of E_c times v's local dofs, overlap-added:
    [..., *dofshape] -> [..., *dofshape] (masked element matrices: no code
    shared with SystemMatrix's routes)."""
    import torch
    from stfem_tpu_torch.ops.spatial import cell_gather, cell_scatter
    dim = len(cells)
    lead = v.shape[:v.ndim - dim]
    u = cell_gather(v, cells, k).reshape(lead + (E.shape[0], E.shape[1]))
    y = torch.einsum("cab,...cb->...ca", E, u)
    return cell_scatter(y.reshape(lead + tuple(cells) + (k + 1,) * dim),
                        cells, k)


def _rel_max(got, ref) -> float:
    return float((got - ref).abs().max() / ref.abs().max())


def stepped_checks(wrappers, dev, gen) -> None:
    """Phase 15(a): the heat stack on graded per-axis steps (F1 on the
    card).  Raises on a failed check."""
    import torch
    from stfem_tpu_torch.mesh.grid import StructuredMesh
    from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
    from stfem_tpu_torch.stmg.vanka import PreconditionVanka
    from stfem_tpu_torch.system import SystemMatrix
    from stfem_tpu_torch.time.tables import get_fe_time_weights
    from stfem_tpu_torch.types import TimeStepType

    f32, f64 = torch.float32, torch.float64
    # graded steps, another ratio on each axis: 4 base steps, 16 cells
    steps = [list(b / b.sum()) for b in (np.geomspace(1.0, r, 4)
                                         for r in (2.0, 0.4, 3.0))]
    A, B, G, _ = get_fe_time_weights(TimeStepType.DG, 1, 1.0 / 64, 4)
    zero = np.zeros_like(G)

    def ops(mesh, dtype, device):
        return (LaplaceMassOperator(mesh, 4, 5, 0.0, 1.0, dtype=dtype,
                                    device=device),
                LaplaceMassOperator(mesh, 4, 5, 1.0, 0.0, dtype=dtype,
                                    device=device))

    def mixed(T, Kx, Mx, T2):
        return (torch.einsum("ji,i...->j...", T, Kx)
                + torch.einsum("ji,i...->j...", T2, Mx))

    def reset():
        for w in wrappers.values():
            w.launches = 0

    mesh = StructuredMesh([4] * 3, [0.0] * 3, None, refinement=2,
                          axis_steps=steps)
    K, M = ops(mesh, f64, dev)
    sm = SystemMatrix(K, M, A, B)
    x = torch.randn((A.shape[0],) + mesh.dof_shape(4), generator=gen,
                    device=dev, dtype=f64)
    reset()
    y = sm.vmult(x)
    k2 = wrappers["kron_pair"].launches
    At, Bt = (torch.as_tensor(t, dtype=f64, device=dev) for t in (A, B))
    err3 = _rel_max(y, mixed(At, K.apply(x), M.apply(x), Bt))
    mesh2 = StructuredMesh([4] * 2, [0.0] * 2, None, refinement=3,
                           axis_steps=steps[:2])
    K2, M2 = ops(mesh2, f64, dev)
    prev = torch.randn(mesh2.dof_shape(4), generator=gen, device=dev,
                       dtype=f64)
    reset()
    ys = SystemMatrix(K2, M2, zero, G).vmult_slice(prev)
    k3 = wrappers["banded_apply"].launches
    Gt = torch.as_tensor(G[:, 0], dtype=f64, device=dev)
    err2 = _rel_max(ys, Gt.reshape(-1, 1, 1) * M2.apply(prev)[None])
    grading = [round(float(st[-1] / st[0]), 3) for st in steps]
    print(f"# stepped 3D Q4 16^3 (last / first base step {grading}), 8 "
          f"blocks: SystemMatrix route {sm.route} vmult vs the "
          f"operators' own apply, max rel {err3:.2e} (tol 1e-12), K2 "
          f"launches {k2}; 2D Q4 32^2 vmult_slice max rel {err2:.2e} (tol "
          f"1e-12), K3 launches {k3}", flush=True)
    if not (sm.route == "kron" and err3 <= 1e-12 and err2 <= 1e-12
            and k2 > 0 and k3 > 0):
        raise AssertionError("stepped mesh: the FP64 operator or its "
                             "kernels failed")
    # one grid-mode Vanka apply (K4 down, K1, K4 up) against the same
    # smoother built on the CPU (the kernels' plain versions)
    vk = [PreconditionVanka(*ops(mesh, f32, where), A, B, dtype=f32,
                            n_steps=4)
          for where in (dev, torch.device("cpu"))]
    r = torch.randn(x.shape, generator=gen, device=dev) * vk[0].K_op.mask
    reset()
    yv = vk[0].vmult(r)
    k4 = wrappers["chain_down"].launches + wrappers["chain_up"].launches
    k1 = wrappers["time_solve"].launches
    errv = _rel_max(yv.cpu(), vk[1].vmult(r.cpu()))
    print(f"# stepped 3D Q4 16^3: grid-mode Vanka (float32, 4 steps) on "
          f"the card vs the plain version, max rel {errv:.2e} (tol 1e-5); "
          f"K4 launches {k4}, K1 launches {k1}", flush=True)
    if not (vk[0].mode == "grid" and errv <= 1e-5 and k4 > 0 and k1 > 0):
        raise AssertionError("stepped mesh: the grid-mode Vanka failed")
    del vk, sm, K, M, K2, M2
    torch.cuda.empty_cache()


def distorted_phase(wrappers, dev, refinement: int = 5) -> dict:
    """Phase 15(b, c): the distorted-mesh heat path.  (b) run_heat_cycle
    in 3D, Q2 x dG(1), 2 steps a slab, distortion 0.15, 32^3 cells, 1
    slab: per slab the FGMRES iterations, an FP64 true residual through
    masked element matrices (no code shared with the "cell" route) against
    FGMRES's stop test, the slab wall, K1's launches and, from the slab
    solved again under the profiler, K1's device time and the busy share;
    then one V-cycle under the profiler.  (c) distorted_card_cpu.
    Returns (b)'s launches (counts set to 0 just before it)."""
    import torch
    from stfem_tpu_torch import bench_heat
    from stfem_tpu_torch.drivers.heat import (run_heat_cycle,
                                              stmg_preconditioner_factory)
    from stfem_tpu_torch.time.tables import get_fe_time_weights
    from stfem_tpu_torch.types import TimeStepType
    from stfem_tpu_torch.utils.timer import TimerOutput

    f64 = torch.float64
    cycle = dict(fe_degree=1, type_=TimeStepType.DG, n_timesteps_at_once=2,
                 subdivisions=(1, 1, 1), lower=(0.0,) * 3, upper=(1.0,) * 3,
                 distort_grid=0.15)
    base = stmg_preconditioner_factory(fe_degree_min=1)
    marks, rows, held = [], [], {}

    def factory(ctx):
        gmg = base(ctx)
        marks.append(wrappers["time_solve"].launches)
        return gmg

    def on_slab(integ, t, dt, prev, x, stats):
        marks.append(wrappers["time_solve"].launches)
        K, M = integ.matrix.K, integ.matrix.M
        if "EK" not in held:
            held.update(EK=K.element_matrices(), EM=M.element_matrices())
        EK, EM, cells = held["EK"], held["EM"], K.cells
        A, B, G, _ = (torch.as_tensor(t_, dtype=f64, device=dev) for t_ in
                      get_fe_time_weights(TimeStepType.DG, 1, dt, 2))

        def apply(v):
            return (torch.einsum("ji,i...->j...", A,
                                 _element_apply(EK, v, cells, 2))
                    + torch.einsum("ji,i...->j...", B,
                                   _element_apply(EM, v, cells, 2)))

        rhs = (G[:, 0].reshape(-1, 1, 1, 1)
               * _element_apply(EM, prev, cells, 2)[None]
               + integ.assemble_force(t, dt))
        rn = float((rhs - apply(x)).norm())
        r0 = float((rhs - apply(integ._extrapolate(prev))).norm())
        tol = max(integ.abstol, integ.reltol * r0)
        saved = {name: w.launches for name, w in wrappers.items()}
        prof = bench_heat.profile_slab(lambda: integ.solve(prev, t, dt), dev,
                                       top=6)
        for name, w in wrappers.items():      # the re-solve is not the path
            w.launches = saved[name]
        rows.append(dict(iters=stats.iterations, rn=rn, r0=r0, tol=tol,
                         rhs=float(rhs.norm()), est=stats.residual,
                         k1=prof["port_kernels_ms"]["time_solve"],
                         busy=prof["device_busy_share"],
                         wall_prof=prof["wall_s"],
                         launches=prof["n_kernel_launches"],
                         top=prof["top_ops_ms"][:5]))
        held.update(integ=integ, rhs=rhs)
        marks.append(wrappers["time_solve"].launches)

    for w in wrappers.values():
        w.launches = 0
    timer = TimerOutput()
    wall0 = time.time()
    res = run_heat_cycle(refinement=refinement,
                         preconditioner_factory=factory, timer=timer,
                         device=dev, on_slab=on_slab, n_slabs_max=1,
                         **cycle)
    wall = time.time() - wall0
    counts = {name: w.launches for name, w in wrappers.items()}
    st_dofs = res.n_blocks * res.n_dofs
    n = 2 ** refinement
    print(f"# distorted 3D Q2 x dG(1) {n}^3, distortion 0.15, 2 steps a "
          f"slab ({st_dofs} space-time DoFs a slab): setup "
          f"{timer.totals['setup']:.2f} s (hierarchy "
          f"{timer.totals['setup:gmg']:.2f} s), phase wall {wall:.1f} s "
          f"(with the profiled re-solves); errors over {res.n_timesteps} "
          f"slabs l2 {res.l2_l2:.6e} h1 {res.l2_h1:.6e}", flush=True)
    ok = len(rows) == 1
    for i, (row, w) in enumerate(zip(rows, timer.times["step"])):
        k1_timed = marks[2 * i + 1] - marks[2 * i]
        print(f"# distorted slab {i}: FGMRES iterations {row['iters']}, "
              f"slab wall {w:.4f} s, {st_dofs / w:.4e} space-time DoF/s; "
              f"true FP64 ||r|| {row['rn']:.3e} (/||rhs|| "
              f"{row['rn'] / row['rhs']:.3e}) vs FGMRES tol "
              f"{row['tol']:.3e}, Givens estimate {row['est']:.3e}; K1 "
              f"launches {k1_timed}; the slab again under the profiler: K1 "
              f"{row['k1']} (launches, device ms), device busy share "
              f"{row['busy']:.4f} of {row['wall_prof']:.4f} s wall, "
              f"{row['launches']} launches, top ops (ms) {row['top']}",
              flush=True)
        ok = ok and row["rn"] <= 2.0 * row["tol"] and k1_timed > 0
    gmg = held["integ"].preconditioner
    levels = [(lvl.dof_shape, lvl.matrix.route,
               getattr(getattr(lvl.smoother, "precond", None), "mode", None))
              for lvl in gmg.levels]
    v = held["rhs"] / held["rhs"].norm()
    vprof = bench_heat.profile_slab(lambda: gmg(v), dev, top=6)
    print(f"# distorted {n}^3: levels (dof shape, route, Vanka mode) "
          f"{levels}; {_vanka_levels(gmg)}; one V-cycle alone (untimed): "
          f"{vprof['n_kernel_launches']} launches, {vprof['wall_s']:.4f} s "
          f"wall, device busy share {vprof['device_busy_share']:.4f}; K1 "
          f"{vprof['port_kernels_ms']['time_solve']} (launches, device "
          f"ms); top ops (ms) {vprof['top_ops_ms'][:5]}; launches {counts}",
          flush=True)
    if not ok or counts["time_solve"] == 0:
        raise AssertionError("distorted path: a slab missed its residual "
                             "or K1 never ran")
    held.clear()
    del gmg, v
    torch.cuda.empty_cache()

    distorted_card_cpu(dev, dict(cycle, n_slabs_max=2))
    return counts


def distorted_card_cpu(dev, cycle) -> None:
    """Phase 15(c): the distorted cycle (`cycle`, phase 15(b)'s keys) at
    4^3 on the CPU and then on the card, the card's V-cycle built by the
    same factory and given the CPU's relaxation omegas: the FP64 slab
    operator and rhs coupling on the same inputs within 1e-13, one
    float32 V-cycle within 1e-5, the FGMRES iterations equal and the
    solutions and l2 norms within 1e-10.
    The card's own omegas are printed beside the CPU's: on the finest
    level ARPACK converges or fails by the float32 rounding of its
    sweeps, in stfem_tpu as in the port (ROADMAP.md section 3), and a
    failure takes the 1.2-safety power estimate.  Raises on any failed
    check."""
    import torch
    from stfem_tpu_torch.drivers.heat import (run_heat_cycle,
                                              stmg_preconditioner_factory)
    from stfem_tpu_torch.utils.carry import load_gmg

    omegas = lambda gmg: [getattr(lvl.smoother, "omega", None)
                          for lvl in gmg.levels]
    held, out, own = {}, {}, []
    for key, where in (("cpu", "cpu"), ("card", dev)):
        base4 = stmg_preconditioner_factory(fe_degree_min=1)

        def fac(ctx, key=key, base4=base4):
            gmg = base4(ctx)
            if key == "card":
                own[:] = omegas(gmg)
                load_gmg(gmg, omegas(held["cpu"][0]))
            held[key] = [gmg]
            return gmg

        out[key] = run_heat_cycle(
            refinement=2, preconditioner_factory=fac, device=where,
            on_slab=lambda integ, *a, key=key: held[key].append(integ),
            **cycle)
    g, c = out["card"], out["cpu"]
    (gmg_g, integ_g), (gmg_c, integ_c) = held["card"][:2], held["cpu"][:2]
    rng = np.random.default_rng(15)
    x = torch.as_tensor(rng.standard_normal(
        (g.n_blocks,) + tuple(integ_c.matrix.K.dof_shape)))
    errs = [_rel_max(ig.vmult(xi.to(dev)).cpu(), ic.vmult(xi))
            for ig, ic, xi in ((integ_g.matrix, integ_c.matrix, x),
                               (integ_g.rhs_matrix, integ_c.rhs_matrix,
                                x[:1]))]
    om_c = omegas(gmg_c)
    om_rel = max((abs(a / b - 1.0) for a, b in zip(own, om_c)
                  if a is not None and b is not None), default=0.0)
    v = x.float()
    err_v = _rel_max(gmg_g(v.to(dev)).cpu(), gmg_c(v))
    diff = _rel_max(g.solution.cpu(), c.solution)
    err_l2 = abs(g.l2_l2 / c.l2_l2 - 1.0)
    print(f"# distorted 4^3 card vs CPU: FP64 slab operator (route {integ_g.matrix.route}) max rel "
          f"{errs[0]:.2e}, rhs coupling {errs[1]:.2e} (tol 1e-13); the "
          f"card's own omegas {own}, the CPU's {om_c} (up to "
          f"{om_rel:.2e} apart; the card runs the CPU's); one float32 "
          f"V-cycle {err_v:.2e} (tol 1e-5); FGMRES iterations/slab gpu "
          f"{g.slab_iterations} cpu {c.slab_iterations} (equal), last "
          f"block max rel {diff:.2e} (tol 1e-10), l2 gpu "
          f"{g.l2_l2:.12e} cpu {c.l2_l2:.12e} (rel {err_l2:.2e}, tol "
          f"1e-10)", flush=True)
    if not (max(errs) <= 1e-13 and err_v <= 1e-5
            and g.slab_iterations == c.slab_iterations
            and diff <= 1e-10 and err_l2 <= 1e-10):
        raise AssertionError("distorted 4^3: card and CPU differ")


def stokes_repeat_check(dev, gen, first_iters) -> None:
    """Phase 15(d): the bench Stokes hierarchy built twice, one V-cycle of
    each on the same vector bitwise equal, with equal level parameters,
    and the same for phase 17(a)'s FE_Q hierarchy at 32^2; then
    bench_stokes once more: its first timed slab's V-cycles against
    phase 9's (`first_iters`)."""
    import torch
    from stfem_tpu_torch import bench_stokes
    from stfem_tpu_torch.mesh.grid import StructuredMesh
    from stfem_tpu_torch.stmg.gmg import GMGParams, build_stmg_stokes
    from stfem_tpu_torch.types import TimeStepType

    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=2)
    outs, params = [], []
    for _ in range(2):
        gmg = build_stmg_stokes(mesh, 1, TimeStepType.DG, 8, 1.0 / 16,
                                params=GMGParams(smoothing_range=5.0),
                                dtype=torch.float32, device=dev)
        if not outs:
            v = torch.randn((gmg.levels[-1].n_blocks,)
                            + gmg.levels[-1].dof_shape, generator=gen,
                            device=dev)
        outs.append(gmg.vmult(v))
        params.append([getattr(lvl.smoother, "omega", None)
                       for lvl in gmg.levels])
        del gmg
    same = bool(torch.equal(outs[0], outs[1])) and params[0] == params[1]
    # an FE_Q hierarchy (phase 17(a)'s at 32^2: the shared pressure nodes'
    # owner-computes sums and the patch pseudo-inverses) twice as well
    fmesh = StructuredMesh([1, 1], [0.0, 0.0], [1.0, 1.0], refinement=5)
    fouts, fparams = [], []
    for _ in range(2):
        gmg = build_stmg_stokes(
            fmesh, 1, TimeStepType.DG, 4, 1.0 / 64,
            params=GMGParams(smoothing_range=5.0), fe_degree_min=1,
            space_time_level_first=False, dg_pressure=False,
            weak_faces=((0, 0), (0, 1), (1, 0), (1, 1)), device=dev)
        if not fouts:
            fv = torch.randn((gmg.levels[-1].n_blocks,)
                             + gmg.levels[-1].dof_shape, generator=gen,
                             device=dev)
        fouts.append(gmg.vmult(fv))
        fparams.append([getattr(lvl.smoother, "omega", None)
                        for lvl in gmg.levels])
        del gmg
    fsame = (bool(torch.equal(fouts[0], fouts[1]))
             and fparams[0] == fparams[1])
    info, _ = bench_stokes.run(8, 8, n_slabs=MAIN_CUTS["stokes"],
                               device="cuda")
    print(f"# stokes repeat: two builds of the bench hierarchy, one V-cycle "
          f"each: bitwise equal {same} (omegas {params[0]}); two builds of "
          f"the FE_Q 32^2 hierarchy: bitwise equal {fsame} (omegas "
          f"{fparams[0]}); bench_stokes again: V-cycles/slab {info['iters']} "
          f"against phase 9's {first_iters}", flush=True)
    if not (same and fsame and info["iters"][0] == first_iters[0]):
        raise AssertionError("stokes: two runs of the same code differ")


# stfem_tpu's Navier-Stokes cycle on the CPU with x64 (its tests'
# setting): DG(1), n_picard 2, tests/test_stokes.py:21-27's factory; per
# refinement the mean FGMRES iterations a slab (of the last Picard solve)
# and l2_l2_u
NAVIER_CPU = {1: (8.0, 1.6524033627639795e-02),
              2: (9.875, 3.1727170762112984e-03)}


def navier_obstacle_phase(wrappers, dev, strong) -> dict:
    """Phase 16: nonlinear and weak-obstacle Stokes on the card (drivers/
    stokes.py::run_navier_stokes_cycle, the operator's "form" mode, the
    extrapolation predictor, run_dfg_square(weak_obstacle=True)) -- (a)
    stfem_tpu's Navier cells, (b) the 256^2 Navier path, (c) the weak
    obstacle on the refinement-5 square against phase 13(a)'s strong one
    (`strong`), (d) small cells on the card against the CPU (the Navier
    cycle's last solve as _velocity_pressure reads it: the enclosed flow
    fixes p only up to a constant) and the weak square twice, bitwise.
    Returns the launches of every wrapper over (b) ("navier") and over
    (c) ("weak obstacle"); the paths run none of K1-K5.  Raises on any
    failed check."""
    import torch
    from stfem_tpu_torch import bench_heat
    from stfem_tpu_torch.config import Parameters
    from stfem_tpu_torch.drivers import stokes, tp03stokes
    from stfem_tpu_torch.stmg.gmg import GMGParams, build_stmg_stokes
    from stfem_tpu_torch.system_stokes import StokesSystemMatrix
    from stfem_tpu_torch.types import NonlinearExtrapolation
    from stfem_tpu_torch.utils.timer import TimerOutput

    t_phase = time.time()
    norms = ("l2_l2_u", "linf_linf_u", "l2_h1_u", "l2_hdiv_u", "l2_l2_p",
             "linf_linf_p", "l2_h1_p")

    def factory(ctx):
        return build_stmg_stokes(
            ctx["mesh"], ctx["fe_degree"], ctx["type_"],
            ctx["n_timesteps_at_once"], ctx["time_step"],
            viscosity=ctx["viscosity"], params=GMGParams(smoothing_range=5.0),
            fe_degree_min=1, device=ctx["device"])

    def navier(device="cuda", **kw):
        return stokes.run_navier_stokes_cycle(
            fe_degree=kw.pop("fe_degree", 1), n_picard=kw.pop("n_picard", 2),
            gmres_maxiter=kw.pop("gmres_maxiter", 60),
            preconditioner_factory=factory, device=device, **kw)

    # (a) stfem_tpu's cells: DG(1) at refinements 1 and 2, then the
    #     Polynomial predictor against the Constant one
    l2 = {}
    for ref, (cpu_its, cpu_l2) in NAVIER_CPU.items():
        timer = TimerOutput()
        res = navier(refinement=ref, timer=timer)
        l2[ref] = res.l2_l2_u
        walls = timer.times["step"]
        print(f"# navier DG(1) ref {ref}: "
              f"{' '.join(f'{getattr(res, n):.6e}' for n in norms)} (u: L2 "
              f"Linf H1 Hdiv, p: L2 Linf H1; stfem_tpu's l2 {cpu_l2:.6e}); "
              f"FGMRES iterations/slab {res.slab_iterations} mean "
              f"{res.avg_iterations:g} (stfem_tpu {cpu_its:g}); slab walls "
              f"mean {sum(walls) / len(walls):.4f} s (max {max(walls):.4f})",
              flush=True)
        if abs(res.avg_iterations - cpu_its) > 1.5:
            raise AssertionError(f"navier ref {ref}: iterations off")
    rate = float(np.log2(l2[1] / l2[2]))
    kw = dict(refinement=1, fe_degree=2, gmres_maxiter=150)
    const = navier(**kw)
    poly = navier(nonlinear_extrapolation=NonlinearExtrapolation.Polynomial,
                  **kw)
    dl2 = abs(poly.l2_l2_u / const.l2_l2_u - 1.0)
    print(f"# navier: L2-L2(u) rate refinements 1-2 {rate:.3f} (bar 2.0); "
          f"DG(2) ref 1 Polynomial predictor l2 {poly.l2_l2_u:.6e} "
          f"iterations {poly.total_iterations} against Constant "
          f"{const.l2_l2_u:.6e} / {const.total_iterations} (l2 rel "
          f"{dl2:.2e}, tol 1e-3; iterations at most Constant + 2)",
          flush=True)
    if not (rate > 2.0 and dl2 <= 1e-3
            and poly.total_iterations <= const.total_iterations + 2):
        raise AssertionError("navier: rate or predictor check failed")

    # (b) the full-width Navier path: 256^2 cells, DG(1), tau 2^-9, three
    #     Picard solves a slab, MAIN_CUTS["navier"] slabs
    by_path = {}
    for w in wrappers.values():
        w.launches = 0
    timer, solves = TimerOutput(), []
    t0 = time.time()
    res = navier(refinement=8, n_picard=3, n_slabs_max=MAIN_CUTS["navier"],
                 gmres_maxiter=200,
                 timer=timer, on_slab=solves.append)
    wall = time.time() - t0
    by_path["navier"] = {name: w.launches for name, w in wrappers.items()}
    n_dofs = res.n_dofs_u + res.n_dofs_p
    st = n_dofs * res.n_blocks // 2
    print(f"# navier 256^2 DG(1): {n_dofs} unknowns per block, {st} per "
          f"slab; setup {timer.totals['setup']:.2f} s (hierarchy "
          f"{timer.totals['setup:gmg']:.2f} s), run wall {wall:.1f} s, slab "
          f"walls {' '.join(f'{w:.4f}' for w in timer.times['step'])} s; "
          f"errors after {MAIN_CUTS['navier']} slab(s) (not gated) "
          f"{' '.join(f'{getattr(res, n):.6e}' for n in norms)}", flush=True)
    ok = len(solves) == 3 * MAIN_CUTS["navier"]
    for s, w in zip(solves, timer.times["picard"]):
        line = (f"# navier 256^2 slab {int(round(s['time'] / s['time_step']))}"
                f" Picard {s['picard']}: FGMRES iterations "
                f"{s['stats'].iterations}, wall {w:.4f} s")
        if s["picard"] == 2:
            A = lambda v, s=s: s["matrix"].vmult(v, u_lin=s["u_lin"],
                                                 mode="form")
            rn = float((s["rhs"] - A(s["x"])).norm())
            r0 = float((s["rhs"] - A(s["x0"])).norm())
            tol = max(1e-12, 1e-10 * r0)
            line += (f"; true FP64 Oseen ||r|| {rn:.3e} (/||r0|| "
                     f"{rn / r0:.3e}) vs FGMRES tol {tol:.3e}")
            ok = ok and s["stats"].converged and rn <= 2.0 * tol
        print(line, flush=True)
    if not ok:
        raise AssertionError("navier 256^2: a slab missed its residual")
    last = solves[-1]
    m = last["matrix"]
    me = StokesSystemMatrix(m.S, m.M, m.a.cpu().numpy(), m.b.cpu().numpy(),
                            route="element")
    x = last["x"]
    pf = bench_heat.profile_slab(
        lambda: m.vmult(x, u_lin=last["u_lin"], mode="form"), dev, top=4)
    pe = bench_heat.profile_slab(lambda: me.vmult(x), dev, top=4)
    prof = bench_heat.profile_slab(last["resolve"], dev, top=8)
    v = last["rhs"] / last["rhs"].norm()
    vprof = bench_heat.profile_slab(lambda: last["preconditioner"](v), dev,
                                    top=8)
    print(f"# navier 256^2: one FP64 mode=\"form\" apply "
          f"{pf['wall_s'] * 1e3:.2f} ms wall, {pf['n_kernel_launches']} "
          f"launches, busy share {pf['device_busy_share']:.4f}; one "
          f"mode=\"none\" apply on the element route "
          f"{pe['wall_s'] * 1e3:.2f} ms, {pe['n_kernel_launches']} launches, "
          f"busy share {pe['device_busy_share']:.4f}; the last Oseen solve "
          f"again (untimed): {prof['wall_s']:.4f} s wall, busy share "
          f"{prof['device_busy_share']:.4f}, {prof['n_kernel_launches']} "
          f"launches over {last['stats'].iterations} FGMRES iterations; one "
          f"V-cycle alone: {vprof['n_kernel_launches']} launches, "
          f"{vprof['wall_s']:.4f} s wall, busy share "
          f"{vprof['device_busy_share']:.4f}; top ops (ms) "
          f"{prof['top_ops_ms'][:5]}", flush=True)
    del solves, last, m, me, x, v
    torch.cuda.empty_cache()

    # (c) the weak obstacle on the dfgBenchmarkSquare grid at refinement 5,
    #     2 slabs, with run_practical's keys for configs/tp03stokes_dfg_2d
    p = Parameters.parse(str(tp03stokes.DFG_2D), 2)
    extra = tp03stokes.parse_stokes_extra(str(tp03stokes.CONFIGS
                                              / "stokes_dfg.json"))

    def dfg(ref, n_slabs, cylinder=False, device="cuda", **kw):
        return stokes.run_dfg_square(
            refinement=ref, fe_degree=p.fe_degree, type_=p.type,
            viscosity=extra.viscosity, u_mean=extra.u_mean,
            dfg_benchmark=extra.dfg_benchmark, end_time=p.end_time,
            n_slabs=n_slabs, preconditioner_factory=tp03stokes.stmg_factory(p),
            gmres_maxiter=150, rel_tol=p.rel_tol, cylinder=cylinder,
            weak_obstacle=True, device=device, **kw)

    for w in wrappers.values():
        w.launches = 0
    timer, slabs = TimerOutput(), []
    t0 = time.time()
    res = dfg(p.refinement, 2, timer=timer, on_slab=slabs.append)
    wall = time.time() - t0
    by_path["weak obstacle"] = {name: w.launches
                                for name, w in wrappers.items()}
    st = res["n_blocks"] * res["n_dofs"]
    print(f"# weak obstacle square refinement {p.refinement}: "
          f"{res['n_dofs']} unknowns per block, {st} per slab; setup "
          f"{timer.totals['setup']:.2f} s (hierarchy "
          f"{timer.totals['setup:gmg']:.2f} s), run wall {wall:.1f} s",
          flush=True)
    ok = len(slabs) == 2
    for i, (s, w) in enumerate(zip(slabs, timer.times["step"])):
        m, stats = s["matrix"], s["stats"]
        rn = float((s["rhs"] - m.vmult(s["x"])).norm())
        r0 = float((s["rhs"] - m.vmult(s["x0"])).norm())
        tol = max(1e-12, p.rel_tol * r0)
        cd, cl = (float(v) for v in res["drag_lift"][i])
        cd_s = float(strong["drag_lift"][i][0])
        dcd = abs(cd / cd_s - 1.0)
        print(f"# weak obstacle slab {i}: FGMRES iterations "
              f"{stats.iterations}, slab wall {w:.4f} s, {st / w:.4e} "
              f"space-time DoF/s; true FP64 ||r|| {rn:.3e} (/||r0|| "
              f"{rn / r0:.3e}) vs FGMRES tol {tol:.3e}; c_D {cd:.8e} c_L "
              f"{cl:.8e} divergence {res['divergence'][i]:.6e}; c_D against "
              f"phase 13(a)'s strong obstacle {cd_s:.8e}: relative "
              f"{dcd:.3e} (stfem_tpu's test asks < 2e-2 at refinement 1: "
              f"{'within' if dcd < 0.02 else 'outside'})", flush=True)
        ok = (ok and stats.converged and rn <= 2.0 * tol
              and np.isfinite([cd, cl, res["divergence"][i], dcd]).all())
    if not ok:
        raise AssertionError("weak obstacle: a slab missed its residual or "
                             "a functional is not finite")
    del slabs, res
    torch.cuda.empty_cache()

    # (d) small cells: the card against the CPU, and the weak square twice
    out = {}
    for d in ("cuda", "cpu"):
        solves = []
        r = navier(refinement=1, device=d, on_slab=solves.append)
        # the free u and p up to its constant: what the solve determines
        out[d] = (r, _velocity_pressure(solves[-1]["matrix"].S,
                                        solves[-1]["x"]))
    (g, gx), (c, cx) = out["cuda"], out["cpu"]
    dx = max(float((a - b).abs().max() / b.abs().max())
             for a, b in zip(gx, cx))
    dn = max(abs(getattr(g, n) / getattr(c, n) - 1.0) for n in norms)
    print(f"# navier small ref 1: the last solve's free u and p (up to its "
          f"constant) {dx:.2e} of their largest entry, norms {dn:.2e} "
          f"relative (tol 1e-8); FGMRES iterations gpu {g.slab_iterations} "
          f"cpu {c.slab_iterations}", flush=True)
    if max(dx, dn) > 1e-8 or any(abs(a - b) > 1 for a, b in zip(
            g.slab_iterations, c.slab_iterations)):
        raise AssertionError("navier small: card and CPU differ")
    for cyl in (False, True):
        out = {d: dfg(2, 1, cylinder=cyl, device=d) for d in ("cuda", "cpu")}
        g, c = out["cuda"], out["cpu"]
        worst = max(float(np.abs(g[n] - c[n]).max() / np.abs(c[n]).max())
                    for n in ("u", "p"))
        worst_f = float(np.max(np.abs(g["drag_lift"] - c["drag_lift"])
                               / np.abs(c["drag_lift"])))
        name = "cylinder" if cyl else "square"
        print(f"# weak obstacle small {name} refinement 2, 1 slab: u and p "
              f"{worst:.2e} of their largest entry, c_D and c_L {worst_f:.2e} "
              f"relative (tol 1e-8 each); FGMRES iterations gpu "
              f"{g['iterations']} cpu {c['iterations']}", flush=True)
        if max(worst, worst_f) > 1e-8 or any(
                abs(a - b) > 1 for a, b in zip(g["iterations"],
                                               c["iterations"])):
            raise AssertionError(f"weak obstacle small {name}: card and CPU "
                                 "differ")
        if not cyl:
            again = dfg(2, 1)
            same = (again["iterations"] == g["iterations"]
                    and all(np.array_equal(again[n], g[n])
                            for n in ("u", "p", "drag_lift")))
            print(f"# weak obstacle small square twice on the card (builds "
                  f"and solves): bitwise equal {same}", flush=True)
            if not same:
                raise AssertionError("weak obstacle: two runs of the same "
                                     "code differ")
    print(f"# navier and weak obstacle launches {by_path}: the paths run no "
          f"port kernel (stfem_tpu's counterparts reach no Pallas call); "
          f"phase wall {time.time() - t_phase:.1f} s", flush=True)
    return by_path


# phase 17's cuts of the march (refinement: slabs); every other
# refinement runs whole
# (16^2: 1 of 8 slabs, 32^2: 1 of 16, 64^2: 1 of 32; 16^3: 1 of 16,
# 32^3: 1 of 32; 16^2 and 16^3 ran 2 until phase 19 came)
FEQ_CUTS = {4: 1, 5: 1, 6: 1}
DIRICHLET_CUTS = {4: 1, 5: 1}

# stfem_tpu's FE_Q Stokes cycle on the CPU with x64 (its tests' setting):
# DG(1), one step at once, Nitsche faces on every wall,
# tests/test_stokes.py:530-555's factory; per refinement the FGMRES
# iterations (the total of the cycle) and the u and p L2-L2 errors
FEQ_CPU = {1: (68, 1.2606340542842863e-02, 3.585092942255120e-02),
           2: (221, 2.7992780153705487e-03, 9.935306298969764e-03)}


def _feq_factory(ctx):
    """stfem_tpu's test_feq_pressure_stmg factory (tests/test_stokes.py:
    536-544) on the cycle's device."""
    from stfem_tpu_torch.stmg.gmg import GMGParams, build_stmg_stokes
    return build_stmg_stokes(
        ctx["mesh"], ctx["fe_degree"], ctx["type_"],
        ctx["n_timesteps_at_once"], ctx["time_step"],
        viscosity=ctx["viscosity"], params=GMGParams(smoothing_range=5.0),
        fe_degree_min=1, space_time_level_first=False,
        dg_pressure=ctx["dg_pressure"], weak_faces=ctx["weak_faces"],
        device=ctx["device"])


class _PinvClock:
    """Times torch.linalg.pinv (the FE_Q Vanka's patch pseudo-inverses)
    while it is entered: each call synchronized on both sides."""

    def __enter__(self):
        import torch
        self.orig, self.seconds, self.calls = torch.linalg.pinv, 0.0, 0

        sync = (torch.cuda.synchronize if torch.cuda.is_available()
                else lambda: None)

        def timed(*a, **k):
            sync()
            t0 = time.perf_counter()
            out = self.orig(*a, **k)
            sync()
            self.seconds += time.perf_counter() - t0
            self.calls += 1
            return out

        torch.linalg.pinv = timed
        return self

    def __exit__(self, *exc):
        import torch
        torch.linalg.pinv = self.orig


def feq_phase(wrappers, dev, refinements=(2, 3, 4, 5, 6),
              slabs_max=None) -> dict:
    """Phase 17(a, b): the continuous (FE_Q, Taylor-Hood Q2/Q1) pressure
    through the Stokes stack.  (a) run_stokes_cycle(dg_pressure=False,
    nitsche_boundary=True), DG(1), 4 steps a slab,
    configs/tp03stokes_convergence_2d_dg1.json's discretisation, with
    stfem_tpu's test_feq_pressure_stmg V-cycle: per refinement the FGMRES
    iterations a slab, the slab walls, the setup (the hierarchy, and in it
    the patch pseudo-inverses), the u and p L2-L2 errors and their rates,
    and one V-cycle under the profiler; slabs_max[ref] cuts a refinement's
    march.  (b) refinements 1 and 2 with one step at once on the card
    against the CPU (iterations, every norm within 1e-8) and against
    stfem_tpu's CPU counts and errors (FEQ_CPU).  Returns (a)'s launches;
    the path runs none of K1-K5."""
    import torch
    from stfem_tpu_torch import bench_heat
    from stfem_tpu_torch.drivers import stokes
    from stfem_tpu_torch.types import TimeStepType
    from stfem_tpu_torch.utils.timer import TimerOutput

    t_phase = time.time()
    slabs_max = slabs_max or {}
    norms = ("l2_l2_u", "linf_linf_u", "l2_h1_u", "l2_hdiv_u", "l2_l2_p",
             "linf_linf_p", "l2_h1_p")

    def cycle(ref, device=None, **kw):
        return stokes.run_stokes_cycle(
            refinement=ref, fe_degree=1, type_=TimeStepType.DG,
            preconditioner_factory=_feq_factory, dg_pressure=False,
            nitsche_boundary=True, device=device or dev, **kw)

    for w in wrappers.values():
        w.launches = 0
    errs = {}
    for ref in refinements:
        timer, last = TimerOutput(), {}
        with _PinvClock() as pinv:
            t0 = time.time()
            res = cycle(ref, n_timesteps_at_once=4, timer=timer,
                        on_slab=last.update,
                        n_slabs_max=slabs_max.get(ref))
            wall = time.time() - t0
        n = res.n_dofs_u + res.n_dofs_p
        st = n * res.n_blocks // 2
        walls = timer.times["step"]
        whole = ref not in slabs_max
        if whole:
            errs[ref] = (res.l2_l2_u, res.l2_l2_p)
        v = last["rhs"] / last["rhs"].norm()
        vprof = bench_heat.profile_slab(lambda: last["preconditioner"](v),
                                        dev, top=4)
        print(f"# feq {2 ** ref}^2 Q2/Q1 DG(1), 4 steps a slab: {n} "
              f"unknowns a block, {st} a slab; {res.n_timesteps} slabs"
              f"{'' if whole else ' (cut)'}, FGMRES iterations a slab "
              f"{res.slab_iterations} (mean {res.avg_iterations:.3f}); slab "
              f"walls mean {sum(walls) / len(walls):.4f} s (min "
              f"{min(walls):.4f}, max {max(walls):.4f}), "
              f"{st * len(walls) / sum(walls):.4e} space-time DoF/s; setup "
              f"{timer.totals['setup']:.2f} s (hierarchy "
              f"{timer.totals['setup:gmg']:.2f} s, of it "
              f"{pinv.calls} patch pinv calls {pinv.seconds:.3f} s); L2-L2 u "
              f"{res.l2_l2_u:.6e} p {res.l2_l2_p:.6e}; one V-cycle: "
              f"{vprof['n_kernel_launches']} launches, "
              f"{vprof['wall_s'] * 1e3:.2f} ms wall, busy share "
              f"{vprof['device_busy_share']:.4f}; run wall {wall:.1f} s",
              flush=True)
        if (max(res.slab_iterations) >= 200
                or not np.isfinite([res.l2_l2_u, res.l2_l2_p]).all()):
            raise AssertionError(f"feq {ref}: a slab did not converge")
        del last, v
        torch.cuda.empty_cache()
    counts = {name: w.launches for name, w in wrappers.items()}
    refs = sorted(errs)
    rates = [(a, b, float(np.log2(errs[a][0] / errs[b][0])),
              float(np.log2(errs[a][1] / errs[b][1])))
             for a, b in zip(refs, refs[1:])]
    print(f"# feq L2-L2 rates between whole refinements (u, p): "
          f"{[(a, b, round(u, 3), round(q, 3)) for a, b, u, q in rates]} "
          f"(bars u > 2.0, p > 1.5, stfem_tpu's test)", flush=True)
    if not rates or any(u <= 2.0 or q <= 1.5 for _, _, u, q in rates):
        raise AssertionError("feq: a rate missed its bar")

    # (b) refinements 1 and 2, one step at once: card, CPU, stfem_tpu
    for ref, (its, l2u, l2p) in FEQ_CPU.items():
        g, c = cycle(ref), cycle(ref, device="cpu")
        dn = max(abs(getattr(g, n) / getattr(c, n) - 1.0) for n in norms)
        dj = max(abs(c.l2_l2_u / l2u - 1.0), abs(c.l2_l2_p / l2p - 1.0))
        print(f"# feq small ref {ref}: FGMRES iterations card "
              f"{g.total_iterations} CPU {c.total_iterations} stfem_tpu "
              f"{its}; norms card/CPU {dn:.2e} relative (tol 1e-8), L2-L2 "
              f"CPU/stfem_tpu {dj:.2e} (tol 1e-8)", flush=True)
        if (g.total_iterations != c.total_iterations
                or c.total_iterations != its or max(dn, dj) > 1e-8):
            raise AssertionError(f"feq small ref {ref}: card, CPU and "
                                 "stfem_tpu differ")
    print(f"# feq launches {counts}: the path runs no port kernel "
          f"(stfem_tpu's counterpart reaches no Pallas call); phase wall "
          f"{time.time() - t_phase:.1f} s", flush=True)
    return counts


def dirichlet_heat_phase(wrappers, dev, refinements=(2, 3, 4, 5),
                         slabs_max=None) -> dict:
    """Phase 17(c): strong inhomogeneous Dirichlet heat --
    run_heat_cycle with configs/tp01_convergence_3d_heat_dg1.json's
    discretisation (Q2 x dG(1), 2 steps a slab, GMGParams' defaults) on
    [0.25, 1.25]^3 with heat "solution 2" (problems/manufactured.py) as
    the exact solution, the rhs and dirichlet_g, and the lift.  Per slab
    the FGMRES iterations, the slab wall and a true FP64 residual against
    the lifted rhs through unmasked element matrices (no code shared with
    the "kron" route), within 2x of FGMRES's stop test; per refinement
    the largest gap between the solution's constrained dofs and g at the
    block times (1e-12), the errors and the K1-K4 launches; the L2-L2
    rate between whole refinements >= 1.8.  slabs_max[ref] cuts a
    refinement's march.  Returns the launches over the phase; K1-K4 must
    launch at the finest refinement."""
    import torch
    from stfem_tpu_torch import bench_heat
    from stfem_tpu_torch.drivers.heat import (run_heat_cycle,
                                              stmg_preconditioner_factory)
    from stfem_tpu_torch.problems.manufactured import heat2
    from stfem_tpu_torch.time.tables import get_fe_time_weights
    from stfem_tpu_torch.types import TimeStepType
    from stfem_tpu_torch.utils.timer import TimerOutput

    t_phase = time.time()
    slabs_max = slabs_max or {}
    f64 = torch.float64
    exact, grad, rhs_fn = heat2(3)
    total = dict.fromkeys(wrappers, 0)
    names = {"K1": ("time_solve",), "K2": ("kron_pair",),
             "K3": ("banded_apply",), "K4": ("chain_down", "chain_up")}
    errs, last_counts = {}, {}
    for ref in refinements:
        for w in wrappers.values():
            w.launches = 0
        rows, held = [], {}

        def on_slab(integ, t, dt, prev, x, stats):
            saved = {name: w.launches for name, w in wrappers.items()}
            K, M, bv = (integ.matrix.K, integ.matrix.M,
                        integ.boundary_values)
            if "EK" not in held:
                held.update(EK=K.element_matrices(masked=False),
                            EM=M.element_matrices(masked=False))
            EK, EM, cells, mask = held["EK"], held["EM"], K.cells, K.mask
            A, B, G, _ = (torch.as_tensor(t_, dtype=f64, device=dev)
                          for t_ in get_fe_time_weights(TimeStepType.DG, 1,
                                                        dt, 2))

            def apply(v):
                return mask * (torch.einsum("ji,i...->j...", A,
                                            _element_apply(EK, v, cells, 2))
                               + torch.einsum("ji,i...->j...", B,
                                              _element_apply(EM, v, cells,
                                                             2)))

            x_g = bv.blocks(t)
            rhs = (G[:, 0].reshape(-1, 1, 1, 1)
                   * (mask * _element_apply(EM, prev, cells, 2))[None]
                   + integ.assemble_force(t, dt) - apply(x_g))
            rn = float((rhs - apply(mask * x)).norm())
            r0 = float((rhs - apply(mask * integ._extrapolate(prev))).norm())
            tol = max(integ.abstol, integ.reltol * r0)
            gap = max(float(((x - exact(bv.coords, t + float(o)))
                             * bv.bnd)[i].abs().max())
                      for i, o in enumerate(bv.offsets))
            rows.append((stats.iterations, rn, r0, tol, gap))
            held.update(integ=integ, rhs=rhs)
            for name, w in wrappers.items():
                w.launches = saved[name]

        timer = TimerOutput()
        t0 = time.time()
        res = run_heat_cycle(
            refinement=ref, fe_degree=1, type_=TimeStepType.DG,
            n_timesteps_at_once=2, subdivisions=(1, 1, 1),
            lower=(0.25,) * 3, upper=(1.25,) * 3,
            preconditioner_factory=stmg_preconditioner_factory(
                fe_degree_min=1),
            exact_override=(exact, grad), rhs_fn_override=rhs_fn,
            dirichlet_g=exact, boundary_lift=True, timer=timer, device=dev,
            on_slab=on_slab, n_slabs_max=slabs_max.get(ref))
        wall = time.time() - t0
        counts = {name: w.launches for name, w in wrappers.items()}
        for name, c in counts.items():
            total[name] += c
        last_counts = {k: sum(counts[n] for n in ns)
                       for k, ns in names.items()}
        whole = ref not in slabs_max
        if whole:
            errs[ref] = res.l2_l2
        walls = timer.times["step"]
        st = res.n_blocks * res.n_dofs
        worst = max(r[1] / r[3] for r in rows)
        saved = {name: w.launches for name, w in wrappers.items()}
        v = held["rhs"] / held["rhs"].norm()
        vprof = bench_heat.profile_slab(
            lambda: held["integ"].preconditioner(v), dev, top=4)
        for name, w in wrappers.items():     # not the path's launches
            w.launches = saved[name]
        print(f"# dirichlet heat {2 ** ref}^3 Q2 x dG(1), 2 steps a slab "
              f"({st} space-time DoFs a slab): {res.n_timesteps} slabs"
              f"{'' if whole else ' (cut)'}, FGMRES iterations "
              f"{res.slab_iterations}; slab walls mean "
              f"{sum(walls) / len(walls):.4f} s (max {max(walls):.4f}), "
              f"{st * len(walls) / sum(walls):.4e} space-time DoF/s; true "
              f"FP64 ||r|| / FGMRES tol worst {worst:.3f} (first slab "
              f"{rows[0][1]:.3e} vs {rows[0][3]:.3e}); largest |x - g| on "
              f"the constrained dofs {max(r[4] for r in rows):.3e}; setup "
              f"{timer.totals['setup']:.2f} s (hierarchy "
              f"{timer.totals['setup:gmg']:.2f} s); L2-L2 {res.l2_l2:.6e} "
              f"Linf {res.linf_linf:.6e} H1 {res.l2_h1:.6e}; K1-K4 launches "
              f"{last_counts}; one V-cycle: {vprof['n_kernel_launches']} "
              f"launches, {vprof['wall_s'] * 1e3:.2f} ms wall, busy share "
              f"{vprof['device_busy_share']:.4f}; run wall {wall:.1f} s",
              flush=True)
        if worst > 2.0 or max(r[4] for r in rows) > 1e-12:
            raise AssertionError(f"dirichlet heat {ref}: a slab missed its "
                                 "residual or its boundary values")
        held.clear()
        torch.cuda.empty_cache()
    refs = sorted(errs)
    rates = [(a, b, float(np.log2(errs[a] / errs[b])))
             for a, b in zip(refs, refs[1:])]
    missing = [k for k, c in last_counts.items() if c == 0]
    print(f"# dirichlet heat L2-L2 rates between whole refinements "
          f"{[(a, b, round(r, 3)) for a, b, r in rates]} (bar 1.8); kernels "
          f"not launched at the finest refinement {missing}; phase wall "
          f"{time.time() - t_phase:.1f} s", flush=True)
    if not rates or rates[-1][2] < 1.8 or missing:
        raise AssertionError("dirichlet heat: rate or kernels failed")
    return total


# phase 18(a): bench_heat's switches at 8^3 cells, 8 steps a slab
SWITCH_CASES = (("defaults", {}), ("outer fgmres", {"outer": "fgmres"}),
                ("ir off", {"ir": False}),
                ("outer chebyshev", {"outer": "chebyshev"}),
                ("nopost_fine, post_inner 1", {"nopost_fine": True,
                                               "post_inner": 1}),
                ("variable, vcap 2", {"variable": True, "vcap": 2}),
                ("smoothall", {"smoothall": True}),
                ("bf16 Vanka, float32 levels", {"bf16": True,
                                                "level_bf16": False}))


def switches_phase(wrappers, dev) -> dict:
    """Phase 18: bench.py's switches, the combined bench, the estimate
    cache and a one-rank NCCL group.  (a) bench_heat.run at 8^3 cells, 8
    steps a slab, the probe and 1 timed slab, for each of SWITCH_CASES:
    the iterations (first solve and total), the setup, probe and slab
    walls; every IR run reaches TRUE <= 1e-8, the float32-only run its
    Givens 1e-8; the bf16-Vanka run's finest Vanka dtypes, and K4 on that
    case's (float32 vectors, bf16 matrices) instance against its plain
    version.  (b) python -m stfem_tpu_torch.bench at reduced sizes (heat
    8^3, wave 4^3, Stokes 4^3, 1 timed slab each) in a subprocess: exit
    code 0, the summary with all three sections, the heat metric line
    last.  (c) the bench's 16^3 heat hierarchy built twice with a fresh
    cache file: the second build runs no estimate and gives bitwise-equal
    omegas; both setup times.  (d) a one-rank NCCL group:
    make_sharded_vmult equals SystemMatrix.vmult bitwise, psum_dot the
    plain dot.  Returns (a)'s launches; K1, K2, K3 and K4 must launch."""
    import torch
    import torch.distributed as dist
    from datetime import timedelta
    from stfem_tpu_torch import bench_heat
    from stfem_tpu_torch.mesh.grid import StructuredMesh
    from stfem_tpu_torch.ops.grid_chain import (chain_down,
                                                chain_down_reference,
                                                chain_up, chain_up_reference)
    from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
    from stfem_tpu_torch.parallel.comm import psum_dot
    from stfem_tpu_torch.parallel.halo import make_sharded_vmult
    from stfem_tpu_torch.parallel.sharding import spatial_mesh
    from stfem_tpu_torch.stmg.gmg import bench_params, build_stmg
    from stfem_tpu_torch.system import SystemMatrix
    from stfem_tpu_torch.time.tables import get_fe_time_weights
    from stfem_tpu_torch.types import TimeStepType

    t_phase = time.time()
    # (a) the switches, through one estimate cache that (b) reads too: the
    # cases whose levels are alike estimate once
    cache_dir = tempfile.TemporaryDirectory()
    os.environ["STFEM_EIG_CACHE"] = os.path.join(cache_dir.name, "a.json")
    for w in wrappers.values():
        w.launches = 0
    for label, kw in SWITCH_CASES:
        info, _ = bench_heat.run(8, 8, n_slabs=1, device="cuda", **kw)
        ir = kw.get("ir", True)
        print(f"# switches {label}: outer {info['outer']}, V-cycles "
              f"{info['iters']} (first solve {info['first_iters']}), TRUE "
              f"rel {info['true_rels']}, converged {info['converged']}, "
              f"setup {info['setup_s']:.2f} s, probe {info['probe_s']:.2f} "
              f"s, slab {[round(t, 4) for t in info['slab_s']]} s, "
              f"{info['dofs_per_s']:.4e} DoF/s, estimates "
              f"{info['estimates']}, fine Vanka "
              f"{info['fine_vanka']}"
              + (f", rho {info['rho']:.4f}" if info["rho"] else ""),
              flush=True)
        ok = info["converged"] and (
            not ir or all(r <= 1e-8 for r in info["true_rels"]))
        if not ok:
            raise AssertionError(f"switches {label}: not converged")
        if kw.get("level_bf16") is False:
            fine = info["fine_vanka"]
            if (fine["vectors"], fine["matrices"]) != ("float32",
                                                       "bfloat16"):
                raise AssertionError(f"bf16 Vanka on float32 levels: {fine}")
    counts = {name: w.launches for name, w in wrappers.items()}
    print(f"# switches (a) launches {counts}", flush=True)
    missing = [n for n in ("time_solve", "kron_pair", "banded_apply",
                           "chain_down", "chain_up") if counts[n] == 0]
    if missing:
        raise AssertionError(f"switches: kernels never ran: {missing}")
    # the K4 instance of the bf16-Vanka run: float32 vectors, bf16
    # matrices, at its finest level (24 blocks x 33^3 <-> 40^3)
    gen = torch.Generator(device=dev).manual_seed(18)
    k, nc, cells = 4, 8, (8,) * 3
    dn = [_vanka_band(nc, k, gen, dev).to(torch.bfloat16) for _ in range(3)]
    up = [_vanka_band(nc, k, gen, dev).T.contiguous().to(torch.bfloat16)
          for _ in range(3)]
    x = torch.randn((24,) + (nc * k + 1,) * 3, generator=gen, device=dev)
    w = chain_down(x, dn, cells=cells, k=k)
    y = chain_up(w, up, cells=cells, k=k)
    rel = max(float((w - chain_down_reference(x, dn)).abs().max()
                    / chain_down_reference(x, dn).abs().max()),
              float((y - chain_up_reference(w, up)).abs().max()
                    / chain_up_reference(w, up).abs().max()))
    print(f"# K4 grid_chain float32 vectors, bf16 matrices, 24 x 33^3 <-> "
          f"40^3: {w.dtype} / {y.dtype} out, rel to max {rel:.3e} (tol "
          f"1e-5)", flush=True)
    if not rel <= 1e-5 or w.dtype != torch.float32:
        raise AssertionError("K4 (float32, bf16) disagrees with its plain "
                             "version")
    phase_wall(t_phase, "18(a)")

    # (b) the combined bench in a subprocess
    t0 = time.time()
    root = os.path.dirname(os.path.abspath(__file__))
    cmd = [sys.executable, "-m", "stfem_tpu_torch.bench", "--cells", "8",
           "--ntao", "8", "--slabs", "1", "--wave-cells", "4", "--wave-ntao",
           "4", "--wave-slabs", "1", "--stokes-cells", "4", "--stokes-ntao",
           "4", "--stokes-slabs", "1"]
    proc = subprocess.run(cmd, cwd=root, capture_output=True, text=True,
                          timeout=300, env=dict(os.environ))
    os.environ["STFEM_EIG_CACHE"] = "0"
    cache_dir.cleanup()
    lines = proc.stdout.strip().splitlines()
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"stfem_tpu_torch.bench exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    head = "# ---- bench summary (all sections; heat metric last) ----"
    summary = [json.loads(t) for t in lines[lines.index(head) + 1:]]
    metrics = {d["metric"]: d["value"] for d in summary if "metric" in d}
    last = json.loads(lines[-1])
    print(f"# combined bench (heat 8^3, wave 4^3, Stokes 4^3, 1 slab each):"
          f" exit {proc.returncode} in {time.time() - t0:.1f} s; summary "
          f"{len(summary)} lines; metrics {metrics}", flush=True)
    for line in lines:
        if line.startswith("# ") and "skipped" in line:
            print(f"#   {line}", flush=True)
    want = {bench_heat.METRIC, "stmg_wave_slab_solve_throughput_3d_q4_dg2",
            "stmg_stokes_slab_solve_throughput_3d_q2_dgp1_dg1"}
    if set(metrics) != want or last.get("metric") != bench_heat.METRIC \
            or sum("metric" not in d for d in summary) != 3:
        raise AssertionError("combined bench: summary or last line wrong")
    phase_wall(t_phase, "18(b)")

    # (c) the estimate cache on the bench's 16^3 heat hierarchy
    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=3)
    builds = []
    with tempfile.TemporaryDirectory() as tmpd:
        os.environ["STFEM_EIG_CACHE"] = os.path.join(tmpd, "eig.json")
        try:
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.time()
                gmg = build_stmg(mesh, 2, 4, TimeStepType.DG, 32, 1 / 16,
                                 bench_params(), dtype=torch.float32,
                                 device="cuda")
                torch.cuda.synchronize()
                builds.append((time.time() - t0, dict(gmg.estimates),
                               [getattr(lvl.smoother, "omega", None)
                                for lvl in gmg.levels]))
                del gmg
        finally:
            os.environ["STFEM_EIG_CACHE"] = "0"
    (s1, e1, o1), (s2, e2, o2) = builds
    print(f"# estimate cache, 16^3 heat hierarchy: setup {s1:.2f} s "
          f"(estimates {e1}) then {s2:.2f} s ({e2}); omegas {o1} and {o2}",
          flush=True)
    if e2["computed"] != 0 or e2["read"] != e1["computed"] or o1 != o2 \
            or e1["computed"] == 0:
        raise AssertionError("estimate cache: the second build estimated or "
                             "its omegas differ")
    phase_wall(t_phase, "18(c)")

    # (d) a one-rank NCCL group
    with tempfile.TemporaryDirectory() as tmpd:
        dist.init_process_group("nccl", init_method=f"file://{tmpd}/init",
                                rank=0, world_size=1,
                                timeout=timedelta(seconds=60))
        try:
            dm = spatial_mesh(1, dim=3, device_type="cuda")
            groups = (dm.get_group("x"), dm.get_group("y"))
            m8 = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3,
                                refinement=2)
            A, B, _, _ = get_fe_time_weights(TimeStepType.DG, 2, 1 / 16, 8)
            K, M = (LaplaceMassOperator(m8, 4, 5, ms, ls, dtype=torch.float64,
                                        device=dev)
                    for ms, ls in ((0.0, 1.0), (1.0, 0.0)))
            mat = SystemMatrix(K, M, A, B)
            x = torch.randn((A.shape[0],) + m8.dof_shape(4), generator=gen,
                            device=dev, dtype=torch.float64)
            y_sh = make_sharded_vmult(mat, groups)(x)
            y = mat.vmult(x)
            dot_sh = psum_dot(x, y, groups, (1, 2))
            dot = torch.sum(x * y)
            same = bool(torch.equal(y_sh, y))
            print(f"# one-rank NCCL group ({dist.get_backend()}, mesh "
                  f"{tuple(dm.mesh.shape)}): make_sharded_vmult == "
                  f"SystemMatrix.vmult bitwise {same} ({A.shape[0]} x "
                  f"33^3 FP64); psum_dot {float(dot_sh)!r} plain dot "
                  f"{float(dot)!r}", flush=True)
            if not (same and bool(torch.equal(dot_sh, dot))):
                raise AssertionError("one-rank NCCL: sharded apply or dot "
                                     "differs")
        finally:
            dist.destroy_process_group()
    phase_wall(t_phase, "18")
    return counts


# phase 19: the sharded solve at stfem_tpu's dry-run size and the headline
# size, on 8 gloo processes sharing the card
SHARDED_CASES = (("(a)", dict(cells=8, ntao=8)),
                 ("(b)", dict(cells=16, ntao=32)))


def sharded_kernel_checks(dev, gen, label: str, kw: dict) -> None:
    """Phase 19's kernels against their plain versions at the shapes, and
    with the matrices, that the sharded solve of case kw gives them on a
    rank: rank (0, 0, 0) of the (2, 2, 2) mesh (every rank's slab has its
    shape).  K2 on the FP64 residual's pair input (the local sub-mesh's
    factors under the global mask; rel 1e-14, as phase 4), and on each
    sharded level of the V-cycle the sliced Vanka's K4 down chain, K1
    (where the level solves several steps at once) and K4 up chain, in
    float32 (rel 1e-5, as phases 3 and 5).  The global hierarchy is
    rebuilt here from the estimates the ranks left in the cache."""
    import torch
    from stfem_tpu_torch.ops.grid_chain import (chain_down,
                                                chain_down_reference,
                                                chain_up, chain_up_reference)
    from stfem_tpu_torch.ops.kron_pair import kron_pair, kron_pair_reference
    from stfem_tpu_torch.ops.kronfac import KronAssembled
    from stfem_tpu_torch.ops.slab_residual import SlabResidual64
    from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
    from stfem_tpu_torch.ops.time_solve import (time_solve,
                                                time_solve_reference)
    from stfem_tpu_torch.parallel.minibench import hierarchy, minibench_mesh
    from stfem_tpu_torch.parallel.sharding import (RankLayout,
                                                   level_sharding_policy)
    from stfem_tpu_torch.stmg.eig_cache import EstimateCache, cache_path

    f64 = torch.float64
    mesh = minibench_mesh(kw["cells"])
    (Alpha, Beta, Gamma), gmg = hierarchy(
        mesh, kw["ntao"], device=dev,
        estimate_cache=EstimateCache(cache_path()))
    layout = RankLayout((2, 2, 2), (0, 0, 0), (None,) * 3, np.arange(8))
    sub, mask = layout.submesh(mesh), layout.mask(mesh, 4)
    kron = KronAssembled(*(LaplaceMassOperator(
        sub, 4, 5, ms, ls, dtype=f64, device=dev, mask=mask)
        for ms, ls in ((0.0, 1.0), (1.0, 0.0))), f64)
    resid = SlabResidual64(kron, mask, Alpha, Beta, Gamma)
    x = torch.randn((resid.n_coupling + resid.nt,
                     resid.n_blocks // resid.nt) + sub.dof_shape(4),
                    generator=gen, device=dev, dtype=f64)
    got, ref = (f(x, kron.Md, kron.Ad, kron.k)
                for f in (kron_pair, kron_pair_reference))
    rel = max(float((g - r).abs().max() / r.abs().max())
              for g, r in zip(got, ref))
    print(f"# sharded {label} K2 kron_pair f64 {tuple(x.shape)} k=4 (the "
          f"residual's pair on a rank's sub-mesh): rel to max {rel:.3e} "
          f"(tol 1e-14)", flush=True)
    if not rel <= 1e-14:
        raise AssertionError(f"sharded {label}: K2 disagrees with its plain "
                             "version")
    del x, got, ref, kron, resid
    policy = level_sharding_policy(8, gmg, min_dofs_per_device=2048)
    for lvl_idx, p in enumerate(policy):
        lvl = gmg.levels[lvl_idx]
        vanka = getattr(lvl.smoother, "precond", None)
        if p != "sharded" or vanka is None:
            continue
        K = lvl.matrix.K
        van = vanka.shard(layout.cell_ranges(K.cells))
        nb = lvl.n_blocks
        src = torch.randn((nb,) + layout.submesh(K.mesh).dof_shape(K.degree),
                          generator=gen, device=dev).to(van.dtype)
        w = chain_down(src, van.Wdn, cells=van.cells, k=van.k)
        rels = {"K4 down": (w, chain_down_reference(src, van.Wdn))}
        up_in = w
        if van.n_steps > 1:
            S, wf = van.n_steps, w.reshape(nb, -1)
            t = time_solve(wf, van.GinvT, van.cvecT, S, nb // S, wf.dtype)
            rels["K1"] = (t, time_solve_reference(wf, van.GinvT, van.cvecT,
                                                  S, nb // S, wf.dtype))
            up_in = t.reshape(w.shape).to(van.dtype)
        y = chain_up(up_in, van.Wup, cells=van.cells, k=van.k)
        rels["K4 up"] = (y, chain_up_reference(up_in, van.Wup))
        rels = {n: float((g.float() - r.float()).abs().max()
                         / r.float().abs().max())
                for n, (g, r) in rels.items()}
        print(f"# sharded {label} level {lvl_idx} Vanka {nb} x "
              f"{tuple(src.shape[1:])} Q{van.k} cells {van.cells} "
              f"{str(van.dtype)[6:]} (steps {van.n_steps}, K1 N = "
              f"{w[0].numel()}): rel to max "
              f"{ {n: f'{r:.3e}' for n, r in rels.items()} } (tol 1e-5)",
              flush=True)
        if not all(r <= 1e-5 for r in rels.values()):
            raise AssertionError(f"sharded {label} level {lvl_idx}: a "
                                 "kernel disagrees with its plain version")
    del gmg
    torch.cuda.empty_cache()


def sharded_phase(smi: str, dev, gen) -> dict:
    """Phase 19 (module docstring): returns the kernel launches of the
    sharded solves of (a) and (b), summed over the ranks."""
    import torch
    import torch.distributed as dist
    from datetime import timedelta
    from stfem_tpu_torch.parallel.dryrun import dryrun_multichip
    from stfem_tpu_torch.parallel.minibench import (SOLUTION_RTOL,
                                                    run_sharded_minibench)

    t_phase = time.time()
    counts = {}
    with tempfile.TemporaryDirectory() as tmpd:
        os.environ["STFEM_EIG_CACHE"] = os.path.join(tmpd, "eig.json")
        try:
            for label, kw in SHARDED_CASES:
                t0 = time.time()
                outs = dryrun_multichip(8, "cuda", verbose=False, **kw)
                wall = time.time() - t0
                o = outs[0]
                launches = {n: sum(x["launches"][n] for x in outs)
                            for n in o["launches"]}
                for n, c in launches.items():
                    counts[n] = counts.get(n, 0) + c
                col = o["collectives"]
                print(f"# sharded {label} {kw['cells']}^3 ntao={kw['ntao']}"
                      f" ({o['n_blocks']} blocks x {o['space_dofs']} dofs) "
                      f"on 8 gloo processes sharing one card ({smi}; not a "
                      f"scaling figure): mesh {o['mesh']}, local grid "
                      f"{o['local_dof_shape']}, policy {o['policy']}; "
                      f"V-cycle steps single {o['single_iters']} sharded "
                      f"{o['sharded_iters']}; TRUE rel single "
                      f"{o['single_true_rel']:.3e} sharded "
                      f"{o['sharded_true_rel']:.3e}; gathered solution "
                      f"within {o['solution_rel_diff']:.3e} of the single "
                      f"one (tol {SOLUTION_RTOL:g}); slab wall single "
                      f"{o['single_s']:.2f} s, sharded {o['sharded_s']:.2f} "
                      f"s; collectives per rank {col}; residual "
                      f"{o['residual_kernel']}; launches over the ranks "
                      f"{launches}; phase wall {wall:.1f} s", flush=True)
                if not all(x["converged"] and x["iter_parity"]
                           and x["solution_match"] for x in outs):
                    raise AssertionError(f"sharded {label}: not converged, "
                                         "no iteration parity or another "
                                         "solution")
                if label == "(a)" and not (
                        col["halo_exchanges"] > 0 and col["all_reduces"]
                        <= max(100, col["halo_exchanges"] // 4)):
                    raise AssertionError(f"sharded (a): collectives {col} "
                                         "outside the budget")
                sharded_kernel_checks(dev, gen, label, kw)
                phase_wall(t_phase, f"19{label}")
            with tempfile.TemporaryDirectory() as initd:
                dist.init_process_group("nccl",
                                        init_method=f"file://{initd}/init",
                                        rank=0, world_size=1,
                                        timeout=timedelta(seconds=300))
                try:
                    out = run_sharded_minibench(
                        **SHARDED_CASES[0][1], device="cuda",
                        keep_solutions=True, verbose=False)
                finally:
                    dist.destroy_process_group()
        finally:
            os.environ["STFEM_EIG_CACHE"] = "0"
    same = bool(torch.equal(out["single_x"], out["sharded_x"]))
    print(f"# sharded (c) one-rank NCCL group, 8^3 ntao=8: V-cycle steps "
          f"single {out['single_iters']} sharded {out['sharded_iters']}, "
          f"solution bitwise the unsharded one's: {same}, collectives "
          f"{out['collectives']}", flush=True)
    if not (same and out["iter_parity"]
            and not any(out["collectives"].values())):
        raise AssertionError("one-rank NCCL: the sharded solve differs from "
                             "the unsharded one or communicated")
    missing = [n for n in ("time_solve", "kron_pair", "banded_apply",
                           "chain_down", "chain_up") if counts.get(n, 0) == 0]
    if missing:
        raise AssertionError(f"sharded: kernels never ran: {missing}")
    phase_wall(t_phase, "19")
    return counts


def phase_wall(t_phase: float, name: str) -> None:
    print(f"#   (phase {name} at {time.time() - t_phase:.1f} s)", flush=True)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from stfem_tpu_torch import bench_heat, bench_stokes, bench_wave
        from stfem_tpu_torch.config import Parameters
        from stfem_tpu_torch.drivers import tp01
        from stfem_tpu_torch.mesh.grid import StructuredMesh
        from stfem_tpu_torch.ops import cuda_kernels
        from stfem_tpu_torch.ops.banded_apply import (banded_apply,
                                                      banded_apply_reference)
        from stfem_tpu_torch.ops.grid_chain import (chain_down,
                                                    chain_down_reference,
                                                    chain_up,
                                                    chain_up_reference)
        from stfem_tpu_torch.ops.kron_pair import (kron_pair,
                                                   kron_pair_reference)
        from stfem_tpu_torch.ops.kronfac import KronAssembled
        from stfem_tpu_torch.ops.quad_middle import (quad_middle,
                                                     quad_middle_reference)
        from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
        from stfem_tpu_torch.ops.stokes import StokesOperator
        from stfem_tpu_torch.ops.stokes_residual import KronStokes64
        from stfem_tpu_torch.ops.time_solve import (time_solve,
                                                    time_solve_reference)
        from stfem_tpu_torch.problems import heat
        from stfem_tpu_torch.problems.coefficient import Coefficient
        from stfem_tpu_torch.system import SystemMatrix
    except ImportError as e:
        print(f"chip_smoke: the stfem_tpu_torch package is missing ({e})",
              file=sys.stderr)
        return 3
    dev = torch.device("cuda")
    # phases 1-17 estimate afresh (no estimate disk cache): their numbers
    # stay what they were; phase 18(c) measures the cache
    os.environ["STFEM_EIG_CACHE"] = "0"
    smi = _smi_line()
    t_start = time.time()

    def phase_done(name: str) -> None:
        print(f"#   ({name} done at {time.time() - t_start:.1f} s)",
              flush=True)

    # 1. device
    print(f"# device: {smi} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | {torch.cuda.get_device_name(0)}",
          flush=True)

    # 2. build
    secs, log = cuda_kernels.build(force=True, verbose=True)
    for line in log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            print("#   " + line.strip())
    cuda_kernels.library()
    print(f"# build: {secs:.1f} s -> {cuda_kernels.LIB_PATH}", flush=True)

    gen = torch.Generator(device=dev).manual_seed(0)
    report, extras = {}, {}

    # 3. K1 parity at the heat bench's shape, at the coefficient path's
    #    cell-local Vanka shapes (16^3 Q3: N = C A = 262,144; dG(2) levels
    #    with 8 and 4 steps, dG(1) levels with 4) and at the distorted
    #    path's finest cell-mode level (32^3 Q2: N = C A = 884,736; dG(1),
    #    2 steps; its coarser levels are the same call on fewer cells)
    for S, nt, N, dts in (
            (32, 3, (16 * 5) ** 3, ((torch.bfloat16, 8e-3),
                                    (torch.float32, 1e-5))),
            (8, 3, 4096 * 64, ((torch.float32, 1e-5),)),
            (4, 2, 4096 * 64, ((torch.float32, 1e-5),)),
            (2, 2, 32 ** 3 * 27, ((torch.float32, 1e-5),)),
            # dG(4) (nt = 5) at the grid Vanka of a 16^3 Q5 level, 2 steps
            (2, 5, 96 ** 3, ((torch.float32, 1e-5),))):
        G = (0.3 * torch.randn((nt, nt, N), generator=gen, device=dev))
        c = torch.rand((nt, N), generator=gen, device=dev) * 1.8 - 0.9
        for dt, tol in dts:
            w = torch.randn((S * nt, N), generator=gen, device=dev).to(dt)
            got = time_solve(w, G, c, S, nt, dt).float()
            ref = time_solve_reference(w, G, c, S, nt, dt).float()
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            ms = _cuda_ms(lambda: time_solve(w, G, c, S, nt, dt), 20)
            plain = _cuda_ms(lambda: time_solve_reference(w, G, c, S, nt,
                                                          dt), 5)
            print(f"# K1 time_solve S={S} nt={nt} N={N} {str(dt)[6:]}: "
                  f"max_abs_err {err:.3e} (rel to max {err / scale:.3e}, "
                  f"tol {tol:g}) kernel {ms:.4f} ms plain {plain:.4f} ms",
                  flush=True)
            if not err <= tol * scale:
                raise AssertionError("K1 disagrees with its plain version")
            if S != 32 or dt != torch.bfloat16:
                continue
            # at the heat bench's shape and level dtype: read w, the
            # factors and write y once; 2 nt (nt + 1) flops per position
            # and step, in float32
            bound = _bound(_nbytes(w, G, c) + _nbytes(got.to(dt)),
                           2.0 * nt * (nt + 1) * S * N, "f32")
            report["time_solve"] = (err, ms, plain, None) + bound

    # 4. K2 parity at the bench shape, with the bench's 1D factors
    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=3)
    K64 = LaplaceMassOperator(mesh, 4, 5, 0.0, 1.0, dtype=torch.float64,
                              device=dev)
    M64 = LaplaceMassOperator(mesh, 4, 5, 1.0, 0.0, dtype=torch.float64,
                              device=dev)
    kron = KronAssembled(K64, M64, torch.float64)
    x = torch.randn((128,) + mesh.dof_shape(4), generator=gen, device=dev,
                    dtype=torch.float64)
    Kk, Mk = kron_pair(x, kron.Md, kron.Ad, kron.k)
    Kr, Mr = kron_pair_reference(x, kron.Md, kron.Ad, kron.k)
    err = max(float((Kk - Kr).abs().max()), float((Mk - Mr).abs().max()))
    rel = max(float((Kk - Kr).abs().max() / Kr.abs().max()),
              float((Mk - Mr).abs().max() / Mr.abs().max()))
    del Kk, Mk, Kr, Mr
    ms = _cuda_ms(lambda: kron_pair(x, kron.Md, kron.Ad, kron.k), 10)
    plain = _cuda_ms(lambda: kron_pair_reference(x, kron.Md, kron.Ad,
                                                 kron.k), 3)
    # read x, write K x and M x once; per element 2(2k+1) flops for each
    # of the first axis' two tap sets and of each later axis' three
    k = kron.k
    bound = _bound(3 * _nbytes(x), x.numel() * 16.0 * (2 * k + 1), "f64")
    print(f"# K2 kron_pair f64 B=128 n=65 k=4: max_abs_err {err:.3e} "
          f"(rel to max {rel:.3e}, tol 1e-14) kernel {ms:.4f} ms plain "
          f"{plain:.3f} ms bound {bound[0]:.4f} ms ({bound[1]}); share of "
          f"bound {bound[0] / ms:.3f}", flush=True)
    if not rel <= 1e-14:
        raise AssertionError("K2 disagrees with its plain version")
    report["kron_pair"] = (err, ms, plain, None) + bound
    phase_done("K1, K2")

    # 4b. K3 parity along every axis, at the large shape (the heat factors)
    #     and at the Stokes rhs shape (the Stokes velocity factors)
    m8 = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=2)
    st_kron = KronStokes64(StokesOperator(m8, 2, 1, 3, dtype=torch.float64,
                                          device=dev)).base
    xs = torch.randn((3,) + m8.dof_shape(2), generator=gen, device=dev,
                     dtype=torch.float64)
    # Q5 (k = 5): the CGP(4) check of phase 11 (8 blocks x 11^3) and a
    # 16^3 Q5 grid (81^3) with 8 blocks
    q5 = [KronAssembled(*(LaplaceMassOperator(
        StructuredMesh([c] * 3, [0.0] * 3, [1.0] * 3), 5, 6, m, l,
        dtype=torch.float64, device=dev) for m, l in ((0.0, 1.0),
                                                      (1.0, 0.0))),
        torch.float64) for c in (2, 16)]
    x5 = [torch.randn((8,) + (c * 5 + 1,) * 3, generator=gen, device=dev,
                      dtype=torch.float64) for c in (2, 16)]
    for label, xk, kr in (("B=128 x 65^3 k=4", x, kron),
                          ("Stokes 3 x 17^3 k=2", xs, st_kron),
                          ("Q5 8 x 11^3 k=5", x5[0], q5[0]),
                          ("Q5 8 x 81^3 k=5", x5[1], q5[1])):
        errs, rels, mss, plains, libs = [], [], [], [], []
        for d, axis in enumerate((-3, -2, -1)):
            D, A = kr.Md[d], kr.M1[d]
            got = banded_apply(xk, D, axis, kr.k)
            ref = banded_apply_reference(xk, D, axis, kr.k)
            errs.append(float((got - ref).abs().max()))
            rels.append(errs[-1] / float(ref.abs().max()))
            del got, ref
            mss.append(_cuda_ms(lambda: banded_apply(xk, D, axis, kr.k), 20))
            plains.append(_cuda_ms(
                lambda: banded_apply_reference(xk, D, axis, kr.k), 3))
            lib = {-3: lambda: A @ xk.reshape(xk.shape[0], xk.shape[1], -1),
                   -2: lambda: A @ xk,
                   -1: lambda: xk @ A.T}[axis]
            libs.append(_cuda_ms(lib, 20))
        bound = _bound(2 * _nbytes(xk), xk.numel() * 2.0 * (2 * kr.k + 1),
                       "f64")
        ratios = [m / lb for m, lb in zip(mss, libs)]
        # the same bytes moved by a plain copy: what the memory system
        # gives a read-once, write-once pass on this card
        copy = _cuda_ms(lambda: torch.empty_like(xk).copy_(xk), 20)
        print(f"# K3 banded_apply f64 {label}, axes (-3, -2, -1): "
              f"max_abs_err {max(errs):.3e} (rel to max {max(rels):.3e}, "
              f"tol 1e-14) kernel {[round(t, 4) for t in mss]} ms plain "
              f"{[round(t, 4) for t in plains]} ms dense matmul "
              f"{[round(t, 4) for t in libs]} ms, bound {bound[0]:.4f} ms "
              f"({bound[1]}); kernel / matmul "
              f"{[round(r, 3) for r in ratios]}, share of bound "
              f"{[round(bound[0] / m, 3) for m in mss]}; a copy of x "
              f"{copy:.4f} ms", flush=True)
        if not max(rels) <= 1e-14:
            raise AssertionError("K3 disagrees with its plain version")
        if label.startswith("B=128"):
            # the axis where the kernel fares worst against the matmul
            # stands in the line; every axis beside it
            w = int(np.argmax(ratios))
            report["banded_apply"] = (max(errs), mss[w], plains[w],
                                      libs[w]) + bound
            extras["banded_apply"] = {
                "axis": (-3, -2, -1)[w], "copy_ms": copy, "ms_by_axis": mss,
                "plain_ms_by_axis": plains, "library_ms_by_axis": libs}
    del x, xs, kron, st_kron, q5, x5
    torch.cuda.empty_cache()
    phase_done("K3")

    # 5. K4 parity at the Vanka fine levels of both main paths: the down
    #    chain, then the up chain on its output, with the einsum of the
    #    same dense matrices as the library yardstick
    for label, nb, nc in (("heat", 96, 16), ("wave", 48, 8)):
        k, n, cells = 4, nc * 4 + 1, (nc,) * 3
        for dt, tol in ((torch.bfloat16, 8e-3), (torch.float32, 1e-5)):
            dn = [_vanka_band(nc, k, gen, dev).to(dt) for _ in range(3)]
            up = [_vanka_band(nc, k, gen, dev).T.contiguous().to(dt)
                  for _ in range(3)]
            x = torch.randn((nb, n, n, n), generator=gen, device=dev).to(dt)
            w = chain_down(x, dn, cells=cells, k=k)
            wr = chain_down_reference(x, dn)
            y = chain_up(w, up, cells=cells, k=k)
            yr = chain_up_reference(w, up)
            err = max(float((w.float() - wr.float()).abs().max()),
                      float((y.float() - yr.float()).abs().max()))
            rel = max(float((w.float() - wr.float()).abs().max()
                            / wr.float().abs().max()),
                      float((y.float() - yr.float()).abs().max()
                            / yr.float().abs().max()))
            del wr, yr
            ms = (_cuda_ms(lambda: chain_down(x, dn, cells=cells, k=k), 20)
                  + _cuda_ms(lambda: chain_up(w, up, cells=cells, k=k), 20))
            plain = (_cuda_ms(lambda: chain_down_reference(x, dn), 3)
                     + _cuda_ms(lambda: chain_up_reference(w, up), 3))
            lib = (_cuda_ms(lambda: torch.einsum("bijk,ai,cj,dk->bacd", x,
                                                 *dn), 5)
                   + _cuda_ms(lambda: torch.einsum("bijk,ai,cj,dk->bacd", w,
                                                   *up), 5))
            # down: read x, write w; up: read w, write y; per output
            # element k+1 banded taps on each of the three axes
            nq = nc * (k + 1)
            flops = 2.0 * (k + 1) * nb * (
                nq * n * n + nq * nq * n + nq ** 3) * 2
            bound = _bound(2 * _nbytes(w) + _nbytes(x, y), flops, "f32")
            print(f"# K4 grid_chain {label} fine {nb} x {n}^3 <-> "
                  f"{nq}^3 {str(dt)[6:]}: max_abs_err {err:.3e} "
                  f"(rel to max {rel:.3e}, tol {tol:g}) kernel down+up "
                  f"{ms:.4f} ms plain {plain:.4f} ms einsum {lib:.4f} ms "
                  f"bound {bound[0]:.4f} ms ({bound[1]}); kernel / einsum "
                  f"{ms / lib:.3f}, share of bound {bound[0] / ms:.3f}",
                  flush=True)
            if not rel <= tol:
                raise AssertionError("K4 disagrees with its plain version")
            if dt == torch.bfloat16 and label == "heat":
                report["grid_chain"] = (err, ms, plain, lib) + bound
            del x, w, y
    torch.cuda.empty_cache()

    phase_done("K4")

    # 5b. K5 parity at the coefficient path's outer-operator shape, with
    #     the route-3 tables of its 16^3 Q3 operator
    cmesh = StructuredMesh([4, 4, 4], [0.0] * 3, [1.0] * 3, refinement=2)
    coef = Coefficient([4, 4, 4], [0.0] * 3, [1.0] * 3, 0.5)
    qsys = SystemMatrix(
        LaplaceMassOperator(cmesh, 3, 4, 0.0, 1.0, device=dev,
                            coefficient=coef),
        LaplaceMassOperator(cmesh, 3, 4, 1.0, 0.0, device=dev),
        np.eye(24), np.eye(24))
    assert qsys.route == "quad"
    Q = 64
    # the outer operator (24 blocks) in both types, and the FP64 rhs slice
    # (3 rows from 1 source block)
    for T, dt, tol, kind in ((24, torch.float64, 1e-12, "f64"),
                             (24, torch.float32, 1e-5, "f32"),
                             (3, torch.float64, 1e-12, "f64")):
        P, PT, W = (t.to(dt).contiguous()
                    for t in (qsys._phig, qsys._phigT, qsys._w))
        ub, ua = (torch.randn((T, cmesh.n_cells, 64), generator=gen,
                              device=dev, dtype=dt) for _ in range(2))
        got = quad_middle(ub, ua, P, W, Q, PT)
        ref = quad_middle_reference(ub, ua, P, W, Q)
        err = float((got - ref).abs().max())
        rel = err / float(ref.abs().max())
        del ref

        def cublas():
            T_, C_, A_ = ub.shape
            qv = (ub.reshape(T_ * C_, A_) @ P[:, :Q]).reshape(T_, C_, Q)
            qg = (ua.reshape(T_ * C_, A_) @ P[:, Q:]).reshape(T_, C_, -1)
            return ((qv * W[:, :Q]).reshape(T_ * C_, Q) @ P[:, :Q].T
                    + (qg * W[:, Q:]).reshape(T_ * C_, -1) @ P[:, Q:].T)

        ms = _cuda_ms(lambda: quad_middle(ub, ua, P, W, Q, PT), 20)
        plain = _cuda_ms(lambda: quad_middle_reference(ub, ua, P, W, Q), 5)
        lib = _cuda_ms(cublas, 20)
        # read ub, ua, PhiG and W, write y once; 2 flops per multiply-add,
        # A x NQ of them forward and back per block and cell
        bound = _bound(_nbytes(ub, ua, P, W, got),
                       4.0 * ub.numel() * P.shape[1], kind)
        print(f"# K5 quad_middle {kind} T={T} C=4096 A=64 NQ=256: "
              f"max_abs_err {err:.3e} (rel to max {rel:.3e}, tol {tol:g}) "
              f"kernel {ms:.4f} ms plain {plain:.4f} ms cuBLAS four "
              f"products {lib:.4f} ms bound {bound[0]:.4f} ms ({bound[1]}); "
              f"kernel / cuBLAS {ms / lib:.3f}, share of bound "
              f"{bound[0] / ms:.3f}", flush=True)
        if not rel <= tol:
            raise AssertionError("K5 disagrees with its plain version")
        if T == 24 and dt == torch.float64:     # the outer operator
            report["quad_middle"] = (err, ms, plain, lib) + bound
        del ub, ua, got
    del qsys
    torch.cuda.empty_cache()
    phase_done("K5")

    # 6. small inputs: GPU kernels vs the CPU plain path, and vs the exact
    #    solution at the end of the last slab
    torch.set_num_threads(1)
    m4 = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
    coords4 = torch.as_tensor(m4.dof_coordinates(4), dtype=torch.float64)
    for label, runner in (
            ("heat", lambda d: bench_heat.run(4, 4, n_slabs=3, device=d,
                                              eig_proxy_cells=2)),
            ("wave", lambda d: bench_wave.run(4, 4, n_slabs=3, device=d))):
        small = {}
        for where in ("cuda", "cpu"):
            info, xl = runner(where)
            small[where] = (info, xl[-1].cpu())
        (ig, xg), (ic, xc) = small["cuda"], small["cpu"]
        diff = float((xg - xc).norm() / xc.norm())
        exact = heat.exact_solution(coords4, 3 * 4 / 16.0)
        ex_err = float((xg - exact).norm() / exact.norm())
        print(f"# small {label} 4^3 ntao=4: V-cycles/slab gpu "
              f"{ig['iters']} cpu {ic['iters']}, TRUE rel gpu "
              f"{ig['true_rels']} cpu {ic['true_rels']}, "
              f"|x_gpu - x_cpu|/|x_cpu| {diff:.2e} (tol 1e-6), error vs "
              f"exact {ex_err:.2e} (tol 1e-3)", flush=True)
        if not (ig["converged"] and ic["converged"] and diff <= 1e-6
                and ex_err <= 1e-3
                and all(abs(a - b) <= 1
                        for a, b in zip(ig["iters"], ic["iters"]))):
            raise AssertionError(f"small-input {label} check failed")
    small = {}
    for where in ("cuda", "cpu"):
        info, xl = bench_stokes.run(4, 4, n_slabs=3, device=where)
        small[where] = (info, xl.cpu())
    (ig, xg), (ic, xc) = small["cuda"], small["cpu"]
    diff = float((xg - xc).norm() / xc.norm())
    print(f"# small stokes 4^3 ntao=4: V-cycles/slab gpu {ig['iters']} cpu "
          f"{ic['iters']}, TRUE rel gpu {ig['true_rels']} cpu "
          f"{ic['true_rels']}, |x_gpu - x_cpu|/|x_cpu| {diff:.2e} "
          f"(tol 1e-6)", flush=True)
    if not (ig["converged"] and ic["converged"] and diff <= 1e-6
            and all(r <= 1e-8 for r in ig["true_rels"] + ic["true_rels"])
            and all(abs(a - b) <= 1
                    for a, b in zip(ig["iters"], ic["iters"]))):
        raise AssertionError("small-input stokes check failed")
    with tempfile.TemporaryDirectory() as tmpd:
        with open(tp01.PRACTICAL_3D) as f:
            cfg = json.load(f)
        cfg.update(subdivisions="2,2,2", refinement=1, nTimestepsAtOnce=2,
                   endTime=0.25)
        small = {}
        for where in ("cuda", "cpu"):
            cfg["functionalFile"] = os.path.join(tmpd, f"f_{where}.txt")
            path = os.path.join(tmpd, f"{where}.json")
            with open(path, "w") as f:
                json.dump(cfg, f)
            p = Parameters.parse(path, 3)
            # run_single raises if a slab's FGMRES does not converge
            small[where] = tp01.run_single(p, p.fe_degree, p.refinement,
                                           device=where)
    rg, rc = small["cuda"], small["cpu"]
    diff = float((rg.solution.cpu() - rc.solution).norm()
                 / rc.solution.norm())
    print(f"# small tp01 practical 4^3 ntao=2: FGMRES iterations/slab gpu "
          f"{rg.slab_iterations} cpu {rc.slab_iterations}, both converged, "
          f"|x_gpu - x_cpu|/|x_cpu| {diff:.2e} (tol 1e-8)", flush=True)
    if not (diff <= 1e-8 and all(
            abs(a - b) <= 1 for a, b in zip(rg.slab_iterations,
                                            rc.slab_iterations))):
        raise AssertionError("small-input tp01 check failed")
    phase_done("small inputs")

    # 7-8. the main paths at the bench defaults, each with the launch
    #      counts set to 0 just before it and read just after
    wrappers = {"time_solve": time_solve, "kron_pair": kron_pair,
                "banded_apply": banded_apply, "chain_down": chain_down,
                "chain_up": chain_up, "quad_middle": quad_middle}
    path_kernels = {"heat": ("time_solve", "kron_pair", "banded_apply",
                             "chain_down", "chain_up"),
                    "wave": ("kron_pair", "banded_apply", "chain_down",
                             "chain_up"),
                    "stokes": ("kron_pair", "banded_apply"),
                    "coefficient": ("time_solve", "quad_middle")}
    launches, by_path = dict.fromkeys(wrappers, 0), {}
    # timed slabs: 2 for heat; 1 for wave and Stokes (2 until phase 19)
    for label, bench, args, n_slabs in (
            ("heat", bench_heat, (16, 32), 2),
            ("wave", bench_wave, (8, 16), MAIN_CUTS["wave"]),
            ("stokes", bench_stokes, (8, 8), MAIN_CUTS["stokes"])):
        for w in wrappers.values():
            w.launches = 0
        wall0, cpu0 = time.time(), time.process_time()
        info, _ = bench.run(*args, n_slabs=n_slabs, device="cuda",
                            profile=True)
        counts = {name: w.launches for name, w in wrappers.items()}
        wall, cpu = time.time() - wall0, time.process_time() - cpu0
        prof = info.pop("profile")
        print(json.dumps(info), flush=True)
        port = prof["port_kernels_ms"]
        print(f"# {label}: profile of one more slab (untimed): K4 "
              f"{port['grid_chain']}, K2 {port['kron_pair']}, K1 "
              f"{port['time_solve']}, K3 {port['banded_apply']} (launches, "
              f"device ms); device busy "
              f"{prof['device_busy_s']:.4f} s of {prof['wall_s']:.4f} s "
              f"wall (share {prof['device_busy_share']:.4f}), "
              f"{prof['n_kernel_launches']} launches, trace stop "
              f"{prof['exit_s']:.2f} s, summary {prof['summary_s']:.2f} s; "
              f"top ops (ms) {prof['top_ops_ms'][:6]}", flush=True)
        # the host-bound paths' speed varies between machines: the phase's
        # wall against this process's CPU time (all threads), and each
        # timed slab's wall against its dispatch thread's CPU time
        print(f"# {label} phase: wall {wall:.1f} s, this process's CPU "
              f"time {cpu:.1f} s, probe {info['probe_s']:.1f} s; timed "
              f"slabs {[round(t, 3) for t in info['slab_s']]} s wall, "
              f"{[round(t, 3) for t in info['slab_host_cpu_s']]} s of "
              f"dispatch-thread CPU", flush=True)
        print(json.dumps(bench.metric_line(info)), flush=True)
        if label == "stokes":
            stokes_iters = info["iters"]
        print(f"# {label} {args[0]}^3 ntao={args[1]}: V-cycles/slab "
              f"{info['iters']}, TRUE rel {info['true_rels']}, probe floor "
              f"{info['probe_floor']:.3e}, setup {info['setup_s']:.1f} s, "
              f"slab {info['slab_s']} s, {info['dofs_per_s']:.4e} "
              f"space-time DoF/s, launches {counts}", flush=True)
        if not (info["converged"]
                and all(r <= 1e-8 for r in info["true_rels"])):
            raise AssertionError(f"{label} slab solve did not reach TRUE "
                                 "<= 1e-8")
        missing = [n for n in path_kernels[label] if counts[n] == 0]
        if missing:
            raise AssertionError(f"{label}: kernels never ran: {missing}")
        for name, c in counts.items():
            launches[name] += c
        by_path[label] = counts
        phase_done(f"{label} main path")

    # 10. the coefficient main path: tp_01 practical mode at 16^3, 4 slabs
    counts = practical_phase(wrappers, dev, tp01.PRACTICAL_3D, "coefficient")
    missing = [n for n in path_kernels["coefficient"] if counts[n] == 0]
    if missing:
        raise AssertionError(f"coefficient: kernels never ran: {missing}")
    for name, c in counts.items():
        launches[name] += c
    by_path["coefficient"] = counts
    phase_done("coefficient main path")

    # 11. tp_01 convergence mode: the 2D golden cells, the two 3D sweeps,
    #     small 3D cells against the CPU
    relaxation_norms, lid = {}, {}
    counts = tp01_convergence(wrappers, dev, relaxation_norms)
    for name, c in counts.items():
        launches[name] += c
    by_path["tp01 convergence"] = counts
    phase_done("tp01 convergence")

    # 12. the tp_03stokes application: golden cells, the convergence
    #     sweep, the 256^2 lid-driven cavity, small cells against the CPU
    counts = tp03stokes_phase(wrappers, dev, lid)
    for name, c in counts.items():
        launches[name] += c
    by_path["tp03stokes"] = counts
    phase_done("tp03stokes")

    # 13. the DFG channel: the square at refinement 5 (4 slabs, profiled),
    #     the cylinder (2 slabs), small cells against the CPU
    strong = {}
    counts = dfg_phase(wrappers, dev, strong)
    for name, c in counts.items():
        launches[name] += c
    by_path["dfg"] = counts
    phase_done("dfg")

    # 14. the solver options: the Chebyshev smoother and the GMRES coarse
    #     solve on the tp_01 practical, tp_01 convergence and lid paths
    for label, counts in chebyshev_phase(wrappers, dev, relaxation_norms,
                                         lid).items():
        for name, c in counts.items():
            launches[name] += c
        by_path[label] = counts
    phase_done("chebyshev")

    # 15. the distorted-mesh heat path: (a) the heat stack on graded steps,
    #     (b) run_heat_cycle on the distorted 32^3 mesh (its launches are
    #     the path's), (c) 4^3 on the card against the CPU, (d) the Stokes
    #     path's repeatability
    stepped_checks(wrappers, dev, gen)
    counts = distorted_phase(wrappers, dev)
    missing = [n for n in ("time_solve",) if counts[n] == 0]
    if missing:
        raise AssertionError(f"distorted: kernels never ran: {missing}")
    for name, c in counts.items():
        launches[name] += c
    by_path["distorted"] = counts
    stokes_repeat_check(dev, gen, stokes_iters)
    phase_done("distorted")

    # 16. nonlinear and weak-obstacle Stokes: stfem_tpu's Navier cells,
    #     the 256^2 Navier path, the weak obstacle at refinement 5 against
    #     phase 13(a)'s strong one, small cells against the CPU
    for label, counts in navier_obstacle_phase(wrappers, dev,
                                               strong).items():
        for name, c in counts.items():
            launches[name] += c
        by_path[label] = counts
    phase_done("navier and weak obstacle")

    # 17. the continuous (FE_Q) pressure sweep 4^2..64^2 with small cells
    #     against the CPU and stfem_tpu, then strong inhomogeneous
    #     Dirichlet heat 4^3..32^3
    by_path["feq"] = feq_phase(wrappers, dev, slabs_max=FEQ_CUTS)
    by_path["dirichlet heat"] = dirichlet_heat_phase(
        wrappers, dev, slabs_max=DIRICHLET_CUTS)
    for label in ("feq", "dirichlet heat"):
        for name, c in by_path[label].items():
            launches[name] += c
    phase_done("feq and dirichlet heat")

    # 18. bench.py's switches on the heat bench, the combined bench, the
    #     estimate cache, a one-rank NCCL group
    by_path["switches"] = switches_phase(wrappers, dev)
    for name, c in by_path["switches"].items():
        launches[name] += c
    phase_done("switches")

    # 19. the sharded whole solve on 8 gloo processes sharing the card
    #     (launches counted in the ranks, summed here), then on a one-rank
    #     NCCL group
    by_path["sharded"] = sharded_phase(smi, dev, gen)
    for name, c in by_path["sharded"].items():
        launches[name] += c
    phase_done("sharded")

    sources = {"time_solve": ("stfem_tpu_torch/csrc/time_solve.cu",
                              "stfem_tpu/ops/pallas_timesolve.py:82"),
               "kron_pair": ("stfem_tpu_torch/csrc/kron_pair.cu",
                             "stfem_tpu/ops/pallas_ffresid.py:120"),
               "banded_apply": ("stfem_tpu_torch/csrc/banded_apply.cu",
                                "stfem_tpu/ops/pallas_ffband.py:92"),
               "grid_chain": ("stfem_tpu_torch/csrc/grid_chain.cu",
                              "stfem_tpu/ops/pallas_grid.py:158"),
               "quad_middle": ("stfem_tpu_torch/csrc/quad_middle.cu",
                               "stfem_tpu/ops/pallas_kernels.py:86")}
    for counts in [launches] + list(by_path.values()):
        counts["grid_chain"] = counts["chain_down"] + counts["chain_up"]
    kernels = []
    for name, (src, rep) in sources.items():
        err, ms, plain, lib, bound_ms, bound_by = report[name]
        kernels.append({"name": name, "route": "cuda", "source": src,
                        "replaces": rep, "launches": launches[name],
                        "launches_by_path": {path: counts[name] for path,
                                             counts in by_path.items()},
                        "max_abs_err": err, "ms": ms, "plain_ms": plain,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": lib, **extras.get(name, {})})
    print(f"# smoke total wall {time.time() - t_start:.1f} s", flush=True)
    print(smi, flush=True)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

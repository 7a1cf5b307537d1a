"""Heat slab-solve throughput bench: the port of bench.py main()'s heat
section, with its STFEM_BENCH_* switches.

3D heat, Q4 in space x dG(2) in time, `cells`^3 cells (default 16: 274,625
space DoFs), `ntao` time steps per slab (default 32: 96 time blocks, 26.4 M
space-time DoFs per slab).  At the defaults every slab is solved to a TRUE
relative residual <= 1e-8 by
  1. a float32 preconditioned-Richardson first solve with the bf16 STMG
     V-cycle, stopped just above the float32 floor (rtol1);
  2. one iterative-refinement pass: the FP64 slab residual (kernels K2
     and K3), a float32 Richardson correction solve of the unit-scaled
     residual to ir_rtol, and the FP64 update;
  3. an untimed FP64 TRUE-residual check, which gates `converged`.
The floor and both tolerances come from a probe solve of slab 0 (run to
stall): rtol1 = 1.4 floor, ir_rtol = 0.5e-8 / floor (bench.py:16-21).  If
the probe shows the V-cycle is not contractive under Richardson (floor >
1e-3) the outer solver falls back to FGMRES.

The switches (SWITCHES; README.md has the table): the V-cycle's
GMGParams fields, the outer solver (richardson, fgmres with its
Gram-Schmidt, basis dtype and flexible/right preconditioning, or
chebyshev on the interval [1 - 1.05 rho, 1 + 1.05 rho] from the power
estimate rho of the error propagator I - P A), the IR passes (or `ir_rich`
fixed V-cycle Richardson corrections), and the first solve's initial
guess (the last value, or `x0_steps` steps of the previous slab's last
step extrapolated by its Lagrange polynomial, bench.py:1221-1240).  With
ir off the run is bench.py's float32-only mode: FGMRES to a Givens
estimate of 1e-8, `converged` from the solver; the FP64 residuals are
still reported.

Prints one info JSON line and, last, the metric JSON line (same name and
unit as bench.py's heat metric; the number is this device's own).

    python -m stfem_tpu_torch.bench_heat [--cells 16] [--ntao 32]
        [--slabs 10] [--device cuda] [--profile] [switches]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .integrators import ForceAssembler
from .krylov import (chebyshev_solve, estimate_error_propagator_radius,
                     fgmres, richardson_solve)
from .mesh.grid import StructuredMesh
from .ops.kronfac import KronAssembled
from .ops.slab_residual import SlabResidual64
from .ops.spatial import LaplaceMassOperator
from .problems import heat as heat_problem
from .stmg.gmg import bench_params, build_stmg
from .stmg.smoother import initial_guess
from .system import SystemMatrix
from .time.quadrature import LagrangeBasis
from .time.tables import get_fe_time_weights, get_time_quad
from .types import SupportedSmoothers, TimeStepType
from .utils.switches import Switch, add_switches, reorth_value, switch_kwargs

METRIC = "stmg_slab_solve_throughput_3d_heat_q4_dg2"
UNIT = "space-time DoF/s/chip (rel 1e-8 slab solves)"
FE_DEGREE, SPACE_DEGREE, TAU = 2, 4, 1.0 / 16.0
RICHARDSON_MAXITER = 40

_B = "STFEM_BENCH_"
SWITCHES = (
    Switch("cells", _B + "CELLS", "cells", int, 16, "cells per axis"),
    Switch("ntao", _B + "NTAO", "ntao", int, 32, "time steps per slab"),
    Switch("slabs", _B + "SLABS", "n_slabs", int, 10, "timed slabs"),
    Switch("steps", _B + "STEPS", "steps", int, 1,
           "MG smoothing steps (smoothing_steps)"),
    Switch("inner", _B + "INNER", "inner", int, 2,
           "sweeps per smoother application (smoother_inner_iterations)"),
    Switch("skipid", _B + "SKIPID", "skipid", "bool", True,
           "skip the Identity levels (skip_identity_levels)"),
    Switch("coarse", _B + "COARSE", "coarse", str, "Direct",
           "Direct, GMRES or Smoother (coarse_grid_smoother_type)"),
    Switch("smoother", _B + "SMOOTHER", "smoother", str, "Relaxation",
           "Relaxation or Chebyshev (smoother)"),
    Switch("range", _B + "RANGE", "smoothing_range", float, 1.0,
           "smoothing range (smoothing_range)"),
    Switch("variable", _B + "VARIABLE", "variable", "bool", False,
           "2^(L-l) smoothing steps on level l (variable)"),
    Switch("vcap", _B + "VCAP", "vcap", int, 0,
           "cap on the variable factor, 0 none (variable_steps_cap)"),
    Switch("post-inner", _B + "POST_INNER", "post_inner", int, None,
           "post-smoother sweeps (post_smoother_inner_iterations)"),
    Switch("nopost", _B + "NOPOST", "nopost", "bool", False,
           "no post-smoothing (no_post_smooth)"),
    Switch("nopost-fine", _B + "NOPOST_FINE", "nopost_fine", "bool", False,
           "no post-smoothing on the finest level (no_post_smooth_finest)"),
    Switch("smoothall", _B + "SMOOTHALL", "smoothall", "bool", False,
           "a smoother on every level (smooth_all_levels)"),
    Switch("bf16", _B + "BF16", "bf16", "bool", True,
           "bf16 Vanka matrices (vanka_bf16)"),
    Switch("level-bf16", _B + "LEVEL_BF16", "level_bf16", "bool", True,
           "bf16 V-cycle levels (level_bf16)"),
    Switch("eig-proxy", _B + "EIG_PROXY", "eig_proxy_cells", int, 4,
           "proxy cells of the estimates, 0 none (eig_proxy_cells)"),
    Switch("maxiter", _B + "MAXITER", "maxiter", int, None,
           "outer iterations: Richardson/Chebyshev 40, FGMRES basis 18 "
           "(<= 8 cells) or 24"),
    Switch("reorth", _B + "REORTH", "reorth", reorth_value, None,
           "FGMRES Gram-Schmidt: 1, 0 or selective (0 with ir, else 1)"),
    Switch("vbf16", _B + "VBF16", "vbf16", "bool", False,
           "FGMRES basis V in bf16"),
    Switch("flex", _B + "FLEX", "flex", "bool", True,
           "flexible GMRES (off: right-preconditioned)"),
    Switch("rtol1", _B + "RTOL1", "rtol1", float, None,
           "first-solve tolerance (derived from the probe with ir, else "
           "1e-8)"),
    Switch("omega", _B + "OMEGA", "omega", float, 1.0, "Richardson damping"),
    Switch("outer", _B + "OUTER", "outer", str, None,
           "richardson, fgmres or chebyshev (richardson with ir, else "
           "fgmres)"),
    Switch("ir", _B + "IR", "ir", "bool", True,
           "FP64 iterative refinement to TRUE 1e-8 (off: float32 only)"),
    Switch("ir-rtol", _B + "IR_RTOL", "ir_rtol", float, None,
           "correction-solve tolerance (derived from the probe)"),
    Switch("ir-passes", _B + "IR_PASSES", "ir_passes", int, 1, "IR passes"),
    Switch("ir-rich", _B + "IR_RICH", "ir_rich", int, 0,
           "k > 0: k fixed V-cycle Richardson steps as the correction"),
    Switch("x0", _B + "X0", "x0", str, "const",
           "first-solve guess: const or extrap"),
    Switch("x0-steps", _B + "X0_STEPS", "x0_steps", int, 1,
           "steps of the new slab extrapolated (x0 extrap)"))


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def extrapolation_matrix(tq, n_blocks: int, steps: int) -> np.ndarray:
    """(n_blocks, nt): row s nt + j evaluates the previous slab's last
    step, a Lagrange polynomial on the Radau points tq - 1, at s + tq[j]
    for s < steps, and repeats its last value beyond (bench.py:1221-1240)."""
    nt = len(tq)
    basis = LagrangeBasis(np.asarray(tq, np.float64) - 1.0)
    E = np.zeros((n_blocks, nt))
    for row in range(n_blocks):
        s, j = divmod(row, nt)
        if s < steps:
            E[row] = basis.eval_matrix(np.asarray([s + float(tq[j])]))[0]
        else:
            E[row, -1] = 1.0
    return E


def _vanka_dtypes(smoother) -> dict | None:
    """The dtypes of a level's Vanka apply: its vectors and the matrices
    that K4 (grid mode) or the cell bmm reads."""
    vanka = getattr(smoother, "precond", None)
    if vanka is None:
        return None
    mats = vanka.Wdn[0] if vanka.mode == "grid" else vanka.V
    return {"mode": vanka.mode, "vectors": str(vanka.dtype)[6:],
            "matrices": str(mats.dtype)[6:]}


def run(cells: int = 16, ntao: int = 32, n_slabs: int = 10,
        device="cuda", eig_proxy_cells: int = 4, profile: bool = False, *,
        steps: int = 1, inner: int = 2, skipid: bool = True,
        coarse: str = "Direct", smoother: str = "Relaxation",
        smoothing_range: float = 1.0, variable: bool = False,
        vcap: int = 0, post_inner: int | None = None, nopost: bool = False,
        nopost_fine: bool = False, smoothall: bool = False,
        bf16: bool = True, level_bf16: bool = True,
        maxiter: int | None = None, reorth=None, vbf16: bool = False,
        flex: bool = True, rtol1: float | None = None, omega: float = 1.0,
        outer: str | None = None, ir: bool = True,
        ir_rtol: float | None = None, ir_passes: int = 1, ir_rich: int = 0,
        x0: str = "const", x0_steps: int = 1):
    """Set up, probe and march n_slabs slabs.  Returns (info dict with
    the metric value under "dofs_per_s", last slab's FP64 solution).
    profile=True solves the last slab once more, untimed, under
    torch.profiler and adds its summary as info["profile"].  The keyword
    arguments are bench.py's switches (SWITCHES), with its defaults."""
    device = torch.device(device)
    f32, f64 = torch.float32, torch.float64
    if outer is None:
        outer = "richardson" if ir else "fgmres"
    if outer not in ("richardson", "fgmres", "chebyshev"):
        raise ValueError(f"outer: richardson, fgmres or chebyshev, not "
                         f"{outer!r}")
    if x0 not in ("const", "extrap"):
        raise ValueError(f"x0: const or extrap, not {x0!r}")
    reorth = (not ir) if reorth is None else reorth
    glue_maxiter = maxiter or RICHARDSON_MAXITER
    fgmres_maxiter = maxiter or (18 if cells <= 8 else 24)
    basis_dtype = torch.bfloat16 if vbf16 else None
    refinement = int(np.log2(cells // 2))
    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3,
                          refinement=refinement)
    assert mesh.cells[0] == cells, "cells must be 2^r with r >= 1"
    rhs_fn = lambda p, t: heat_problem.rhs(p, t, 1.0)
    params = bench_params(
        smoothing_steps=steps, smoother_inner_iterations=inner,
        skip_identity_levels=skipid, coarse_grid_smoother_type=coarse,
        smoother=SupportedSmoothers[smoother],
        smoothing_range=smoothing_range, variable=variable,
        variable_steps_cap=vcap, post_smoother_inner_iterations=post_inner,
        no_post_smooth=nopost, no_post_smooth_finest=nopost_fine,
        smooth_all_levels=smoothall, vanka_bf16=bf16, level_bf16=level_bf16,
        eig_proxy_cells=eig_proxy_cells)

    _sync(device)
    t_setup = time.time()
    ops = {dt: (LaplaceMassOperator(mesh, SPACE_DEGREE, SPACE_DEGREE + 1,
                                    0.0, 1.0, dtype=dt, device=device),
                LaplaceMassOperator(mesh, SPACE_DEGREE, SPACE_DEGREE + 1,
                                    1.0, 0.0, dtype=dt, device=device))
           for dt in (f32, f64)}
    K, M = ops[f32]
    Alpha, Beta, Gamma, _ = get_fe_time_weights(TimeStepType.DG, FE_DEGREE,
                                                TAU, ntao)
    matrix = SystemMatrix(K, M, Alpha, Beta)
    rhs_matrix = SystemMatrix(K, M, np.zeros_like(Gamma), Gamma)
    gmg = build_stmg(mesh, FE_DEGREE, SPACE_DEGREE, TimeStepType.DG, ntao,
                     TAU, params, dtype=f32, device=device)
    _sync(device)
    hierarchy_s = time.time() - t_setup
    print(f"# setup/hierarchy {hierarchy_s:.1f}s", flush=True)
    force = ForceAssembler(mesh, SPACE_DEGREE, SPACE_DEGREE + 1, rhs_fn,
                           K.mask_np, dtype=f32, device=device)
    resid = SlabResidual64(KronAssembled(*ops[f64], f64), K.mask_np, Alpha,
                           Beta, Gamma)
    force64 = ForceAssembler(mesh, SPACE_DEGREE, SPACE_DEGREE + 1, rhs_fn,
                             K.mask_np, dtype=f64, device=device)
    _sync(device)
    setup_s = time.time() - t_setup
    print(f"# setup {setup_s:.1f}s", flush=True)

    n_blocks = Alpha.shape[0]
    shape = (n_blocks,) + mesh.dof_shape(SPACE_DEGREE)
    tq = get_time_quad(TimeStepType.DG, FE_DEGREE)[0]
    nt = len(tq)
    t_rows = [TAU * (row // nt) + TAU * float(tq[row % nt])
              for row in range(n_blocks)]
    scales = [Alpha[row, row] for row in range(n_blocks)]
    t_off = torch.as_tensor(np.array(t_rows, np.float32), device=device)
    f_sc = torch.as_tensor(np.array(scales, np.float32), device=device)
    # FP64 force slabs, assembled once before the timed march
    f64slabs = [force64.batched(torch.as_tensor(
        i * TAU * ntao + np.array(t_rows), dtype=f64, device=device),
        f_sc.to(f64)) for i in range(n_slabs)]
    E_x0 = (torch.as_tensor(extrapolation_matrix(tq, n_blocks, x0_steps),
                            dtype=f32, device=device)
            if x0 == "extrap" else None)

    cheb = rho = None
    if outer == "chebyshev":
        # spec(P A) in [1 - 1.05 rho, 1 + 1.05 rho] (bench.py:1440-1460)
        v0 = initial_guess(shape, K.mask_np, f32, device)
        rho = estimate_error_propagator_radius(matrix.vmult, gmg.vmult, v0)
        print(f"# rho(I - PA) = {rho:.4f}", flush=True)
        if not 0.0 < rho < 1.0:
            raise RuntimeError(f"V-cycle not contractive (rho = {rho}); the "
                               "chebyshev outer solve is invalid")
        cheb = (1.0 - 1.05 * rho, 1.0 + 1.05 * rho)

    def outer_solve(kind, b, x_0, reltol):
        if kind == "richardson":
            return richardson_solve(matrix.vmult, b, x_0, gmg.vmult,
                                    maxiter=glue_maxiter, reltol=reltol,
                                    omega=omega)
        if kind == "chebyshev":
            return chebyshev_solve(matrix.vmult, b, x_0, gmg.vmult, *cheb,
                                   maxiter=glue_maxiter, reltol=reltol)
        return fgmres(matrix.vmult, b, x_0, gmg.vmult,
                      maxiter=fgmres_maxiter, reltol=reltol, abstol=1e-30,
                      reorthogonalize=reorth, basis_dtype=basis_dtype,
                      flexible=flex)

    def first_solve(kind, prev32, t, reltol, prev_step=None):
        rhs = (rhs_matrix.vmult(prev32[None])
               + force.batched(float(t) + t_off, f_sc))
        guess = (torch.einsum("rj,j...->r...", E_x0, prev_step)
                 if E_x0 is not None and prev_step is not None
                 else prev32.expand(shape))
        return outer_solve(kind, rhs, guess, reltol)

    coords = torch.as_tensor(mesh.dof_coordinates(SPACE_DEGREE), dtype=f32,
                             device=device)
    prev32_0 = heat_problem.exact_solution(coords, 0.0, 1.0).to(f32)
    prev64_0 = prev32_0.to(f64)

    # probe slab 0 (IR only): run the first solve to its stall; its TRUE
    # FP64 residual is the float32 floor the tolerances derive from
    t_probe = time.time()
    probe_floor = None
    if ir:
        for kind in (outer, "fgmres") if outer == "richardson" else (outer,):
            outer = kind
            xp = first_solve(kind, prev32_0, np.float32(0.0), 1e-8).x
            _, rn, bn = resid.residual(prev64_0, xp.to(f64), f64slabs[0])
            probe_floor = float(rn) / float(bn)
            if probe_floor <= 1e-3:
                break
            if kind == "richardson":
                print(f"# Richardson probe stalled at rel "
                      f"{probe_floor:.2e}; falling back to FGMRES",
                      flush=True)
        if rtol1 is None:
            rtol1 = max(1.4 * probe_floor, 1e-8)
        if ir_rtol is None:
            ir_rtol = min(max(0.5e-8 / max(probe_floor, 1e-12), 1e-7), 2e-3)
    elif rtol1 is None:
        rtol1 = 1e-8
    _sync(device)
    probe_s = time.time() - t_probe
    if ir:
        print(f"# probe: floor {probe_floor:.3e} -> rtol1 {rtol1:.3e}, "
              f"ir_rtol {ir_rtol:.3e}  ({probe_s:.1f}s)", flush=True)

    def correction(r32):
        """The correction of one IR pass -> (c, V-cycles)."""
        if ir_rich > 0:
            c = gmg.vmult(r32)
            for _ in range(ir_rich - 1):
                c = c + gmg.vmult(r32 - matrix.vmult(c))
            return c, ir_rich
        res = outer_solve(outer, r32, torch.zeros(shape, dtype=f32,
                                                  device=device), ir_rtol)
        return res.x, res.iterations

    def solve_slab(i, prev32, prev64, t, prev_step):
        """First solve + the IR passes of slab i -> (x64, V-cycles, the
        first solve's result)."""
        res = first_solve(outer, prev32, t, rtol1, prev_step)
        x64, its = res.x.to(f64), res.iterations
        for _ in range(ir_passes if ir else 0):
            r, rn, _ = resid.residual(prev64, x64, f64slabs[i])
            c, extra = correction((r / rn).to(f32))
            x64 = x64 + rn * c.to(f64)
            its += extra
        return x64, its, res

    prev32, prev64, t, prev_step = prev32_0, prev64_0, np.float32(0.0), None
    iters, first_iters, rels, times, conv, cpu = [], [], [], [], True, []
    for i in range(n_slabs):
        _sync(device)
        t0, c0 = time.time(), time.thread_time()
        x64, its, first = solve_slab(i, prev32, prev64, t, prev_step)
        _sync(device)
        times.append(time.time() - t0)
        cpu.append(time.thread_time() - c0)
        # untimed TRUE residual check (gates `converged` with ir)
        _, rn2, bn2 = resid.residual(prev64, x64, f64slabs[i])
        rels.append(float(rn2) / float(bn2))
        iters.append(its)
        first_iters.append(first.iterations)
        conv = conv and first.converged
        last_inputs = (i, prev32, prev64, t, prev_step)
        if ir:
            prev64 = x64[-1].contiguous()
            prev32 = prev64.to(f32)
        else:           # bench.py's float32 march carries float32
            prev32 = x64[-1].to(f32).contiguous()
            prev64 = prev32.to(f64)
        if E_x0 is not None:
            prev_step = x64[-nt:].to(f32)
        t = np.float32(t + TAU * ntao)
    prof = (profile_slab(lambda: solve_slab(*last_inputs), device)
            if profile else None)

    solve_s = float(np.sum(times))
    dofs_per_s = int(np.prod(shape)) * n_slabs / max(solve_s, 1e-9)
    info = dict(
        device=(torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu"),
        cells=mesh.n_cells, space_dofs=mesh.n_dofs(SPACE_DEGREE),
        n_blocks=n_blocks, slabs=n_slabs, outer=outer, ir=ir,
        avg_iters=float(np.mean(iters)), iters=iters,
        first_iters=first_iters, true_rel_residual=max(rels),
        true_rels=rels,
        converged=bool(conv and (not ir or all(r <= 1e-8 for r in rels))),
        setup_s=setup_s, hierarchy_s=hierarchy_s,
        estimates=dict(gmg.estimates), probe_s=probe_s, solve_s=solve_s,
        slab_s=times, slab_host_cpu_s=cpu, probe_floor=probe_floor,
        rtol1=rtol1, ir_rtol=ir_rtol, rho=rho, dofs_per_s=dofs_per_s,
        fine_vanka=_vanka_dtypes(gmg.levels[-1].smoother))
    if prof is not None:
        info["profile"] = prof
    return info, x64


# name fragments of the port's own kernels (csrc/*.cu), K1-K5
PORT_KERNELS = {"time_solve": ("time_solve",), "kron_pair": ("kron_pair",),
                "banded_apply": ("banded_",),
                "grid_chain": ("grid_chain_",),
                "quad_middle": ("quad_middle",)}


def profile_slab(fn, device, top: int = 12) -> dict:
    """Run fn() once under torch.profiler: wall time, summed device time
    (one stream, so kernels do not overlap), the kernels with the most
    device time, the torch ops whose kernels take the most, and each of
    the port's kernels' launches and device ms (`port_kernels_ms`).

    The summary reads the trace's raw events and joins each kernel to the
    op that launched it by correlation id.  torch's key_averages() builds
    an event tree first, which takes minutes for a slab of ~180k launches.
    exit_s times the trace's stop, summary_s this summary."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    _sync(device)
    with profile(activities=acts) as prof:
        t0 = time.time()
        fn()
        _sync(device)
        wall = time.time() - t0
    exit_s = time.time() - t0 - wall
    t1 = time.time()
    op_of, ops, kernels = {}, {}, {}
    device_events = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            device_events.append(e)
        elif e.linked_correlation_id() == 0:     # a torch op
            op_of[e.correlation_id()] = e.name()
            ops.setdefault(e.name(), [0, 0.0])[0] += 1
    busy_us = 0.0
    for e in device_events:
        us = e.duration_ns() * 1e-3
        busy_us += us
        k = kernels.setdefault(e.name(), [0, 0.0])
        k[0] += 1
        k[1] += us
        op = op_of.get(e.linked_correlation_id())
        if op is not None:
            ops[op][1] += us

    def rows(table):
        ranked = sorted(table.items(), key=lambda kv: (kv[1][1], kv[1][0]),
                        reverse=True)[:top]
        return [[name[:70], n, us * 1e-3] for name, (n, us) in ranked]

    port = {name: [sum(n for k, (n, _) in kernels.items()
                       if any(f in k for f in frags)),
                   sum(us for k, (_, us) in kernels.items()
                       if any(f in k for f in frags)) * 1e-3]
            for name, frags in PORT_KERNELS.items()}
    busy = busy_us * 1e-6
    return {"wall_s": wall, "device_busy_s": busy,
            "port_kernels_ms": port,
            "device_busy_share": busy / wall if wall > 0 else 0.0,
            "n_kernel_launches": len(device_events),
            "top_kernels_ms": rows(kernels), "top_ops_ms": rows(ops),
            "exit_s": exit_s, "summary_s": time.time() - t1}


def metric_line(info: dict) -> dict:
    return {"metric": METRIC, "value": info["dofs_per_s"], "unit": UNIT,
            "vs_baseline": info["dofs_per_s"] / 1.0e9,
            "device": info["device"]}


def main(argv=None, environ=None):
    """The command line; each switch's default reads its STFEM_BENCH_*
    variable from environ (os.environ)."""
    environ = os.environ if environ is None else environ
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_switches(ap, SWITCHES, environ)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra, untimed slab solve")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("bench_heat: no CUDA device (the bench measures "
                         "the GPU; pass --device cpu for a functional run)")
    info, _ = run(device=args.device, profile=args.profile,
                  **switch_kwargs(args, SWITCHES))
    print(json.dumps(info), flush=True)
    print(json.dumps(metric_line(info)), flush=True)


if __name__ == "__main__":
    main()

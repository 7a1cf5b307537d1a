"""Acoustic-wave slab-solve throughput bench: the port of bench.py's
run_wave_bench, with its STFEM_BENCH_WAVE_* switches (SWITCHES: the
level and Vanka bf16, the smoothing range, the sweeps per smoother
application, the Richardson iterations, the converged Arnoldi estimates
and the proxy estimates).

3D acoustic wave on the Schur-reduced second-order formulation (the
velocity eliminated, reference include/time_integrators.h:400-447), Q4 in
space x dG(2) in time, `cells`^3 cells (default 8: 35,937 space DoFs),
`ntao` time steps per slab (default 16: 48 time blocks, 1.72 M space-time
DoFs per slab).  Every slab is solved to a TRUE relative residual <= 1e-8
by
  1. a float32 preconditioned-Richardson first solve with the bf16 STMG
     V-cycle (wave hierarchy: dense per-position time solve in the Vanka,
     power-method eigen estimates on every full level), stopped just above
     the float32 floor (rtol1);
  2. iterative-refinement passes: the FP64 slab residual (kernel K2, with
     the wave's full step coupling and previous-u/v rhs tables), a float32
     Richardson correction solve of the unit-scaled residual to ir_rtol,
     and the FP64 update -- one pass, or two when the floor is above 1e-3;
  3. the velocity recovery: every step's v in float32 (dense) and the last
     step's v in FP64, which feeds the next slab's rhs.  It is inside the
     timed window, as in bench.py;
  4. an untimed FP64 TRUE-residual check, which gates `converged`.
The floor and both tolerances come from a probe solve of slab 0:
rtol1 = max(1.4 floor, 1e-8), ir_rtol = clip(0.5e-8 / floor, 1e-7, 2e-3).
The probe's recovered v is checked against a dense FP64 oracle (< 1e-9).

Prints one info JSON line and, last, the metric JSON line (same name and
unit as bench.py's wave metric; the number is this device's own).

    python -m stfem_tpu_torch.bench_wave [--cells 8] [--ntao 16]
        [--slabs 6] [--device cuda] [--profile] [switches]
"""
from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from .bench_heat import _sync, profile_slab
from .integrators import ForceAssembler, WaveVelocityRecovery
from .krylov import richardson_solve
from .mesh.grid import StructuredMesh
from .ops.kronfac import KronAssembled
from .ops.slab_residual import SlabResidual64
from .ops.spatial import LaplaceMassOperator
from .problems import heat as problem
from .stmg.gmg import bench_params, build_stmg
from .system import SystemMatrix
from .time.tables import (get_fe_time_weights, get_fe_time_weights_wave,
                          get_time_quad)
from .types import ProblemType, TimeStepType
from .utils.switches import Switch, add_switches, switch_kwargs

METRIC = "stmg_wave_slab_solve_throughput_3d_q4_dg2"
UNIT = ("space-time DoF/s/chip (rel 1e-8 slab solves incl. "
        "v-recovery)")
FE_DEGREE, SPACE_DEGREE, TAU, FREQ = 2, 4, 1.0 / 16.0, 1.0
MAXITER = 40

_B = "STFEM_BENCH_WAVE_"
SWITCHES = (
    Switch("cells", _B + "CELLS", "cells", int, 8, "cells per axis"),
    Switch("ntao", _B + "NTAO", "ntao", int, 16, "time steps per slab"),
    Switch("slabs", _B + "SLABS", "n_slabs", int, 6, "timed slabs"),
    Switch("bf16", _B + "BF16", "bf16", "bool", True,
           "bf16 levels and Vanka matrices (level_bf16, vanka_bf16)"),
    Switch("range", _B + "RANGE", "smoothing_range", float, 1.0,
           "smoothing range (smoothing_range)"),
    Switch("inner", _B + "INNER", "inner", int, 2,
           "sweeps per smoother application (smoother_inner_iterations)"),
    Switch("maxiter", _B + "MAXITER", "maxiter", int, MAXITER,
           "Richardson iterations per solve"),
    Switch("eig-exact", _B + "EIG_EXACT", "eig_exact", "bool", False,
           "converged Arnoldi estimates (eig_exact)"),
    Switch("eig-proxy", _B + "EIG_PROXY", "eig_proxy_cells", int, 0,
           "proxy cells of the estimates, 0 none (eig_proxy_cells)"))


def run(cells: int = 8, ntao: int = 16, n_slabs: int = 6, device="cuda",
        profile: bool = False, *, bf16: bool = True,
        smoothing_range: float = 1.0, inner: int = 2, maxiter: int = MAXITER,
        eig_exact: bool = False, eig_proxy_cells: int = 0):
    """Set up, probe and march n_slabs slabs.  Returns (info dict with
    the metric value under "dofs_per_s", last slab's FP64 u).
    profile=True solves the last slab once more, untimed, under
    torch.profiler and adds its summary as info["profile"].  The keyword
    arguments are bench.py's wave switches (SWITCHES), with its
    defaults."""
    device = torch.device(device)
    f32, f64 = torch.float32, torch.float64
    refinement = int(np.log2(cells // 2))
    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3,
                          refinement=refinement)
    assert mesh.cells[0] == cells, "cells must be 2^r with r >= 1"
    dg = TimeStepType.DG

    _sync(device)
    t_setup = time.time()
    ops = {dt: (LaplaceMassOperator(mesh, SPACE_DEGREE, SPACE_DEGREE + 1,
                                    0.0, 1.0, dtype=dt, device=device),
                LaplaceMassOperator(mesh, SPACE_DEGREE, SPACE_DEGREE + 1,
                                    1.0, 0.0, dtype=dt, device=device))
           for dt in (f32, f64)}
    K, M = ops[f32]
    A1, B1, G1, Z1 = get_fe_time_weights(dg, FE_DEGREE, TAU, 1)
    A_lhs, B_lhs, rhs_uK, rhs_uM, rhs_vM = get_fe_time_weights_wave(
        dg, A1, B1, G1, Z1, ntao)
    matrix = SystemMatrix(K, M, A_lhs, B_lhs)
    r_u = SystemMatrix(K, M, rhs_uK, rhs_uM)
    r_v = SystemMatrix(K, M, np.zeros_like(rhs_vM), rhs_vM)
    gmg = build_stmg(mesh, FE_DEGREE, SPACE_DEGREE, dg, ntao, TAU,
                     bench_params(ProblemType.wave, level_bf16=bf16,
                                  vanka_bf16=bf16,
                                  smoothing_range=smoothing_range,
                                  smoother_inner_iterations=inner,
                                  eig_exact=eig_exact,
                                  eig_proxy_cells=eig_proxy_cells),
                     dtype=f32, device=device, problem=ProblemType.wave)
    _sync(device)
    hierarchy_s = time.time() - t_setup
    print(f"# setup/hierarchy {hierarchy_s:.1f}s", flush=True)
    resid = SlabResidual64(KronAssembled(*ops[f64], f64), K.mask_np, A_lhs,
                           B_lhs, rhs_uM, Gamma_K=rhs_uK, Gamma_v=rhs_vM)
    recovery = WaveVelocityRecovery(A1, B1, G1, ntao, device)
    force64 = ForceAssembler(mesh, SPACE_DEGREE, SPACE_DEGREE + 1,
                             lambda p, t: problem.wave_rhs(p, t, FREQ),
                             K.mask_np, dtype=f64, device=device)
    n_blocks = A_lhs.shape[0]
    nt = A1.shape[0]
    shape = (n_blocks,) + mesh.dof_shape(SPACE_DEGREE)
    tq = get_time_quad(dg, FE_DEGREE)[0]
    t_offsets = np.array([TAU * it + TAU * float(q)
                          for it in range(ntao) for q in tq])
    f_scales = torch.as_tensor([float(A1[j, j]) for _ in range(ntao)
                                for j in range(nt)], dtype=f64,
                               device=device)
    # FP64 force slabs at the Radau points, assembled once before the march
    f64slabs = [force64.batched(torch.as_tensor(
        i * TAU * ntao + t_offsets, dtype=f64, device=device), f_scales)
        for i in range(n_slabs)]
    coords = torch.as_tensor(mesh.dof_coordinates(SPACE_DEGREE), dtype=f64,
                             device=device)
    # stfem_tpu has no wave u: u0 is the heat exact solution at t = 0
    u0 = problem.exact_solution(coords, 0.0, FREQ)
    v0 = problem.wave_exact_v(coords, 0.0, FREQ)
    _sync(device)
    setup_s = time.time() - t_setup
    print(f"# setup {setup_s:.1f}s", flush=True)

    def solve(b, x0, reltol):
        return richardson_solve(matrix.vmult, b, x0, gmg.vmult,
                                maxiter=maxiter, reltol=reltol)

    def solve_slab(i, pu64, pv64, rtol1, ir_rtol, n_corr):
        """First solve + n_corr IR passes + v-recovery of slab i ->
        (u64, v all steps f32, v last f64, V-cycles, last ||r||/||rhs||
        seen by an IR pass)."""
        pu32 = pu64.to(f32)
        rhs = (r_u.vmult(pu32[None]) + r_v.vmult(pv64.to(f32)[None])
               + f64slabs[i].to(f32))
        res = solve(rhs, pu32.expand(shape), rtol1)
        x64, its, rel = res.x.to(f64), res.iterations, None
        for _ in range(n_corr):
            r, rn, bn = resid.residual(pu64, x64, f64slabs[i], pv64)
            rel = float(rn) / float(bn)
            corr = solve((r / rn).to(f32), torch.zeros(shape, dtype=f32,
                                                       device=device),
                         ir_rtol)
            x64 = x64 + rn * corr.x.to(f64)
            its += corr.iterations
        v = recovery.all_steps(x64, pu32)
        v_last = recovery.last(x64, pu64)
        return x64, v, v_last, its, rel

    # probe slab 0: first solve to its stall, then an IR pass that stops at
    # once (ir_rtol 2); the first solve's TRUE FP64 residual is the floor
    t_probe = time.time()
    xp, _, vp, _, floor = solve_slab(0, u0, v0, 1e-8, 2.0, 1)
    if not np.isfinite(floor):
        raise RuntimeError("wave probe: non-finite floor (the V-cycle "
                           "diverged)")
    rtol1 = max(1.4 * floor, 1e-8)
    ir_rtol = min(max(0.5e-8 / max(floor, 1e-12), 1e-7), 2e-3)
    n_corr = 2 if floor > 1e-3 else 1
    v_rel = oracle_v_error(A1, B1, G1, xp, u0, vp)
    _sync(device)
    probe_s = time.time() - t_probe
    print(f"# wave probe: floor {floor:.3e} -> rtol1 {rtol1:.3e}, "
          f"ir_rtol {ir_rtol:.3e}, {n_corr} IR pass(es)  ({probe_s:.1f}s)",
          flush=True)
    print(f"# wave v-recovery vs dense f64 oracle: rel {v_rel:.2e}",
          flush=True)
    if not v_rel < 1e-9:
        raise AssertionError(f"wave v-recovery deviates from the f64 "
                             f"oracle: {v_rel:.3e}")

    pu64, pv64 = u0, v0
    iters, rels, times, cpu = [], [], [], []
    for i in range(n_slabs):
        _sync(device)
        t0, c0 = time.time(), time.thread_time()
        x64, _, v_last, its, _ = solve_slab(i, pu64, pv64, rtol1, ir_rtol,
                                            n_corr)
        _sync(device)
        times.append(time.time() - t0)
        cpu.append(time.thread_time() - c0)
        # untimed TRUE residual check (gates `converged`)
        _, rn2, bn2 = resid.residual(pu64, x64, f64slabs[i], pv64)
        rels.append(float(rn2) / float(bn2))
        iters.append(its)
        last_inputs = (i, pu64, pv64, rtol1, ir_rtol, n_corr)
        pu64, pv64 = x64[-1].contiguous(), v_last
    prof = (profile_slab(lambda: solve_slab(*last_inputs), device)
            if profile else None)

    solve_s = float(np.sum(times))
    dofs_per_s = int(np.prod(shape)) * n_slabs / max(solve_s, 1e-9)
    info = dict(
        problem="wave3d",
        device=(torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu"),
        cells=mesh.n_cells, space_dofs=mesh.n_dofs(SPACE_DEGREE),
        n_blocks=n_blocks, slabs=n_slabs,
        avg_iters=float(np.mean(iters)), iters=iters,
        true_rel_residual=max(rels), true_rels=rels,
        converged=bool(all(r <= 1e-8 for r in rels)),
        setup_s=setup_s, hierarchy_s=hierarchy_s,
        estimates=dict(gmg.estimates), probe_s=probe_s, solve_s=solve_s,
        slab_s=times,
        slab_host_cpu_s=cpu,
        probe_floor=floor, rtol1=rtol1, ir_rtol=ir_rtol, n_corr=n_corr,
        v_oracle_rel=v_rel, dofs_per_s=dofs_per_s)
    if prof is not None:
        info["profile"] = prof
    return info, x64


def oracle_v_error(Alpha_1, Beta_1, Gamma_1, u64, prev_u64, v_last):
    """Relative deviation of a slab's recovered last-step v from the dense
    FP64 host oracle  A1 v = B1 u_last - G1 u_prev[last]  (numpy solve on
    the host, untimed)."""
    nt = np.asarray(Alpha_1).shape[0]
    u = u64.cpu().numpy().reshape((-1, nt) + tuple(u64.shape[1:]))
    pu = u[-2, -1] if u.shape[0] > 1 else prev_u64.cpu().numpy()
    rhs = (np.einsum("ij,j...->i...", np.asarray(Beta_1, np.float64), u[-1])
           - np.einsum("i,...->i...", np.asarray(Gamma_1, np.float64)[:, 0],
                       pu))
    v = np.linalg.solve(np.asarray(Alpha_1, np.float64),
                        rhs.reshape(nt, -1))[-1].reshape(pu.shape)
    err = np.linalg.norm((v_last.cpu().numpy() - v).reshape(-1))
    return float(err / max(np.linalg.norm(v.reshape(-1)), 1e-300))


def metric_line(info: dict) -> dict:
    return {"metric": METRIC, "value": info["dofs_per_s"], "unit": UNIT,
            "vs_baseline": info["dofs_per_s"] / 1.0e9,
            "device": info["device"]}


def main(argv=None, environ=None):
    """The command line; each switch's default reads its
    STFEM_BENCH_WAVE_* variable from environ (os.environ)."""
    environ = os.environ if environ is None else environ
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_switches(ap, SWITCHES, environ)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra, untimed slab solve")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("bench_wave: no CUDA device (the bench measures "
                         "the GPU; pass --device cpu for a functional run)")
    info, _ = run(device=args.device, profile=args.profile,
                  **switch_kwargs(args, SWITCHES))
    print(json.dumps(info), flush=True)
    if not info["converged"]:
        raise SystemExit("bench_wave: NOT converged -- metric withheld")
    print(json.dumps(metric_line(info)), flush=True)


if __name__ == "__main__":
    main()

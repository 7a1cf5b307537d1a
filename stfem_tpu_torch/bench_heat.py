"""Heat slab-solve throughput bench: the port of bench.py main()'s heat
section, default route.

3D heat, Q4 in space x dG(2) in time, `cells`^3 cells (default 16: 274,625
space DoFs), `ntao` time steps per slab (default 32: 96 time blocks, 26.4 M
space-time DoFs per slab).  Every slab is solved to a TRUE relative
residual <= 1e-8 by
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

Prints one info JSON line and, last, the metric JSON line (same name and
unit as bench.py's heat metric; the number is this device's own).

    python -m stfem_tpu_torch.bench_heat [--cells 16] [--ntao 32]
        [--slabs 10] [--device cuda]
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .integrators import ForceAssembler
from .krylov import fgmres, richardson_solve
from .mesh.grid import StructuredMesh
from .ops.kronfac import KronAssembled
from .ops.slab_residual import SlabResidual64
from .ops.spatial import LaplaceMassOperator
from .problems import heat as heat_problem
from .stmg.gmg import bench_params, build_stmg
from .system import SystemMatrix
from .time.tables import get_fe_time_weights, get_time_quad
from .types import TimeStepType

METRIC = "stmg_slab_solve_throughput_3d_heat_q4_dg2"
UNIT = "space-time DoF/s/chip (rel 1e-8 slab solves)"
FE_DEGREE, SPACE_DEGREE, TAU = 2, 4, 1.0 / 16.0
RICHARDSON_MAXITER, FGMRES_MAXITER = 40, 24


def _sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(cells: int = 16, ntao: int = 32, n_slabs: int = 10,
        device="cuda", eig_proxy_cells: int = 4, profile: bool = False):
    """Set up, probe and march n_slabs slabs.  Returns (info dict with
    the metric value under "dofs_per_s", last slab's FP64 solution).
    profile=True solves the last slab once more, untimed, under
    torch.profiler and adds its summary as info["profile"]."""
    device = torch.device(device)
    f32, f64 = torch.float32, torch.float64
    refinement = int(np.log2(cells // 2))
    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3,
                          refinement=refinement)
    assert mesh.cells[0] == cells, "cells must be 2^r with r >= 1"
    rhs_fn = lambda p, t: heat_problem.rhs(p, t, 1.0)

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
                     TAU, bench_params(eig_proxy_cells=eig_proxy_cells),
                     dtype=f32, device=device)
    _sync(device)
    print(f"# setup/hierarchy {time.time() - t_setup:.1f}s", flush=True)
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

    def outer_solve(kind, b, x0, reltol):
        if kind == "richardson":
            return richardson_solve(matrix.vmult, b, x0, gmg.vmult,
                                    maxiter=RICHARDSON_MAXITER, reltol=reltol)
        return fgmres(matrix.vmult, b, x0, gmg.vmult,
                      maxiter=FGMRES_MAXITER, reltol=reltol, abstol=1e-30,
                      reorthogonalize=False)

    def first_solve(kind, prev32, t, reltol):
        rhs = (rhs_matrix.vmult(prev32[None])
               + force.batched(float(t) + t_off, f_sc))
        return outer_solve(kind, rhs, prev32.expand(shape), reltol)

    coords = torch.as_tensor(mesh.dof_coordinates(SPACE_DEGREE), dtype=f32,
                             device=device)
    prev32_0 = heat_problem.exact_solution(coords, 0.0, 1.0).to(f32)
    prev64_0 = prev32_0.to(f64)

    # probe slab 0: run the first solve to its stall; its TRUE FP64
    # residual is the float32 floor the tolerances derive from
    t_probe = time.time()
    for kind in ("richardson", "fgmres"):
        outer = kind
        xp = first_solve(kind, prev32_0, np.float32(0.0), 1e-8).x
        _, rn, bn = resid.residual(prev64_0, xp.to(f64), f64slabs[0])
        probe_floor = float(rn) / float(bn)
        if probe_floor <= 1e-3:
            break
        print(f"# Richardson probe stalled at rel {probe_floor:.2e}; "
              "falling back to FGMRES", flush=True)
    rtol1 = max(1.4 * probe_floor, 1e-8)
    ir_rtol = min(max(0.5e-8 / max(probe_floor, 1e-12), 1e-7), 2e-3)
    _sync(device)
    probe_s = time.time() - t_probe
    print(f"# probe: floor {probe_floor:.3e} -> rtol1 {rtol1:.3e}, "
          f"ir_rtol {ir_rtol:.3e}  ({probe_s:.1f}s)", flush=True)

    def solve_slab(i, prev32, prev64, t):
        """First solve + one IR pass of slab i -> (x64, V-cycles,
        converged)."""
        res = first_solve(outer, prev32, t, rtol1)
        x64 = res.x.to(f64)
        r, rn, _ = resid.residual(prev64, x64, f64slabs[i])
        corr = outer_solve(outer, (r / rn).to(f32),
                           torch.zeros(shape, dtype=f32, device=device),
                           ir_rtol)
        x64 = x64 + rn * corr.x.to(f64)
        return x64, res.iterations + corr.iterations, res.converged

    prev32, prev64, t = prev32_0, prev64_0, np.float32(0.0)
    iters, rels, times, conv, cpu = [], [], [], True, []
    for i in range(n_slabs):
        _sync(device)
        t0, c0 = time.time(), time.thread_time()
        x64, its, ok = solve_slab(i, prev32, prev64, t)
        _sync(device)
        times.append(time.time() - t0)
        cpu.append(time.thread_time() - c0)
        # untimed TRUE residual check (gates `converged`)
        _, rn2, bn2 = resid.residual(prev64, x64, f64slabs[i])
        rels.append(float(rn2) / float(bn2))
        iters.append(its)
        conv = conv and ok
        last_inputs = (i, prev32, prev64, t)
        prev64 = x64[-1].contiguous()
        prev32 = prev64.to(f32)
        t = np.float32(t + TAU * ntao)
    prof = (profile_slab(lambda: solve_slab(*last_inputs), device)
            if profile else None)

    solve_s = float(np.sum(times))
    dofs_per_s = int(np.prod(shape)) * n_slabs / max(solve_s, 1e-9)
    info = dict(
        device=(torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu"),
        cells=mesh.n_cells, space_dofs=mesh.n_dofs(SPACE_DEGREE),
        n_blocks=n_blocks, slabs=n_slabs, outer=outer,
        avg_iters=float(np.mean(iters)), iters=iters,
        true_rel_residual=max(rels), true_rels=rels,
        converged=bool(conv and all(r <= 1e-8 for r in rels)),
        setup_s=setup_s, probe_s=probe_s, solve_s=solve_s,
        slab_s=times,
        slab_host_cpu_s=cpu, probe_floor=probe_floor, rtol1=rtol1,
        ir_rtol=ir_rtol, dofs_per_s=dofs_per_s)
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


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", type=int, default=16)
    ap.add_argument("--ntao", type=int, default=32)
    ap.add_argument("--slabs", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra, untimed slab solve")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("bench_heat: no CUDA device (the bench measures "
                         "the GPU; pass --device cpu for a functional run)")
    info, _ = run(args.cells, args.ntao, args.slabs, args.device,
                  profile=args.profile)
    print(json.dumps(info), flush=True)
    print(json.dumps(metric_line(info)), flush=True)


if __name__ == "__main__":
    main()

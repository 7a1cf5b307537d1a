"""Stokes slab-solve throughput bench: the port of bench.py's
run_stokes_bench (bench.py:79-475), with its STFEM_BENCH_STOKES_*
switches.

3D Stokes, Q2^3 velocity x DGP1 modal pressure (n_q = 3), viscosity 1,
homogeneous Dirichlet velocity, dG(1) in time (tau = 1/16), `cells`^3
cells (default 8: 14,739 velocity + 2,048 pressure DoFs), `ntao` time
steps per slab (default 8: 16 time blocks, 268,592 space-time DoFs per
slab).  At the defaults every slab is solved to a TRUE relative residual
<= 1e-8 by
  1. a float32 preconditioned-Richardson first solve with the float32
     Stokes STMG V-cycle (block Vanka, variable smoothing, pseudo-inverse
     coarse solve), rhs = the float32 rhs coupling + the rounded force,
     stopped just above the float32 floor (rtol1);
  2. one iterative-refinement pass: the FP64 saddle residual (kernel K2 for
     the velocity pair, kernel K3 for the rhs coupling), a float32
     Richardson correction solve of the unit-scaled residual to ir_rtol,
     and the FP64 update;
  3. an untimed FP64 TRUE-residual check, which gates `converged`.
The floor is the larger of the first solves' TRUE residuals on probe
slabs 0 and 1 (slab 1 starts from slab 0's carry; one probe slab when
the run has one slab), and rtol1 = max(1.4 floor, 1e-8), ir_rtol =
clip(0.5e-8 / floor, 1e-7, 2e-3).  The next slab starts from the last
time block with its pressure shifted to zero mean per block (the DGP
constant mode), in FP64.  A floor above 1e-3 (a non-contractive V-cycle)
falls back to bench.py's float32-only mode, as ir off does: one float32
solve a slab to a TRUE residual of `target` (Richardson or restarted
FGMRES), gated by the untimed FP64 residual.

Prints one info JSON line and, last, the metric JSON line (same name and
unit as bench.py's Stokes metric; the number is this device's own).

    python -m stfem_tpu_torch.bench_stokes [--cells 8] [--ntao 8]
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
from .krylov import fgmres, richardson_solve
from .mesh.fe import shape_data_1d
from .mesh.grid import StructuredMesh
from .ops.spatial import LaplaceMassOperator, _sumfac, cell_scatter
from .ops.stokes import StokesOperator
from .ops.stokes_residual import build_stokes_residual64
from .stmg.gmg import GMGParams, build_stmg_stokes
from .system_stokes import StokesSystemMatrix
from .time.tables import get_fe_time_weights, get_time_quad
from .types import SupportedSmoothers, TimeStepType
from .utils.precision import full_precision
from .utils.switches import Switch, add_switches, switch_kwargs

METRIC = "stmg_stokes_slab_solve_throughput_3d_q2_dgp1_dg1"
UNIT = "space-time DoF/s/chip (TRUE rel 1e-8 slab solves, FP64 IR)"
UNIT_F32 = "space-time DoF/s/chip (f32 slab solves, true rel <= {})"
FE_DEGREE, U_DEGREE, P_DEGREE, N_Q, TAU = 1, 2, 1, 3, 1.0 / 16.0

MAXITER = 60

_B = "STFEM_BENCH_STOKES_"
SWITCHES = (
    Switch("cells", _B + "CELLS", "cells", int, 8, "cells per axis"),
    Switch("ntao", _B + "NTAO", "ntao", int, 8, "time steps per slab"),
    Switch("slabs", _B + "SLABS", "n_slabs", int, 6, "timed slabs"),
    Switch("smoother", _B + "SMOOTHER", "smoother", str, "Relaxation",
           "Relaxation or Chebyshev (smoother)"),
    Switch("inner", _B + "INNER", "inner", int, None,
           "sweeps per smoother application (smoother_inner_iterations)"),
    Switch("range", _B + "RANGE", "smoothing_range", float, 5.0,
           "smoothing range (smoothing_range)"),
    Switch("steps", _B + "STEPS", "steps", int, 1,
           "MG smoothing steps (smoothing_steps)"),
    Switch("coarse", _B + "COARSE", "coarse", str, "Smoother",
           "coarse solve past the pseudo-inverse's size "
           "(coarse_grid_smoother_type)"),
    Switch("maxiter", _B + "MAXITER", "maxiter", int, MAXITER,
           "outer iterations per solve"),
    Switch("target", _B + "TARGET", "target", float, 1e-5,
           "TRUE residual of the float32-only mode"),
    Switch("ir", _B + "IR", "ir", "bool", True,
           "FP64 iterative refinement to TRUE 1e-8 (off: float32 only)"),
    Switch("outer", _B + "OUTER", "outer", str, "richardson",
           "float32-only mode: richardson or fgmres"),
    Switch("restart", _B + "RESTART", "restart", int, 20,
           "float32-only FGMRES: basis size per cycle"))


def force_slab(mesh, S64, t_rows, scales):
    """FP64 body force of one slab on the flat layout [T, n_u + n_p]:
    f(x, t) = s(x) sin(t + 0.3) (1, 2, -1), s = sin(pi x) sin(pi y)
    sin(pi z) (bench.py:168-197), integrated against the Q2 basis, times
    the diagonal Alpha weight of each Radau point; the pressure rows are
    zero."""
    dev, dim = S64.device, S64.dim
    f64 = torch.float64
    S1 = torch.as_tensor(shape_data_1d(U_DEGREE, N_Q).S, dtype=f64,
                         device=dev)
    pts = torch.as_tensor(mesh.quad_coordinates(N_Q), dtype=f64, device=dev)
    with full_precision():
        s = torch.prod(torch.sin(np.pi * pts), dim=-1) * S64.jxw
        base = cell_scatter(_sumfac([S1] * dim, s, dim, forward=False),
                            mesh.cells, U_DEGREE) * S64.mask_u
        comp = torch.tensor([1.0, 2.0, -1.0], dtype=f64, device=dev)
        amp = torch.sin(torch.as_tensor(t_rows, dtype=f64, device=dev) + 0.3)
        amp = amp * torch.as_tensor(scales, dtype=f64, device=dev)
        fu = amp[:, None, None] * comp[None, :, None] * base.reshape(1, 1, -1)
    return torch.cat([fu.reshape(len(t_rows), -1),
                      torch.zeros((len(t_rows), S64.n_p), dtype=f64,
                                  device=dev)], dim=1)


def pressure_means(S, x):
    """[T] mean pressure of each time block of x: [T, n_u + n_p] (the DGP
    constant mode integrated over the uniform cells, over the volume)."""
    mesh = S.mesh
    detj = float(np.prod(mesh.h))
    vol = float(np.prod(mesh.upper - mesh.lower))
    return S.unpack(x)[1][..., 0].sum(
        dim=tuple(range(1, S.dim + 1))) * (detj / vol)


def mean_normalize(S, x):
    """Remove the per-time-block mean pressure (the DGP constant mode);
    x: [T, n_u + n_p]."""
    u, p = S.unpack(x)
    dim = S.dim
    means = pressure_means(S, x)
    p = p.clone()
    p[..., 0] -= means.reshape((-1,) + (1,) * dim)
    return S.pack(u, p)


def run(cells: int = 8, ntao: int = 8, n_slabs: int = 6, device="cuda",
        profile: bool = False, *, smoother: str = "Relaxation",
        inner: int | None = None, smoothing_range: float = 5.0,
        steps: int = 1, coarse: str = "Smoother", maxiter: int = MAXITER,
        target: float = 1e-5, ir: bool = True, outer: str = "richardson",
        restart: int = 20):
    """Set up, probe and march n_slabs slabs.  Returns (info dict with the
    metric value under "dofs_per_s", last slab's FP64 solution
    [T, n_u + n_p]).  profile=True solves the last slab once more,
    untimed, under torch.profiler and adds its summary as
    info["profile"].  The keyword arguments are bench.py's Stokes
    switches (SWITCHES), with its defaults: the V-cycle's GMGParams
    fields, the Richardson iterations, and the float32-only mode (ir
    off, or an IR probe floor above 1e-3): one float32 solve a slab to a
    TRUE residual of `target`, by Richardson (to 0.5 target) or by
    FGMRES(`restart`) cycles on the true residual, ceil(maxiter /
    restart) at most (bench.py:240-290)."""
    if outer not in ("richardson", "fgmres"):
        raise ValueError(f"outer: richardson or fgmres, not {outer!r}")
    device = torch.device(device)
    f32, f64 = torch.float32, torch.float64
    dg = TimeStepType.DG
    refinement = int(np.log2(cells // 2))
    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3,
                          refinement=refinement)
    assert mesh.cells[0] == cells, "cells must be 2^r with r >= 1"

    _sync(device)
    t_setup = time.time()
    S = StokesOperator(mesh, U_DEGREE, P_DEGREE, N_Q, 1.0, dtype=f32,
                       device=device)
    Mu = LaplaceMassOperator(mesh, U_DEGREE, N_Q, 1.0, 0.0, dtype=f32,
                             device=device, mask=S.mask_u_np)
    a, b, g, _ = get_fe_time_weights(dg, FE_DEGREE, TAU, ntao)
    matrix = StokesSystemMatrix(S, Mu, a, b)
    rhs_matrix = StokesSystemMatrix(S, Mu, a, b, gamma=None, zeta=g)
    # bench.py:143-156: GMGParams' defaults with tf01stokes's smoothing
    # range, unless the switches say otherwise
    params = GMGParams(smoother=SupportedSmoothers[smoother],
                       smoothing_range=smoothing_range,
                       smoothing_steps=steps,
                       smoother_inner_iterations=inner,
                       coarse_grid_smoother_type=coarse)
    gmg = build_stmg_stokes(mesh, FE_DEGREE, dg, ntao, TAU, params=params,
                            dtype=f32, device=device)
    _sync(device)
    print(f"# setup/hierarchy {time.time() - t_setup:.1f}s", flush=True)
    S64 = StokesOperator(mesh, U_DEGREE, P_DEGREE, N_Q, 1.0, dtype=f64,
                         device=device)
    resid = build_stokes_residual64(S64, a, b, zeta=g)
    T = a.shape[0]
    n_flat = S.n_u + S.n_p
    tq = get_time_quad(dg, FE_DEGREE)[0]
    a1 = get_fe_time_weights(dg, FE_DEGREE, TAU, 1)[0]
    t_off = np.array([TAU * it + TAU * float(q) for it in range(ntao)
                      for q in tq])
    scales = np.array([a1[j, j] for _ in range(ntao)
                       for j in range(len(tq))])
    # FP64 force slabs, assembled once before the march
    forces = [force_slab(mesh, S64, i * TAU * ntao + t_off, scales)
              for i in range(n_slabs)]
    _sync(device)
    setup_s = time.time() - t_setup
    print(f"# setup {setup_s:.1f}s", flush=True)

    def solve(rhs, x0, reltol):
        return richardson_solve(matrix.vmult, rhs, x0, gmg.vmult,
                                maxiter=maxiter, reltol=reltol)

    def first_rhs(i, prev64):
        pu, pp = S.unpack(prev64.to(f32))
        return rhs_matrix.vmult_slice(pu, pp) + forces[i].to(f32)

    def solve_slab(i, prev64, rtol1, ir_rtol):
        """First solve + one IR pass of slab i -> (x64, V-cycles, the
        first solve's TRUE ||r|| / ||rhs||)."""
        res = solve(first_rhs(i, prev64), prev64.to(f32).expand(T, n_flat),
                    rtol1)
        x64 = res.x.to(f64)
        r, rn, bn = resid.residual(prev64, x64, forces[i])
        # a zero residual needs no correction (and must not be divided by)
        scale = torch.clamp_min(rn, torch.finfo(f64).tiny)
        zero32 = torch.zeros((T, n_flat), dtype=f32, device=device)
        corr = solve((r / scale).to(f32), zero32, ir_rtol)
        x64 = x64 + rn * corr.x.to(f64)
        return x64, res.iterations + corr.iterations, float(rn) / float(bn)

    def solve_slab_f32(i, prev64, *_):
        """The float32-only solve of slab i -> (x64, V-cycles, None)."""
        rhs = first_rhs(i, prev64)
        x = prev64.to(f32).expand(T, n_flat)
        if outer == "richardson":
            res = solve(rhs, x, 0.5 * target)
            return res.x.to(f64), res.iterations, None
        bnorm = torch.linalg.vector_norm(rhs)
        zero32 = torch.zeros((T, n_flat), dtype=f32, device=device)
        its = 0
        for _ in range(-(-maxiter // restart)):
            r = rhs - matrix.vmult(x)
            if float(torch.linalg.vector_norm(r) / bnorm) <= target:
                break
            res = fgmres(matrix.vmult, r, zero32, gmg.vmult,
                         maxiter=restart, abstol=1e-30, reltol=1e-9)
            x, its = x + res.x, its + res.iterations
        return x.to(f64), its, None

    def carry(x64):
        return mean_normalize(S64, x64)[-1].contiguous()

    # probe slabs 0 and 1: the first solves run to their stall; slabs with
    # a nonzero previous value have another float32 floor (bench.py:351-369)
    t_probe = time.time()
    zero = torch.zeros(n_flat, dtype=f64, device=device)
    floor = floors = rtol1 = ir_rtol = None
    if ir:
        xp, _, floor = solve_slab(0, zero, 1e-8, 2.0)
        floors = [floor]
        if np.isfinite(floor) and floor <= 1e-3 and n_slabs > 1:
            floors.append(solve_slab(1, carry(xp), 1e-8, 2.0)[2])
        floor = max(floors) if all(np.isfinite(floors)) else float("nan")
        if np.isfinite(floor) and floor <= 1e-3:
            rtol1 = max(1.4 * floor, 1e-8)
            ir_rtol = min(max(0.5e-8 / max(floor, 1e-12), 1e-7), 2e-3)
            print(f"# stokes probe: floors {floors} -> rtol1 {rtol1:.3e}, "
                  f"ir_rtol {ir_rtol:.3e}", flush=True)
        else:
            print(f"# stokes IR probe floor {floor:.3e} (non-contractive "
                  "V-cycle?) -- falling back to the float32-only path",
                  flush=True)
            ir = False
    _sync(device)
    probe_s = time.time() - t_probe
    slab_fn = solve_slab if ir else solve_slab_f32
    bar = 1e-8 if ir else target

    prev64 = zero
    iters, rels, times, cpu = [], [], [], []
    for i in range(n_slabs):
        _sync(device)
        t0, c0 = time.time(), time.thread_time()
        x64, its, _ = slab_fn(i, prev64, rtol1, ir_rtol)
        _sync(device)
        times.append(time.time() - t0)
        cpu.append(time.thread_time() - c0)
        # untimed TRUE residual check (gates `converged`)
        _, rn2, bn2 = resid.residual(prev64, x64, forces[i])
        rels.append(float(rn2) / float(bn2))
        iters.append(its)
        last_inputs = (i, prev64, rtol1, ir_rtol)
        prev64 = carry(x64)
    prof = (profile_slab(lambda: slab_fn(*last_inputs), device)
            if profile else None)

    solve_s = float(np.sum(times))
    dofs_per_s = T * n_flat * n_slabs / max(solve_s, 1e-9)
    info = dict(
        problem="stokes3d",
        device=(torch.cuda.get_device_name(device)
                if device.type == "cuda" else "cpu"),
        cells=mesh.n_cells, u_dofs=S.n_u, p_dofs=S.n_p, n_blocks=T,
        slabs=n_slabs, ir=ir, outer="richardson" if ir else outer,
        target=bar, avg_iters=float(np.mean(iters)), iters=iters,
        true_rel_residual=max(rels), true_rels=rels,
        converged=bool(all(r <= bar for r in rels)),
        setup_s=setup_s, probe_s=probe_s, solve_s=solve_s, slab_s=times,
        slab_host_cpu_s=cpu,
        probe_floor=floor, probe_floors=floors, rtol1=rtol1,
        ir_rtol=ir_rtol,
        carry_p_mean=float(pressure_means(S64, prev64[None])[0]),
        dofs_per_s=dofs_per_s)
    if prof is not None:
        info["profile"] = prof
    return info, x64


def metric_line(info: dict) -> dict:
    unit = UNIT if info["ir"] else UNIT_F32.format(
        f"{info['target']:g}".replace("e-0", "e-"))
    return {"metric": METRIC, "value": info["dofs_per_s"], "unit": unit,
            "vs_baseline": info["dofs_per_s"] / 1.0e9,
            "device": info["device"]}


def main(argv=None, environ=None):
    """The command line; each switch's default reads its
    STFEM_BENCH_STOKES_* variable from environ (os.environ)."""
    environ = os.environ if environ is None else environ
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_switches(ap, SWITCHES, environ)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--profile", action="store_true",
                    help="profile one extra, untimed slab solve")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("bench_stokes: no CUDA device (the bench measures "
                         "the GPU; pass --device cpu for a functional run)")
    info, _ = run(device=args.device, profile=args.profile,
                  **switch_kwargs(args, SWITCHES))
    print(json.dumps(info), flush=True)
    if not info["converged"]:
        raise SystemExit("bench_stokes: NOT converged -- metric withheld")
    print(json.dumps(metric_line(info)), flush=True)


if __name__ == "__main__":
    main()

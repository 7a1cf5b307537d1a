"""The sharded whole solve (counterpart of stfem_tpu/parallel/minibench.py):
the headline bench's composition -- 3D heat, Q4 in space x dG(2) in time,
a float32 Richardson first solve with the float32 STMG V-cycle, one FP64
iterative-refinement pass and the FP64 TRUE residual -- with the block
vector split over a 3-axis mesh of ranks, fine levels split and coarse
levels replicated (the reference's per-level partitioners,
include/stmg.h:563-586).

stfem_tpu lets GSPMD partition its jitted solve; here the decomposition
is explicit (parallel/__init__.py has the layout convention).  Each rank
holds its consistent slab; the first solve's operator, the rhs, the
force and the FP64 residual are the local ones on the rank's sub-mesh
under the global mask, each ended by one accumulate; the norms are
interface-weighted and all-reduced; the V-cycle is the global
hierarchy's distributed form (sharding.install_level_shardings), with
the global smoothers' omegas.  Rank 0 builds the global hierarchy first
and sends its estimates to the other ranks, which take them instead of
estimating.

With compare_single, rank 0 also solves the same slab unsharded with the
global operators, and every rank gets its counts: iteration parity.  The
collectives of the sharded run are counted (comm.COUNTS) and returned
under "collectives", with the launches of the port's kernels on this
rank under "launches".

    python -m stfem_tpu_torch.parallel.dryrun --devices 8
spawns the ranks and runs this at stfem_tpu's dry-run size.
"""
from __future__ import annotations

import time

import numpy as np
import torch
import torch.distributed as dist

from .comm import _require_dist, broadcast_object, read_counters, \
    reset_counters

RICHARDSON_MAXITER = 40
TAU = 1.0 / 16.0
# the largest relative difference admitted between the sharded and the
# single-device FP64 solutions (run_sharded_minibench's solution_match):
# sound runs on 8 gloo ranks read 5.8e-11 (cells 4, ntao 2, Q2 x dG(1))
# and 1.5e-10 (cells 8, ntao 8, Q4 x dG(2)) on the CPU, 1.0e-10 (cells 8,
# ntao 8) and 4.5e-10 (cells 16, ntao 32) on one NVIDIA H100 80GB HBM3,
# 700 W, that the ranks share
SOLUTION_RTOL = 1e-7


def kernel_launches() -> dict:
    """The launch counts of the port's kernel wrappers (K1-K5)."""
    from ..ops.banded_apply import banded_apply
    from ..ops.grid_chain import chain_down, chain_up
    from ..ops.kron_pair import kron_pair
    from ..ops.quad_middle import quad_middle
    from ..ops.time_solve import time_solve
    return {f.__name__: f.launches for f in (time_solve, kron_pair,
                                             banded_apply, chain_down,
                                             chain_up, quad_middle)}


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _solve_slab(A, vcycle, rhs32, x0, residual, norm, rtol1, ir_rtol):
    """Richardson to rtol1, one FP64 IR correction to ir_rtol, the TRUE
    residual (stfem_tpu minibench.py:191-200) -> (V-cycles, TRUE rel,
    x64).  residual(x64) -> (r, ||r||, ||rhs||)."""
    from ..krylov import richardson_solve
    solve = lambda b, x, tol: richardson_solve(
        A, b, x, vcycle, maxiter=RICHARDSON_MAXITER, abstol=1e-30,
        reltol=tol, norm=norm)
    first = solve(rhs32, x0, rtol1)
    x64 = first.x.to(torch.float64)
    r, rn, _ = residual(x64)
    corr = solve((r / rn).to(rhs32.dtype), torch.zeros_like(rhs32), ir_rtol)
    x64 = x64 + rn * corr.x.to(torch.float64)
    _, rn2, bn2 = residual(x64)
    return first.iterations + corr.iterations, float(rn2) / float(bn2), x64


def minibench_mesh(cells: int):
    """The minibench's global mesh: cells^3 cells on the unit cube, cells
    = 2^r with r >= 1."""
    from ..mesh.grid import StructuredMesh
    mesh = StructuredMesh([2] * 3, [0.0] * 3, [1.0] * 3,
                          refinement=int(np.log2(cells // 2)))
    if mesh.cells[0] != cells:
        raise ValueError(f"cells must be 2^r with r >= 1, not {cells}")
    return mesh


def hierarchy(mesh, ntao: int, fe_degree: int = 2, space_degree: int = 4,
              dtype=torch.float32, device="cuda", estimate_cache=None):
    """(tables, gmg): the dG time tables (Alpha, Beta, Gamma) at tau = TAU
    and the global STMG hierarchy on `mesh` with stfem_tpu
    minibench.py:70-75's GMGParams (1 smoothing step, 2 inner
    iterations, Direct coarse, 4-cell eigen-proxy) in dtype;
    estimate_cache as build_stmg's."""
    from ..stmg.gmg import GMGParams, build_stmg
    from ..time.tables import get_fe_time_weights
    from ..types import TimeStepType

    Alpha, Beta, Gamma, _ = get_fe_time_weights(TimeStepType.DG, fe_degree,
                                                TAU, ntao)
    params = GMGParams(smoothing_steps=1, variable=False,
                       smoother_inner_iterations=2,
                       skip_identity_levels=True,
                       coarse_grid_smoother_type="Direct", eig_proxy_cells=4)
    gmg = build_stmg(mesh, fe_degree, space_degree, TimeStepType.DG, ntao,
                     TAU, params, dtype=dtype, device=device,
                     fe_degree_min=1, estimate_cache=estimate_cache)
    return (Alpha, Beta, Gamma), gmg


def run_sharded_minibench(n_devices: int | None = None, cells: int = 8,
                          ntao: int = 8, fe_degree: int = 2,
                          space_degree: int = 4, shard_z: bool = True,
                          compare_single: bool = True,
                          rtol1: float = 2e-5, ir_rtol: float = 1e-3,
                          min_dofs_per_device: int = 2048,
                          verbose: bool = True, *, device="cuda",
                          world=None, dtype=torch.float32,
                          keep_solutions: bool = False) -> dict:
    """One slab of the sharded solve on every rank of the process group
    (raises without one).  world: the spatial DeviceMesh (or a
    sharding.RankLayout); None builds sharding.spatial_mesh(n_devices,
    3, shard_z) over the world.  dtype: the first solve's and the
    V-cycle's.  Returns stfem_tpu's keys (single_iters, single_true_rel,
    sharded_iters, sharded_true_rel, mesh, collectives, cells, ntao,
    n_blocks, space_dofs, converged, iter_parity) and the port's: policy,
    local_dof_shape, residual_kernel (the kernel that computed the FP64
    residual on this rank, from its launches; None where none launched,
    as on the CPU), launches, single_s and sharded_s (rank 0's walls of
    the slab, its operators' setup included), with compare_single
    solution_rel_diff (the largest difference of the gathered sharded
    solution from rank 0's single-device one, relative to the latter's
    largest entry) and solution_match (it is at most SOLUTION_RTOL), and
    with keep_solutions the FP64 solutions single_x (rank 0) and
    sharded_x (gathered)."""
    from ..integrators import ForceAssembler
    from ..ops.kronfac import KronAssembled
    from ..ops.slab_residual import SlabResidual64
    from ..ops.spatial import LaplaceMassOperator
    from ..problems import heat as heat_problem
    from ..stmg.eig_cache import EstimateCache, cache_path
    from ..system import SystemMatrix
    from ..time.tables import get_time_quad
    from ..types import TimeStepType
    from .halo import make_sharded_vmult
    from .sharding import (RankLayout, install_level_shardings,
                           level_sharding_policy, spatial_mesh)

    _require_dist()
    device = torch.device(device)
    f64 = torch.float64
    rank = dist.get_rank()
    if world is None:
        world = spatial_mesh(n_devices, dim=3, shard_z=shard_z,
                             device_type=device.type)
    layout = RankLayout.from_mesh(world)
    mesh, tau = minibench_mesh(cells), TAU

    # the global hierarchy: rank 0 estimates (or reads the disk cache),
    # the other ranks take its estimates
    def build(cache):
        return hierarchy(mesh, ntao, fe_degree, space_degree, dtype, device,
                         cache)

    if rank == 0:
        (Alpha, Beta, Gamma), gmg = build(EstimateCache(cache_path()))
    entries = broadcast_object(gmg.estimate_entries if rank == 0 else None)
    if rank != 0:
        (Alpha, Beta, Gamma), gmg = build(EstimateCache(None,
                                                        preset=entries))
    n_blocks = Alpha.shape[0]

    tq = get_time_quad(TimeStepType.DG, fe_degree)[0]
    nt = len(tq)
    t_off = np.array([tau * (row // nt) + tau * float(tq[row % nt])
                      for row in range(n_blocks)], np.float32)
    f_sc = np.array([Alpha[row, row] for row in range(n_blocks)], np.float32)
    as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=device)
    coords = as_t(mesh.dof_coordinates(space_degree), f64)
    prev64 = heat_problem.exact_solution(coords, 0.0, 1.0)
    rhs_fn = lambda p, t: heat_problem.rhs(p, t, 1.0)
    k, n_q = space_degree, space_degree + 1

    def discretisation(m, mask):
        """The slab operators, the float32 rhs and the FP64 residual of
        mesh m under mask (the global mesh, or a rank's sub-mesh)."""
        ops = {dt: [LaplaceMassOperator(m, k, n_q, ms, ls, dtype=dt,
                                        device=device, mask=mask)
                    for ms, ls in ((0.0, 1.0), (1.0, 0.0))]
               for dt in (dtype, f64)}
        matrix = SystemMatrix(*ops[dtype], Alpha, Beta)
        rhs_matrix = SystemMatrix(*ops[dtype], np.zeros_like(Gamma), Gamma)
        force = ForceAssembler(m, k, n_q, rhs_fn, mask, dtype=dtype,
                               device=device)
        f64slab = ForceAssembler(m, k, n_q, rhs_fn, mask, dtype=f64,
                                 device=device).batched(
            as_t(t_off, f64), as_t(f_sc, f64))
        resid = SlabResidual64(KronAssembled(*ops[f64], f64), mask, Alpha,
                               Beta, Gamma)

        def rhs32(prev32):
            return (rhs_matrix.vmult(prev32[None])
                    + force.batched(as_t(t_off, dtype), as_t(f_sc, dtype)))

        return matrix, rhs32, resid, f64slab

    out = dict(cells=cells, ntao=ntao, n_blocks=int(n_blocks),
               space_dofs=int(mesh.n_dofs(space_degree)))
    single = None
    if compare_single and rank == 0:
        _sync(device)
        t0 = time.time()
        matrix, rhs32, resid, f64slab = discretisation(
            mesh, mesh.boundary_dof_mask(k))
        prev32 = prev64.to(dtype)
        shape = (n_blocks,) + tuple(prev32.shape)
        its, rel, x64 = _solve_slab(
            matrix.vmult, gmg.vmult, rhs32(prev32), prev32.expand(shape),
            lambda x: resid.residual(prev64, x, f64slab), None, rtol1,
            ir_rtol)
        _sync(device)
        single = (its, rel, time.time() - t0)
        single_x = x64
        if verbose:
            print(f"# minibench single-device: {its} total V-cycle steps, "
                  f"true rel {rel:.2e}", flush=True)
        del matrix, rhs32, resid, f64slab, x64
    if compare_single:
        single = broadcast_object(single)
        out.update(single_iters=int(single[0]), single_true_rel=single[1],
                   single_s=single[2])

    policy = level_sharding_policy(layout.n_ranks, gmg,
                                   min_dofs_per_device=min_dofs_per_device)
    vcycle = install_level_shardings(gmg, policy, layout).vmult
    sub = layout.submesh(mesh)
    mask = layout.mask(mesh, k)
    _sync(device)
    reset_counters()
    before = kernel_launches()
    t0 = time.time()
    matrix, rhs32, resid, f64slab = discretisation(sub, mask)
    prev64_l = layout.slab(prev64[None], k)[0]
    prev32_l = prev64_l.to(dtype)
    shape = (n_blocks,) + tuple(prev32_l.shape)
    norm32, norm64 = (layout.krylov_options(shape, dt, device)["norm"]
                      for dt in (dtype, f64))
    its, rel, x64 = _solve_slab(
        make_sharded_vmult(matrix, layout.groups), vcycle,
        layout.accumulate(rhs32(prev32_l)), prev32_l.expand(shape),
        lambda x: resid.residual(prev64_l, x, f64slab,
                                 accumulate=layout.accumulate,
                                 norm=norm64),
        norm32, rtol1, ir_rtol)
    _sync(device)
    sharded_s = time.time() - t0
    after, collectives = kernel_launches(), read_counters()
    launches = {n: after[n] - before[n] for n in after}
    out.update(
        sharded_iters=int(its), sharded_true_rel=float(rel),
        sharded_s=broadcast_object(sharded_s),
        mesh=dict(zip(("x", "y", "z"), layout.shape)),
        collectives=collectives, policy=policy,
        local_dof_shape=tuple(prev32_l.shape),
        residual_kernel=("K2 kron_pair" if launches["kron_pair"]
                         else "K3 banded_apply" if launches["banded_apply"]
                         else None),
        launches=launches)
    out["converged"] = out["sharded_true_rel"] <= 1e-8
    if compare_single or keep_solutions:
        sharded_x = layout.gather(x64)
    if compare_single:
        out["iter_parity"] = out["sharded_iters"] == out["single_iters"]
        diff = None
        if rank == 0:
            diff = float((sharded_x - single_x).abs().max()
                         / single_x.abs().max())
        out["solution_rel_diff"] = broadcast_object(diff)
        out["solution_match"] = out["solution_rel_diff"] <= SOLUTION_RTOL
    if keep_solutions:
        out["sharded_x"] = sharded_x
        if compare_single and rank == 0:
            out["single_x"] = single_x
    if verbose and rank == 0:
        print(f"# minibench sharded: mesh {out['mesh']}, "
              f"{out['sharded_iters']} total V-cycle steps, true rel "
              f"{out['sharded_true_rel']:.2e}, collectives "
              f"{out['collectives']}", flush=True)
        if compare_single:
            print(f"# minibench: sharded solution within "
                  f"{out['solution_rel_diff']:.2e} of the single-device one "
                  f"(tol {SOLUTION_RTOL:g})", flush=True)
    return out

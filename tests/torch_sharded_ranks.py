"""The rank program of tests/test_torch_sharded_solve.py: one spawned
process per gloo rank, importing only torch, numpy and stfem_tpu_torch
(the test process computes stfem_tpu's references and compares).  Every
case runs in one spawn of 8 ranks; each rank writes its results to
<out_dir>/rank<r>.npz (arrays) and rank<r>.json (the minibench result)."""
import json
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from stfem_tpu_torch.krylov import fgmres
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.parallel.minibench import run_sharded_minibench
from stfem_tpu_torch.parallel.sharding import (RankLayout,
                                               gather_block_vector,
                                               install_level_shardings,
                                               level_sharding_policy,
                                               shard_block_vector,
                                               spatial_mesh)
from stfem_tpu_torch.stmg.gmg import GMGParams, build_stmg
from stfem_tpu_torch.system import SystemMatrix
from stfem_tpu_torch.types import TimeStepType

WORLD = 8
TAU = 1.0 / 8
# stfem_tpu's tests/test_halo.py::test_sharded_stmg_solve_parity
MIN_DOFS_2D = 24
# the 3D minibench at a small size: the fine levels split, the 2^3 level
# replicated
MINIBENCH = dict(cells=4, ntao=2, fe_degree=1, space_degree=2,
                 min_dofs_per_device=8)


def hierarchy_2d(dtype, omegas, coarse_Ainv):
    """The port's hierarchy of test_halo.py's slow test (8 x 8 cells, Q2,
    dG(1), 2 steps) with stfem_tpu's omegas and coarse inverse carried
    across (a fixed omega builds it without estimates)."""
    g = build_stmg(StructuredMesh([1, 1], [0, 0], [1, 1], refinement=3), 1,
                   2, TimeStepType.DG, 2, TAU,
                   GMGParams(smoothing_steps=2, variable=False,
                             coarse_grid_smoother_type="Direct",
                             relaxation=1.0),
                   dtype=dtype, device="cpu", fe_degree_min=1)
    for lvl, omega in zip(g.levels, omegas):
        if omega is not None:
            lvl.smoother.omega = float(omega)
    g.coarse_Ainv = torch.as_tensor(coarse_Ainv)
    return g


def run_ranks(rank: int, init_file: str, out_dir: str, cases: dict):
    torch.set_num_threads(1)
    os.environ["STFEM_EIG_CACHE"] = "0"
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=60))
    try:
        out = {}
        # (i) the 2D V-cycle in FP64 and FGMRES in float32 on the 2 x 4
        #     mesh, sharded and replicated levels mixed
        dm = spatial_mesh(WORLD, dim=2, device_type="cpu")
        layout = RankLayout.from_mesh(dm)
        out["coord"] = np.array(layout.coord)
        dist_gmg = {}
        for dt in (torch.float64, torch.float32):
            g = hierarchy_2d(dt, cases["omegas"][dt], cases["Ainv"][dt])
            policy = level_sharding_policy(WORLD, g,
                                           min_dofs_per_device=MIN_DOFS_2D)
            dist_gmg[dt] = install_level_shardings(g, policy, dm)
        out["policy"] = np.array(policy)
        x = torch.as_tensor(cases["x"])
        out["vcycle"] = dist_gmg[torch.float64].vmult(
            shard_block_vector(x, dm, 2)).numpy()
        mesh = StructuredMesh([1, 1], [0, 0], [1, 1], refinement=3)
        sub, mask = layout.submesh(mesh), layout.mask(mesh, 2)
        K, M = (LaplaceMassOperator(sub, 2, 3, ms, ls, dtype=torch.float32,
                                    device="cpu", mask=mask)
                for ms, ls in ((0.0, 1.0), (1.0, 0.0)))
        mat = SystemMatrix(K, M, cases["A"], cases["B"])
        b = shard_block_vector(torch.as_tensor(cases["rhs"]), dm, 2)
        res = fgmres(lambda v: layout.accumulate(mat.vmult(v)), b,
                     torch.zeros_like(b), dist_gmg[torch.float32].vmult,
                     maxiter=25, abstol=1e-30, reltol=1e-10,
                     **layout.krylov_options(b.shape, b.dtype, b.device))
        out["fgmres_x"] = res.x.numpy()
        out["fgmres_iters"] = np.array(res.iterations)
        # shard_block_vector / gather_block_vector round trip
        back = gather_block_vector(shard_block_vector(x, dm, 2), dm)
        out["round_trip"] = np.array(bool(torch.equal(back, x)))
        # (ii) the 3D minibench at a small size on the (2, 2, 2) mesh
        mb = run_sharded_minibench(device="cpu", verbose=False, **MINIBENCH)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(mb, f)
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()

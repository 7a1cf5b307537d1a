"""The rank program of tests/test_torch_halo.py: one spawned process per
gloo rank, importing only torch, numpy and stfem_tpu_torch (the test
process computes stfem_tpu's references and compares).  Every case runs
in one spawn of 8 ranks; each rank writes its results to
<out_dir>/rank<r>.npz."""
import os
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.parallel.comm import (gather_metadata, halo_accumulate,
                                           psum_dot, psum_norm,
                                           two_level_mesh)
from stfem_tpu_torch.parallel.halo import (local_mask, local_submesh,
                                           make_sharded_vmult,
                                           split_dof_grid)
from stfem_tpu_torch.parallel.sharding import spatial_mesh
from stfem_tpu_torch.system import SystemMatrix

WORLD = 8


def _sharded_apply(mesh, degree, A, B, x, shard, n_shards, groups):
    """This rank's slab of the masked operator apply: the local operator
    (no mask of its own) on the masked slab, masked again."""
    sub = local_submesh(mesh, shard, n_shards)
    ones = np.ones(sub.dof_shape(degree))
    K, M = (LaplaceMassOperator(sub, degree, degree + 1, m, l,
                                dtype=torch.float64, device="cpu", mask=ones)
            for m, l in ((0.0, 1.0), (1.0, 0.0)))
    vmult = make_sharded_vmult(SystemMatrix(K, M, A, B), groups)
    mask = torch.as_tensor(local_mask(mesh, degree, shard, n_shards))
    return (vmult(x * mask) * mask).numpy()


def _slab(g, shard, n_shards, degree):
    """The rank's overlapping slab of g [n_blocks, *dof grid]."""
    for d, (s, n) in enumerate(zip(shard, n_shards)):
        g = split_dof_grid(g, n, degree, axis=1 + d)[s]
    return torch.as_tensor(g)


def run_ranks(rank: int, init_file: str, out_dir: str, cases: dict):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{init_file}",
                            rank=rank, world_size=WORLD,
                            timeout=timedelta(seconds=60))
    try:
        out = {}
        mesh = StructuredMesh([1, 1], [0, 0], [1, 1], refinement=3)
        # 1D split of the 8 x 8 cells on a group of 4 ranks, degrees 1, 2
        first4 = dist.new_group([0, 1, 2, 3])
        for degree, (A, B, x) in sorted(cases["split1d"].items()):
            if rank < 4:
                out[f"split1d_{degree}"] = _sharded_apply(
                    mesh, degree, A, B, _slab(x, (rank,), (4,), degree),
                    rank, 4, first4)
        if rank < 4:
            y = torch.ones((2, 3))
            out["periodic"] = halo_accumulate(y, first4, 0,
                                              periodic=True).numpy()
            out["open"] = halo_accumulate(y, first4, 0).numpy()
        # the 2 x 4 mesh (corners shared by 4 ranks), degree 2, and the
        # interface-weighted dots, degree 3
        dm = spatial_mesh(WORLD, dim=2)
        shape = tuple(dm.mesh.shape)
        coord = tuple(int(c) for c in dm.get_coordinate())
        groups = (dm.get_group("x"), dm.get_group("y"))
        A, B, x = cases["split2d"]
        out["mesh_shape"] = np.array(shape)
        out["coord"] = np.array(coord)
        out["split2d"] = _sharded_apply(mesh, 2, A, B, _slab(x, coord, shape,
                                                             2),
                                        coord, shape, groups)
        a, b = (_slab(v, coord, shape, 3) for v in cases["dots"])
        out["dot"] = psum_dot(a, b, groups, (1, 2)).numpy()
        out["norm"] = psum_norm(a, groups, (1, 2)).numpy()
        out["gathered"] = gather_metadata(
            torch.tensor([rank, 10 * rank], dtype=torch.float64)).numpy()
        # the nested mesh: its axes and the local tile of a (2, 4, 4)
        # array split over ("x", "y") and replicated over "dcn"
        from torch.distributed.tensor import (Replicate, Shard,
                                              distribute_tensor)
        tl = two_level_mesh(2, (2, 2))
        out["two_level_names"] = np.array(tl.mesh_dim_names)
        out["two_level_shape"] = np.array(tuple(tl.mesh.shape))
        tile = distribute_tensor(torch.zeros((2, 4, 4)), tl,
                                 [Replicate(), Shard(1), Shard(2)])
        out["two_level_tile"] = np.array(tuple(tile.to_local().shape))
        np.savez(os.path.join(out_dir, f"rank{rank}.npz"), **out)
        dist.barrier()
    finally:
        dist.destroy_process_group()

"""Device meshes over the spatial axes and the per-level sharding rule of
the STMG hierarchy (counterpart of stfem_tpu/parallel/sharding.py).

The reference's MPI domain decomposition becomes a split of the spatial
dof-grid axes over a mesh of ranks; the time-direction operations
(Alpha/Beta mixing, time transfers, the wave's v-recovery) are
block-local and never communicate.  A block vector [n_blocks, *dof grid]
keeps its blocks whole and splits its leading spatial axes, one per mesh
dimension (block_vector_spec).  Coarse levels too small to share are
replicated: level_sharding_policy, the reference's coarse-level
repartitioning (stmg.h:563-586).
"""
from __future__ import annotations

import numpy as np
import torch.distributed as dist

from .comm import _require_dist


def spatial_mesh_shape(n_devices: int, dim: int = 2,
                       shard_z: bool = False) -> tuple[tuple, tuple]:
    """(shape, axis names) of stfem_tpu's spatial mesh: ("x",) for 1D; a
    near-square (a, n / a) over ("x", "y") for dim >= 2, a the largest
    divisor of n not above sqrt(n); with shard_z in 3D a near-cubic
    (a, b, c) over ("x", "y", "z")."""
    n = int(n_devices)
    if dim == 1:
        return (n,), ("x",)
    if dim >= 3 and shard_z:
        a = int(np.floor(n ** (1.0 / 3.0)))
        while n % a:
            a -= 1
        rem = n // a
        b = int(np.floor(np.sqrt(rem)))
        while rem % b:
            b -= 1
        return (a, b, rem // b), ("x", "y", "z")
    a = int(np.floor(np.sqrt(n)))
    while n % a:
        a -= 1
    return (a, n // a), ("x", "y")


def spatial_mesh(n_devices: int | None = None, dim: int = 2,
                 shard_z: bool = False, device_type: str = "cpu"):
    """The spatial DeviceMesh of spatial_mesh_shape over the world's ranks
    (n_devices: the world size); mesh.get_group(name) is an axis's
    process group."""
    _require_dist()
    from torch.distributed.device_mesh import init_device_mesh

    n = dist.get_world_size() if n_devices is None else int(n_devices)
    shape, names = spatial_mesh_shape(n, dim, shard_z)
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def _axis_names(mesh) -> tuple:
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(mesh if names is None else names)


def block_vector_spec(mesh, dim: int) -> tuple:
    """The layout of [n_blocks, *dof grid] on `mesh` (a DeviceMesh or its
    axis names): None for the block axis, then the mesh's axis names on
    the leading spatial axes and None on the rest."""
    names = _axis_names(mesh)
    return (None,) + tuple(names[i] if i < len(names) else None
                           for i in range(dim))


def level_sharding_policy(mesh, gmg, min_dofs_per_device: int = 512
                          ) -> list[str]:
    """Per level of gmg (in gmg.levels' order, coarsest first): "sharded"
    while the level holds at least min_dofs_per_device spatial dofs per
    device, else "replicated" (a coarse level is recomputed everywhere
    rather than communicated).  mesh: a DeviceMesh or its number of
    devices."""
    n_dev = mesh if isinstance(mesh, int) else int(mesh.size())
    return ["sharded" if int(np.prod(lvl.dof_shape))
            >= min_dofs_per_device * n_dev else "replicated"
            for lvl in gmg.levels]

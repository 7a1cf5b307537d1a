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

RankLayout is one rank's place in such a mesh: its coordinate, the
process group of each split axis, its consistent slab of a global block
vector (shard_block_vector, gather_block_vector for the way back), its
sub-mesh and mask, the accumulate that ends a sharded apply and the
interface-weighted dot and norm (comm.psum_dot / psum_norm).
install_level_shardings turns a global STMG hierarchy into this rank's
distributed one (stmg/gmg.py::distribute_gmg).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from .comm import (COUNTS, _require_dist, _staged, halo_accumulate_nd,
                   interface_weights, psum, psum_norm)
from .halo import join_dof_grid, local_mask, local_submesh, split_dof_grid


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
                 shard_z: bool = False, device_type: str = "cuda"):
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


class RankLayout:
    """This rank's place in a spatial mesh of ranks over the whole world:
    the mesh's shape over the leading spatial axes (array axes 1 ..
    len(shape) of a block vector [n_blocks, *dof grid]), this rank's
    coordinate, each split axis's process group and the grid of global
    ranks by coordinate.  Reductions over the whole mesh are one
    all-reduce over the world."""

    def __init__(self, shape, coord, groups, ranks):
        self.shape = tuple(int(n) for n in shape)
        self.coord = tuple(int(c) for c in coord)
        self.groups = tuple(groups)
        self.ranks = np.asarray(ranks).reshape(self.shape)
        self.axes = tuple(range(1, 1 + len(self.shape)))
        self.n_ranks = int(np.prod(self.shape))
        self._weights = {}

    @classmethod
    def from_mesh(cls, mesh) -> "RankLayout":
        """The layout of a DeviceMesh (sharding.spatial_mesh); a
        RankLayout is returned as it is."""
        if isinstance(mesh, cls):
            return mesh
        _require_dist()
        if int(mesh.size()) != dist.get_world_size():
            raise ValueError("the sharded solve takes a mesh over every "
                             f"rank: {int(mesh.size())} of "
                             f"{dist.get_world_size()}")
        names = mesh.mesh_dim_names
        return cls(tuple(mesh.mesh.shape), mesh.get_coordinate(),
                   [mesh.get_group(n) for n in names],
                   mesh.mesh.cpu().numpy())

    def cell_ranges(self, cells) -> list:
        """[lo, hi) of this rank's cells along each axis of a mesh with
        `cells` cells per axis (the axes beyond the mesh's whole)."""
        out = []
        for d, nc in enumerate(cells):
            nc = int(nc)
            if d >= len(self.shape):
                out.append((0, nc))
                continue
            if nc % self.shape[d]:
                raise ValueError(f"axis {d}: {nc} cells do not split into "
                                 f"{self.shape[d]}")
            cl = nc // self.shape[d]
            out.append((self.coord[d] * cl, (self.coord[d] + 1) * cl))
        return out

    def submesh(self, mesh_full):
        return local_submesh(mesh_full, self.coord, self.shape)

    def mask(self, mesh_full, degree: int) -> np.ndarray:
        return local_mask(mesh_full, degree, self.coord, self.shape)

    def slab(self, x: torch.Tensor, degree: int = 1) -> torch.Tensor:
        """This rank's consistent slab of a global [n_blocks, *dof grid]
        (every shared plane whole on both of its ranks): split_dof_grid's
        slab on each split axis.  degree only checks that the cuts fall on
        cell boundaries."""
        for d, (s, n) in enumerate(zip(self.coord, self.shape)):
            x = split_dof_grid(x, n, degree, axis=1 + d)[s]
        return x

    def gather(self, x_local: torch.Tensor) -> torch.Tensor:
        """The global block vector from every rank's consistent slab (one
        all-gather over the world), on every rank."""
        _require_dist()
        src = x_local.contiguous()
        if self.n_ranks > 1:
            COUNTS["all_gathers"] += 1
            if _staged(None, src):
                src = src.cpu()
            parts = [torch.empty_like(src) for _ in range(self.n_ranks)]
            dist.all_gather(parts, src)
            parts = [p.to(x_local.device) for p in parts]
        else:
            parts = [src]

        def join(grid, axis):
            if grid.ndim == 0:
                return parts[int(grid)]
            return join_dof_grid([join(g, axis + 1) for g in grid], 1, axis)

        return join(self.ranks, 1)

    def accumulate(self, y: torch.Tensor) -> torch.Tensor:
        """The shared planes' partial sums of a local apply added across
        the ranks (comm.halo_accumulate_nd)."""
        return halo_accumulate_nd(y, self.groups, self.axes)

    def weights(self, shape, dtype, device) -> torch.Tensor:
        """comm.interface_weights of a local block vector, kept per
        shape."""
        key = (tuple(shape), dtype, str(device))
        if key not in self._weights:
            self._weights[key] = interface_weights(shape, self.groups,
                                                   self.axes, dtype, device)
        return self._weights[key]

    def krylov_options(self, shape, dtype, device) -> dict:
        """The norm and dot of krylov.richardson_solve / fgmres for local
        block vectors of `shape` (also flattened): comm.psum_norm and the
        rows' comm.psum_dot, in one all-reduce over the world each; on one
        rank the plain ones, bitwise."""
        wf = self.weights(shape, dtype, device).reshape(-1)

        def norm(a: torch.Tensor) -> float:
            a = a.reshape(-1)
            if self.n_ranks == 1:
                return float(torch.linalg.vector_norm(a))
            return float(psum_norm(a, self.groups, (0,), wf.to(a.dtype)))

        def dot(V: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
            """The rows of V [m, n] against v [n]."""
            if self.n_ranks == 1:
                return V @ v
            return psum(V @ (wf.to(v.dtype) * v), self.groups)

        return {"norm": norm, "dot": dot}


def shard_block_vector(x, mesh, degree: int = 1):
    """This rank's consistent slab of the global block vector x
    [n_blocks, *dof grid] on `mesh` (a DeviceMesh or a RankLayout): the
    slab of split_dof_grid on each split axis, by the mesh coordinate."""
    return RankLayout.from_mesh(mesh).slab(x, degree)


def gather_block_vector(x_local: torch.Tensor, mesh) -> torch.Tensor:
    """The inverse of shard_block_vector: the global block vector, on
    every rank."""
    return RankLayout.from_mesh(mesh).gather(x_local)


def install_level_shardings(gmg, policy, mesh):
    """This rank's distributed STMG hierarchy, built from the global
    `gmg` (which is left as it is): each level of `policy`
    (level_sharding_policy's list; None stands for "replicated") is
    either this rank's slab, applied locally and accumulated, or the
    global level itself, computed alike on every rank.  A policy of all
    "replicated" gives a GMG that computes what gmg computes.
    stmg/gmg.py::distribute_gmg has the V-cycle's rules."""
    from ..stmg.gmg import distribute_gmg
    return distribute_gmg(gmg, policy, RankLayout.from_mesh(mesh))

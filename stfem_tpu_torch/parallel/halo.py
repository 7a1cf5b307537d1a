"""Explicit domain decomposition of the dof grid (counterpart of
stfem_tpu/parallel/halo.py): the host-side split of a dof grid into the
ranks' overlapping slabs and its inverse, each rank's cell slab and
Dirichlet mask, and the sharded space-time operator apply.

A rank owns a contiguous slab of cells along each split axis plus the
dof plane it shares with a neighbour (replicated on both).  One sharded
apply is the local operator on the rank's sub-mesh, then one neighbour
exchange per sharded axis that adds the shared planes' partial sums
(comm.halo_accumulate_nd).  The time direction stays block-local.
"""
from __future__ import annotations

import numpy as np
import torch

from ..mesh.grid import StructuredMesh
from .comm import _groups, halo_accumulate_nd


def _take(x, lo: int, hi: int, axis: int):
    """x[lo:hi] along axis: a copy, on NumPy arrays or tensors."""
    if isinstance(x, torch.Tensor):
        return x.narrow(axis, lo, hi - lo).clone()
    return np.take(x, np.arange(lo, hi), axis=axis)


def split_dof_grid(x, n_shards: int, degree: int, axis: int) -> list:
    """The n_shards overlapping slabs of the dof grid x along `axis`
    ((n_cells degree + 1) dofs): slab s holds cells s cl .. (s + 1) cl - 1
    and both end planes, so neighbours share one plane."""
    n_dofs = x.shape[axis]
    n_cells = (n_dofs - 1) // degree
    if n_cells % n_shards:
        raise ValueError(f"{n_cells} cells do not split into {n_shards}")
    cl = n_cells // n_shards
    return [_take(x, s * cl * degree, (s + 1) * cl * degree + 1, axis)
            for s in range(n_shards)]


def join_dof_grid(parts, degree: int, axis: int):
    """The inverse of split_dof_grid: each shared plane once, from the
    slab on its left."""
    pieces = [parts[0]] + [_take(p, 1, p.shape[axis], axis)
                           for p in parts[1:]]
    if isinstance(parts[0], torch.Tensor):
        return torch.cat(pieces, dim=axis)
    return np.concatenate(pieces, axis=axis)


def _shards(shard, n_shards, dim: int):
    sh = (shard,) if isinstance(shard, int) else tuple(shard)
    ns = (n_shards,) if isinstance(n_shards, int) else tuple(n_shards)
    if len(sh) != len(ns) or len(ns) > dim:
        raise ValueError(f"shard {sh} of {ns} on a {dim}D mesh")
    return sh + (0,) * (dim - len(sh)), ns + (1,) * (dim - len(ns))


def local_submesh(mesh_full: StructuredMesh, shard, n_shards
                  ) -> StructuredMesh:
    """The shard's cell slab as a mesh of its own, with the full mesh's
    cell size.  shard / n_shards are ints (a split of the first axis) or
    tuples over the leading axes; the other axes stay whole."""
    dim = mesh_full.dim
    sh, ns = _shards(shard, n_shards, dim)
    cl, lo, hi = [], np.array(mesh_full.lower, float), np.array(
        mesh_full.upper, float)
    for d in range(dim):
        if mesh_full.cells[d] % ns[d]:
            raise ValueError(f"axis {d}: {mesh_full.cells[d]} cells do not "
                             f"split into {ns[d]}")
        cl.append(mesh_full.cells[d] // ns[d])
        lo[d] = mesh_full.lower[d] + sh[d] * cl[d] * mesh_full.h[d]
        hi[d] = lo[d] + cl[d] * mesh_full.h[d]
    sub = StructuredMesh(cl, lo, hi)
    sub.h = np.array(mesh_full.h, dtype=np.float64)
    return sub


def local_mask(mesh_full: StructuredMesh, degree: int, shard, n_shards):
    """The shard's slice of the global Dirichlet mask: a plane shared
    with a neighbour is interior, not eliminated."""
    sh, ns = _shards(shard, n_shards, mesh_full.dim)
    out = mesh_full.boundary_dof_mask(degree)
    for d, (s, n) in enumerate(zip(sh, ns)):
        out = split_dof_grid(out, n, degree, axis=d)[s]
    return out


def make_sharded_vmult(matrix_local, groups):
    """The sharded space-time apply on [n_blocks, *local dof grid]:
    matrix_local (a SystemMatrix of the rank's sub-mesh) applied to the
    rank's slab, then the shared planes summed across the ranks.
    groups: the process group of the sharded axis, or a tuple of them,
    one per leading spatial axis (array axis 1 + i is exchanged over
    groups[i])."""
    groups = _groups(groups)
    array_axes = tuple(range(1, 1 + len(groups)))

    def vmult(x_local: torch.Tensor) -> torch.Tensor:
        return halo_accumulate_nd(matrix_local.vmult(x_local), groups,
                                  array_axes)

    return vmult

"""The collectives of the explicit domain decomposition (counterpart of
stfem_tpu/parallel/comm.py), over torch.distributed process groups.

Each rank owns a contiguous cell slab of the spatial grid along every
sharded axis, plus the dof plane it shares with each neighbour (the
plane is replicated on both, like the reference's ghosted partitioners).
The reference's MPI traffic becomes three collectives:

  * halo_accumulate / halo_accumulate_nd: one-hop point-to-point
    exchange of the first and last dof planes, added to the neighbours'
    planes after a local operator apply (deal.II's compress(add),
    reference stmg.h:843-871);
  * psum_dot / psum_norm: an interface-weighted local sum and an
    all_reduce (MPI::sum, operators.h:1387), the weights counting each
    replicated plane once;
  * gather_metadata: an all-gather of small control data.

A sharded axis is a process group: the ranks along one dimension of a
device mesh (two_level_mesh, sharding.spatial_mesh), its group-local rank
the slab's position.  Every function raises when torch.distributed has no
process group; none falls back to an unsharded apply.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist


def _require_dist() -> None:
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("stfem_tpu_torch.parallel needs a process group: "
                           "call torch.distributed.init_process_group "
                           "first")


def _groups(groups) -> tuple:
    return tuple(groups) if isinstance(groups, (tuple, list)) else (groups,)


def halo_accumulate(y: torch.Tensor, group, array_axis: int,
                    periodic: bool = False) -> torch.Tensor:
    """y with the neighbours' partial sums of the shared planes added,
    along the one sharded axis `array_axis` of y whose ranks form `group`
    (None: the default group).  Rank i sends its first plane to rank
    i - 1 and its last to rank i + 1 and adds what it receives to its
    last and first planes; the ends have no neighbour unless `periodic`.
    With one rank it returns y."""
    _require_dist()
    n = dist.get_world_size(group)
    if n == 1:
        return y
    idx = dist.get_rank(group)
    first = y.narrow(array_axis, 0, 1).contiguous()
    last = y.narrow(array_axis, y.shape[array_axis] - 1, 1).contiguous()
    left = idx - 1 if idx > 0 or periodic else None
    right = idx + 1 if idx < n - 1 or periodic else None
    peer = (lambda i: dist.get_global_rank(group, i % n)) \
        if group is not None else (lambda i: i % n)
    from_left = torch.empty_like(last) if left is not None else None
    from_right = torch.empty_like(first) if right is not None else None
    # the sends first, then the receives, each pair in the same order on
    # both ranks (NCCL matches a pair's messages in order; gloo by tag)
    ops = []
    if left is not None:
        ops.append(dist.P2POp(dist.isend, first, peer(left), group, tag=0))
    if right is not None:
        ops.append(dist.P2POp(dist.isend, last, peer(right), group, tag=1))
    if right is not None:
        ops.append(dist.P2POp(dist.irecv, from_right, peer(right), group,
                              tag=0))
    if left is not None:
        ops.append(dist.P2POp(dist.irecv, from_left, peer(left), group,
                              tag=1))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    y = y.clone()
    if from_right is not None:
        y.narrow(array_axis, y.shape[array_axis] - 1, 1).add_(from_right)
    if from_left is not None:
        y.narrow(array_axis, 0, 1).add_(from_left)
    return y


def halo_accumulate_nd(y: torch.Tensor, groups, array_axes) -> torch.Tensor:
    """halo_accumulate along each sharded axis in turn.  A dof on an edge
    or corner (shared by up to 2^d ranks) needs no diagonal message: the
    second exchange forwards planes that the first has already summed, so
    every shared dof ends with all its owners' contributions."""
    groups, array_axes = _groups(groups), tuple(array_axes)
    if len(groups) != len(array_axes):
        raise ValueError(f"{len(groups)} groups for {len(array_axes)} axes")
    for group, ax in zip(groups, array_axes):
        y = halo_accumulate(y, group, ax)
    return y


def interface_weights(local_shape, groups, array_axes,
                      dtype=torch.float64, device="cpu") -> torch.Tensor:
    """Multiplicities of the replicated planes: 1/2 on a plane shared with
    a neighbour along each sharded axis, so that the sum over the ranks of
    w * f is the global sum of f."""
    _require_dist()
    groups, array_axes = _groups(groups), tuple(array_axes)
    w = torch.ones(tuple(local_shape), dtype=dtype, device=device)
    for group, ax in zip(groups, array_axes):
        n, idx = dist.get_world_size(group), dist.get_rank(group)
        L = int(local_shape[ax])
        wax = torch.ones(L, dtype=dtype, device=device)
        if idx > 0:
            wax[0] = 0.5
        if idx < n - 1:
            wax[L - 1] = 0.5
        shape = [1] * len(local_shape)
        shape[ax] = L
        w = w * wax.reshape(shape)
    return w


def psum_dot(a: torch.Tensor, b: torch.Tensor, groups,
             array_axes) -> torch.Tensor:
    """The global <a, b> of per-rank arrays with replicated planes: the
    weighted local sum, all-reduced over each sharded axis's group in
    turn (a sum over the product of the axes)."""
    w = interface_weights(a.shape, groups, array_axes, a.dtype, a.device)
    total = torch.sum(w * a * b)
    for group in _groups(groups):
        dist.all_reduce(total, group=group)
    return total


def psum_norm(a: torch.Tensor, groups, array_axes) -> torch.Tensor:
    return torch.sqrt(psum_dot(a, a, groups, array_axes))


def gather_metadata(x: torch.Tensor, group=None) -> torch.Tensor:
    """[n, *x.shape]: x of every rank of the group, in rank order.  For
    small control data only; dof data goes through halo_accumulate and
    psum_dot."""
    _require_dist()
    n = dist.get_world_size(group)
    out = torch.empty(n * x.numel(), dtype=x.dtype, device=x.device)
    # torch renamed the call; the older name stays where the newer is not
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, x.reshape(-1).contiguous(), group=group)
    return out.reshape((n,) + tuple(x.shape))


def two_level_mesh(n_slices: int, ici_shape, device_type: str = "cpu",
                   axis_names=("dcn", "x", "y")):
    """The nested device mesh: a leading axis across slices (hosts), the
    trailing axes within one, as a DeviceMesh of shape (n_slices,
    *ici_shape) over the world's ranks in row-major order.  A sharding
    that names only the trailing axes keeps its traffic within a slice;
    mesh.get_group(name) is the process group of an axis."""
    _require_dist()
    from torch.distributed.device_mesh import init_device_mesh

    shape = (int(n_slices),) + tuple(int(s) for s in ici_shape)
    if len(axis_names) != len(shape):
        raise ValueError(f"{len(axis_names)} names for a {len(shape)}-axis "
                         "mesh")
    need = int(np.prod(shape))
    if dist.get_world_size() != need:
        raise ValueError(f"a {shape} mesh needs {need} ranks, the world "
                         f"has {dist.get_world_size()}")
    return init_device_mesh(device_type, shape,
                            mesh_dim_names=tuple(axis_names))

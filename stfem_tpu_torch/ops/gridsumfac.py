"""Per-axis dense contraction (counterpart of
stfem_tpu/ops/gridsumfac.py::axis_apply): the level operators' Kronecker
pair, the transfers and the plain version of kernel K4 use it.  The
fused per-block chain itself (K4, pallas_grid.py) is ops/grid_chain.py,
which the Vanka runs; the GridSumFac operator route is not ported yet."""
from __future__ import annotations

import torch

__all__ = ["axis_apply", "promote"]


def promote(*ts):
    """Cast tensors to their common dtype (jnp's implicit promotion:
    e.g. bf16 factors against an f32 vector compute in f32)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t if t.dtype == dt else t.to(dt) for t in ts)


def axis_apply(M: torch.Tensor, x: torch.Tensor, axis: int):
    """Contract M (out, in) against x's `axis`, result axis in place."""
    M, x = promote(M, x)
    return torch.movedim(torch.tensordot(M, x, dims=([1], [axis])), 0, axis)

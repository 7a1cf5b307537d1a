"""K3: one banded (2k+1)-offset apply along one axis, in FP64 (counterpart
of stfem_tpu/ops/pallas_ffband.py::banded_ff_lane_apply, which computes it
in float-float along the last axis because the TPU has no FP64).

    y_i = sum_o D[o, i] x_{i+o-k}     along `axis`, off-range taps skipped,
with the diagonal storage D[o, i] = A1d[i, i+o-k] of kronfac.to_diags.

`banded_apply` launches the hand-written CUDA kernel
(csrc/banded_apply.cu) on CUDA tensors and uses `banded_apply_reference`,
the plain torch version, only for tensors on the CPU.  There is no
fallback.  The kernel reads each x from device memory once: it stages
whole rows (the contiguous axis) or short slabs (the middle axis of a
65^3 grid) in shared memory, and walks long pencils (the outer axis)
with the taps in a register window.  KronAssembled.pair sends through
it every single-output FP64 request (M x alone is three applies), every
2D pair, and the 3D pairs of degree 5, which K2 does not take.
"""
from __future__ import annotations

import torch

from .cuda_kernels import check, library
from .kron_pair import banded_axis_apply

__all__ = ["banded_apply", "banded_apply_reference", "kernel_args"]

MAX_K = 5          # half-bandwidths the kernel is compiled for (Q1-Q5)


def banded_apply_reference(x: torch.Tensor, D: torch.Tensor, axis: int,
                           k: int) -> torch.Tensor:
    """Plain torch version (kron_pair.banded_axis_apply)."""
    return banded_axis_apply(D, x, axis % x.ndim, k)


def kernel_args(x: torch.Tensor, D: torch.Tensor, axis: int, k: int):
    """Check what the kernel takes and prepare its call: (the arguments of
    stfem_banded_apply but the stream -- None for an empty x, which needs
    no launch -- and y to be filled).  Raises ValueError."""
    axis = axis % x.ndim
    if x.dtype != torch.float64 or D.dtype != torch.float64 \
            or D.device != x.device:
        raise ValueError("banded_apply: x and D must be float64 on the same "
                         "device")
    n = x.shape[axis]
    if not 0 <= k <= MAX_K:
        raise ValueError(f"banded_apply: half-bandwidth {k} (kernel takes "
                         f"0..{MAX_K})")
    if D.shape != (2 * k + 1, n):
        raise ValueError(f"banded_apply: D must be ({2 * k + 1}, {n}), got "
                         f"{tuple(D.shape)}")
    if not (x.is_contiguous() and D.is_contiguous()):
        raise ValueError("banded_apply: x and D must be contiguous")
    inner = 1
    for s in x.shape[axis + 1:]:
        inner *= s
    outer = x.numel() // (n * inner) if x.numel() else 0
    y = torch.empty_like(x)
    if outer == 0:
        return None, y
    return (x.data_ptr(), D.data_ptr(), y.data_ptr(), outer, n, inner,
            k), y


def banded_apply(x: torch.Tensor, D: torch.Tensor, axis: int,
                 k: int) -> torch.Tensor:
    """y = D x along `axis` of x; D: (2k+1, x.shape[axis])."""
    if x.device.type == "cpu":
        return banded_apply_reference(x, D, axis, k)
    if x.device.type != "cuda":
        raise ValueError(f"banded_apply: unsupported device {x.device}")
    args, y = kernel_args(x, D, axis, k)
    if args is None:
        return y
    code = library().stfem_banded_apply(
        *args, torch.cuda.current_stream(x.device).cuda_stream)
    check(code, "banded_apply")
    banded_apply.launches += 1
    return y


banded_apply.launches = 0

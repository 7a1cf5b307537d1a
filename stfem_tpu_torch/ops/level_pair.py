"""K6: the level operators' Kronecker pair (K x, M x) in bfloat16 and
float32, the low-precision route of ops/kronfac.py::KronAssembled.pair.

    M x = (M_0 (x) M_1 (x) M_2) x
    K x = sum_e (M_0 (x) .. A_e .. (x) M_2) x
over the last three axes, with banded (2k+1)-tap factors stored as float32
diagonals (`tables`: the values rounded to the level's dtype, as the dense
bf16 / float32 matrices of the plain route hold them).  Every tap is an
FP32 FMA and K x and M x are rounded once to x's dtype.  The kernel
(csrc/level_pair.cu: one fused pass, a sliding window over axis 0) applies
axis 1, then axis 2 (u = M_1 M_2 x, v = (A_1 M_2 + M_1 A_2) x), then axis
0 (M x = M_0 u, K x = A_0 u + M_0 v); `level_pair_reference` is that
arithmetic in plain torch.

`level_pair` launches the kernel on CUDA tensors (3D grids, bfloat16 or
float32, k <= 4, n2 <= 512) and computes `level_pair_reference` for
tensors on the CPU.  There is no fallback: a dtype, shape or layout the
kernel does not take raises ValueError, a failed build or launch
RuntimeError.  `supports` says which grids it takes; axis 1 is cut into
row tiles by K2's `tile_plan` (ops/kron_pair.py) at MAX_THREADS.
"""
from __future__ import annotations

import torch

from . import kron_pair
from .cuda_kernels import check, library

__all__ = ["kernel_args", "level_pair", "level_pair_reference", "supports",
           "tables"]

MAX_THREADS, MAX_K = 512, 4     # csrc/level_pair.cu's limits
SMEM_MAX = 232448               # bytes of shared memory a CTA may take
_STAGES, _PLANES = 6, 2         # csrc/level_pair.cu's kStages, kPlanes
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def tables(Dm, Da, dtype):
    """(dm, da): per-axis lists of (2k+1, n_d) diagonals -> [3, 2k+1, nmax]
    float32 each, the values rounded to dtype first, zero beyond n_d."""
    nmax = max(D.shape[1] for D in Dm)

    def stack(D):
        return torch.stack([torch.nn.functional.pad(
            Dd.to(dtype).float(), (0, nmax - Dd.shape[1])) for Dd in D])
    return stack(Dm).contiguous(), stack(Da).contiguous()


def _smem(n0: int, n2: int, tile1: int, k: int, itemsize: int) -> int:
    """Shared memory of one CTA (csrc/level_pair.cu's launch)."""
    stage = ((tile1 + 2 * k) * n2 + 4) & ~1
    return (8 * (2 * k + 1) * (n0 + 2 * k + tile1)
            + 8 * _PLANES * tile1 * (n2 + 2 * k)
            + itemsize * _STAGES * stage)


def supports(dof_shape, k: int) -> bool:
    """True when the kernel takes a 3D grid of this shape at degree k."""
    if len(dof_shape) != 3 or not 0 <= k <= MAX_K:
        return False
    n0, n1, n2 = (int(n) for n in dof_shape)
    if not 1 <= n2 <= MAX_THREADS:
        return False
    tile1 = kron_pair.tile_plan(n1, n2, MAX_THREADS)[0]
    return _smem(n0, n2, tile1, k, 4) <= SMEM_MAX


def _check(x: torch.Tensor, dm: torch.Tensor, da: torch.Tensor, k: int):
    if x.dtype not in _DTYPE_CODE:
        raise ValueError(f"level_pair: x must be bfloat16 or float32, not "
                         f"{x.dtype}")
    if not 0 <= k <= MAX_K:
        raise ValueError(f"level_pair: k = {k} beyond the kernel's {MAX_K}")
    if x.ndim < 3:
        raise ValueError("level_pair: the kernel takes 3D grids")
    n = tuple(x.shape[-3:])
    for D in (dm, da):
        if (D.dtype != torch.float32 or D.device != x.device or D.ndim != 3
                or D.shape[:2] != (3, 2 * k + 1) or D.shape[2] < max(n)
                or not D.is_contiguous()):
            raise ValueError("level_pair: the tables must be contiguous "
                             "[3, 2k+1, >= max n] float32 on x's device")
    if not x.is_contiguous():
        raise ValueError("level_pair: x must be contiguous")
    tile1 = kron_pair.tile_plan(n[1], n[2], MAX_THREADS)[0]   # n2 too wide?
    if _smem(n[0], n[2], tile1, k, x.element_size()) > SMEM_MAX:
        raise ValueError(f"level_pair: a grid of {n} exceeds the kernel's "
                         "shared memory")


def level_pair_reference(x: torch.Tensor, dm: torch.Tensor,
                         da: torch.Tensor, k: int):
    """Plain torch version of the kernel's arithmetic: float32 taps, axis
    1, then 2, then 0, one rounding to x's dtype.  Returns (K x, M x)."""
    n = x.shape[-3:]
    ax = lambda d: x.ndim - 3 + d
    tap = lambda D, v, d: kron_pair.banded_axis_apply(D[d, :, :n[d]], v,
                                                      ax(d), k)
    xf = x.float()
    p, q = tap(dm, xf, 1), tap(da, xf, 1)
    u, v = tap(dm, p, 2), tap(da, p, 2) + tap(dm, q, 2)
    return ((tap(da, u, 0) + tap(dm, v, 0)).to(x.dtype),
            tap(dm, u, 0).to(x.dtype))


def kernel_args(x: torch.Tensor, dm: torch.Tensor, da: torch.Tensor,
                k: int):
    """Check what the kernel takes and prepare its call: (the arguments of
    stfem_level_pair but the stream, (K x, M x) to be filled).  Raises
    ValueError."""
    _check(x, dm, da, k)
    n0, n1, n2 = x.shape[-3:]
    B = x.numel() // (n0 * n1 * n2)
    tile1, _, threads = kron_pair.tile_plan(n1, n2, MAX_THREADS)
    kx, mx = torch.empty_like(x), torch.empty_like(x)
    args = (_DTYPE_CODE[x.dtype], x.data_ptr(), dm.data_ptr(), da.data_ptr(),
            kx.data_ptr(), mx.data_ptr(), B, n0, n1, n2, dm.shape[2], k,
            tile1, threads)
    return args, (kx, mx)


def _launch(x: torch.Tensor, dm: torch.Tensor, da: torch.Tensor, k: int):
    """One launch of the kernel on CUDA tensors: (K x, M x)."""
    args, out = kernel_args(x, dm, da, k)
    code = library().stfem_level_pair(
        *args, torch.cuda.current_stream(x.device).cuda_stream)
    check(code, "level_pair")
    return out


def level_pair(x: torch.Tensor, dm: torch.Tensor, da: torch.Tensor, k: int):
    """(K x, M x) for x: [..., n0, n1, n2] with the tables of `tables`."""
    if x.device.type == "cpu":
        _check(x, dm, da, k)
        return level_pair_reference(x, dm, da, k)
    if x.device.type != "cuda":
        raise ValueError(f"level_pair: unsupported device {x.device}")
    out = _launch(x, dm, da, k)
    level_pair.launches += 1
    return out


level_pair.launches = 0

"""K2: the FP64 Kronecker pair (K x, M x) of the IR residual (counterpart
of stfem_tpu/ops/pallas_ffresid.py::kron_pair_ff_pallas, which computes it
in float-float because the TPU has no FP64).

    M x = (M_0 (x) M_1 (x) M_2) x
    K x = sum_e (M_0 (x) .. A_e .. (x) M_2) x
as per-axis banded (2k+1)-offset applies with the shared mass prefix of
stfem_tpu/ops/kronfac.py::KronAssembled.pair.  The factors are diagonal
storage D[o, i] = A1d[i, i+o-k] (zero off-range, kronfac._to_diags).

`kron_pair` launches the hand-written CUDA kernel (csrc/kron_pair.cu: one
fused pass over the three axes, a sliding window over axis 0) on CUDA
tensors (3D grids, float64, k <= 4, n2 <= 384) and uses
`kron_pair_reference`, the plain torch version, only for tensors on the
CPU.  There is no fallback.  `tile_plan` cuts axis 1 into the kernel's
row tiles.
"""
from __future__ import annotations

import torch

from .cuda_kernels import check, library

__all__ = ["banded_axis_apply", "kernel_args", "kron_pair",
           "kron_pair_reference", "tile_plan"]

MAX_THREADS, MAX_K = 384, 4     # csrc/kron_pair.cu's limits


def banded_axis_apply(D: torch.Tensor, x: torch.Tensor, axis: int, k: int):
    """y_i = sum_o D[o, i] x_{i+o-k} along `axis` (zero padding)."""
    nd = D.shape[1]
    pad = [0, 0] * x.ndim
    pad[2 * (x.ndim - 1 - axis)] = k
    pad[2 * (x.ndim - 1 - axis) + 1] = k
    xp = torch.nn.functional.pad(x, pad)
    dshape = [1] * x.ndim
    dshape[axis] = nd
    out = None
    for o in range(2 * k + 1):
        term = D[o].reshape(dshape) * xp.narrow(axis, o, nd)
        out = term if out is None else out + term
    return out


def kron_pair_reference(x: torch.Tensor, Dm, Da, k: int):
    """Plain torch version.  x: [..., *dofshape]; Dm, Da: per-axis lists of
    (2k+1, n_d) diagonals.  Returns (K x, M x)."""
    dim = len(Dm)
    lead = x.ndim - dim
    val, ks = x, None
    for d in range(dim):
        ax = lead + d
        a_term = banded_axis_apply(Da[d], val, ax, k)
        ks = (a_term if ks is None
              else banded_axis_apply(Dm[d], ks, ax, k) + a_term)
        val = banded_axis_apply(Dm[d], val, ax, k)
    return ks, val


def _stack_diags(D, nmax: int) -> torch.Tensor:
    return torch.stack([torch.nn.functional.pad(Dd, (0, nmax - Dd.shape[1]))
                        for Dd in D]).contiguous()


def tile_plan(n1: int, n2: int, max_threads: int = MAX_THREADS):
    """(rows of axis 1 per CTA, tiles, threads per CTA) of the kernel (and
    of K6's, ops/level_pair.py, with its max_threads): one thread per (row,
    axis-2) position, at most max_threads, the rows spread evenly over the
    tiles (the last tile may hold fewer)."""
    if not 1 <= n2 <= max_threads:
        raise ValueError(f"axis 2 of length {n2} exceeds the kernel's "
                         f"{max_threads} threads")
    n_tiles = -(-n1 // max(1, min(n1, max_threads // n2)))
    t = -(-n1 // n_tiles)
    return t, n_tiles, 32 * -(-t * n2 // 32)


def kernel_args(x: torch.Tensor, Dm, Da, k: int):
    """Check what the kernel takes and prepare its call: (the arguments of
    stfem_kron_pair but the stream, (K x, M x) to be filled, the kept-alive
    diagonal tables).  Raises ValueError."""
    if len(Dm) != 3 or len(Da) != 3 or x.ndim < 3:
        raise ValueError("kron_pair: the kernel takes 3D grids")
    if x.dtype != torch.float64 or any(
            D.dtype != torch.float64 or D.device != x.device
            for D in list(Dm) + list(Da)):
        raise ValueError("kron_pair: x and factors must be float64 on the "
                         "same device")
    if not 0 <= k <= MAX_K:
        raise ValueError(f"kron_pair: k = {k} beyond the kernel's {MAX_K}")
    n0, n1, n2 = x.shape[-3:]
    for d, n in enumerate((n0, n1, n2)):
        if Dm[d].shape != (2 * k + 1, n) or Da[d].shape != (2 * k + 1, n):
            raise ValueError("kron_pair: factor shape mismatch")
    if not x.is_contiguous():
        raise ValueError("kron_pair: x must be contiguous")
    nmax = max(n0, n1, n2)
    dm, da = _stack_diags(Dm, nmax), _stack_diags(Da, nmax)
    B = x.numel() // (n0 * n1 * n2)
    tile1, _, threads = tile_plan(n1, n2)
    kx, mx = torch.empty_like(x), torch.empty_like(x)
    args = (x.data_ptr(), dm.data_ptr(), da.data_ptr(), kx.data_ptr(),
            mx.data_ptr(), B, n0, n1, n2, nmax, k, tile1, threads)
    return args, (kx, mx), (dm, da)


def kron_pair(x: torch.Tensor, Dm, Da, k: int):
    """(K x, M x) for x: [..., n0, n1, n2]."""
    if x.device.type == "cpu":
        return kron_pair_reference(x, Dm, Da, k)
    if x.device.type != "cuda":
        raise ValueError(f"kron_pair: unsupported device {x.device}")
    args, (kx, mx), _tables = kernel_args(x, Dm, Da, k)
    code = library().stfem_kron_pair(
        *args, torch.cuda.current_stream(x.device).cuda_stream)
    check(code, "kron_pair")
    kron_pair.launches += 1
    return kx, mx


kron_pair.launches = 0

"""K2: the FP64 Kronecker pair (K x, M x) of the IR residual (counterpart
of stfem_tpu/ops/pallas_ffresid.py::kron_pair_ff_pallas, which computes it
in float-float because the TPU has no FP64).

    M x = (M_0 (x) M_1 (x) M_2) x
    K x = sum_e (M_0 (x) .. A_e .. (x) M_2) x
as per-axis banded (2k+1)-offset applies with the shared mass prefix of
stfem_tpu/ops/kronfac.py::KronAssembled.pair.  The factors are diagonal
storage D[o, i] = A1d[i, i+o-k] (zero off-range, kronfac._to_diags).

`kron_pair` launches the hand-written CUDA kernel (csrc/kron_pair.cu) on
CUDA tensors (3D grids, float64) and uses `kron_pair_reference`, the plain
torch version, only for tensors on the CPU.  There is no fallback.
"""
from __future__ import annotations

import torch

from .cuda_kernels import check, library

__all__ = ["banded_axis_apply", "kron_pair", "kron_pair_reference"]


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


def kron_pair(x: torch.Tensor, Dm, Da, k: int):
    """(K x, M x) for x: [..., n0, n1, n2]."""
    if x.device.type == "cpu":
        return kron_pair_reference(x, Dm, Da, k)
    if x.device.type != "cuda":
        raise ValueError(f"kron_pair: unsupported device {x.device}")
    if len(Dm) != 3 or len(Da) != 3 or x.ndim < 3:
        raise ValueError("kron_pair: the kernel takes 3D grids")
    if x.dtype != torch.float64 or any(
            D.dtype != torch.float64 or D.device != x.device
            for D in list(Dm) + list(Da)):
        raise ValueError("kron_pair: x and factors must be float64 on the "
                         "same device")
    n0, n1, n2 = x.shape[-3:]
    for d, n in enumerate((n0, n1, n2)):
        if Dm[d].shape != (2 * k + 1, n) or Da[d].shape != (2 * k + 1, n):
            raise ValueError("kron_pair: factor shape mismatch")
    if not x.is_contiguous():
        raise ValueError("kron_pair: x must be contiguous")
    nmax = max(n0, n1, n2)
    dm, da = _stack_diags(Dm, nmax), _stack_diags(Da, nmax)
    B = x.numel() // (n0 * n1 * n2)
    v1, k1, v2, k2 = (torch.empty_like(x) for _ in range(4))
    code = library().stfem_kron_pair(
        x.data_ptr(), dm.data_ptr(), da.data_ptr(), v1.data_ptr(),
        k1.data_ptr(), v2.data_ptr(), k2.data_ptr(), B, n0, n1, n2, nmax, k,
        torch.cuda.current_stream(x.device).cuda_stream)
    check(code, "kron_pair")
    kron_pair.launches += 1
    return k1, v1


kron_pair.launches = 0

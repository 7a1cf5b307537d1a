"""K1: the Vanka grid-mode multi-step time solve (counterpart of
stfem_tpu/ops/pallas_timesolve.py::time_solve_pallas).

For every flattened eigen-position n the block-bidiagonal multi-step solve
    y_s = Ginv w_s;   out_s = y_s + last_{s-1} cvec;
    last_s = y_s[-1] + kappa last_{s-1},   kappa = cvec[-1]
is elementwise over n with tiny per-step (nt x nt) f32 factors.

`time_solve` launches the hand-written CUDA kernel (csrc/time_solve.cu) on
CUDA tensors and uses `time_solve_reference`, the plain torch version, only
for tensors on the CPU.  There is no fallback: a CUDA tensor that the
kernel does not take, or a failed build or launch, raises.
"""
from __future__ import annotations

import torch

from .cuda_kernels import check, library

__all__ = ["kernel_args", "time_solve", "time_solve_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_NT = 5          # time dofs per step the kernel is compiled for


def time_solve_reference(w, GinvT, cvecT, S: int, nt: int, out_dtype):
    """Plain torch version (a loop over the S steps); arithmetic in the
    promoted dtype of w and the factors, as stfem_tpu's XLA form."""
    N = w.shape[-1]
    dt = torch.promote_types(w.dtype, GinvT.dtype)
    ws = w.reshape(S, nt, N).to(dt)
    G, c = GinvT.to(dt), cvecT.to(dt)
    y = torch.stack([sum(G[i, j] * ws[:, j] for j in range(nt))
                     for i in range(nt)], dim=1)              # (S, nt, N)
    out = torch.empty_like(y)
    prev = torch.zeros_like(y[0, 0])
    for s in range(S):
        out[s] = y[s] + prev[None] * c
        prev = y[s, nt - 1] + c[nt - 1] * prev
    return out.reshape(S * nt, N).to(out_dtype)


def kernel_args(w: torch.Tensor, GinvT: torch.Tensor, cvecT: torch.Tensor,
                S: int, nt: int, out_dtype):
    """Check what the kernel takes and prepare its call: (the arguments of
    stfem_time_solve but the stream, the output to be filled).  Raises
    ValueError."""
    N = w.shape[-1]
    if w.dtype not in _DTYPE_CODE or out_dtype != w.dtype:
        raise ValueError(f"time_solve: w dtype {w.dtype} / out dtype "
                         f"{out_dtype} (kernel takes f32 or bf16, equal)")
    if not 1 <= nt <= MAX_NT:
        raise ValueError(f"time_solve: nt = {nt} (kernel takes 1..{MAX_NT})")
    if (w.shape != (S * nt, N) or GinvT.shape != (nt, nt, N)
            or cvecT.shape != (nt, N)):
        raise ValueError("time_solve: shape mismatch")
    if GinvT.dtype != torch.float32 or cvecT.dtype != torch.float32:
        raise ValueError("time_solve: factors must be float32")
    if GinvT.device != w.device or cvecT.device != w.device:
        raise ValueError("time_solve: tensors on different devices")
    if not (w.is_contiguous() and GinvT.is_contiguous()
            and cvecT.is_contiguous()):
        raise ValueError("time_solve: tensors must be contiguous")
    out = torch.empty_like(w)
    return (w.data_ptr(), GinvT.data_ptr(), cvecT.data_ptr(), out.data_ptr(),
            S, nt, N, _DTYPE_CODE[w.dtype]), out


def time_solve(w: torch.Tensor, GinvT: torch.Tensor, cvecT: torch.Tensor,
               S: int, nt: int, out_dtype) -> torch.Tensor:
    """w: (S*nt, N) -> (S*nt, N) in out_dtype.  GinvT: (nt, nt, N) f32,
    cvecT: (nt, N) f32."""
    if w.device.type == "cpu":
        return time_solve_reference(w, GinvT, cvecT, S, nt, out_dtype)
    if w.device.type != "cuda":
        raise ValueError(f"time_solve: unsupported device {w.device}")
    args, out = kernel_args(w, GinvT, cvecT, S, nt, out_dtype)
    code = library().stfem_time_solve(
        *args, torch.cuda.current_stream(w.device).cuda_stream)
    check(code, "time_solve")
    time_solve.launches += 1
    return out


time_solve.launches = 0

"""K5: the full-cell-basis quadrature middle of the slab operator
(counterpart of stfem_tpu/ops/pallas_kernels.py::fused_quad_middle).

Between cell_gather and cell_scatter the slab operator, for every
destination block t and cell c, computes
    qv = ub[t,c,:] @ Phi          qg = ua[t,c,:] @ Grad
    y[t,c,:] = (qv * Wv[c]) @ Phi^T + (qg * Wg[c]) @ Grad^T
with PhiG = [Phi | Grad_0 | .. | Grad_{d-1}] (A, (1+d)Q) the basis values
and reference gradients at the quadrature points and W (C, (1+d)Q) the
weights (jxw, coefficient and inverse-Jacobian squares folded in).  The
Alpha/Beta block mixing (ua = Alpha u, ub = Beta u) runs before it, as one
dense matmul over the block axis (SystemMatrix._mix), as in stfem_tpu.

`quad_middle` launches the hand-written CUDA kernel (csrc/quad_middle.cu)
on CUDA tensors and uses `quad_middle_reference`, the plain torch version,
only for tensors on the CPU.  There is no fallback: a CUDA tensor that the
kernel does not take, or a failed build or launch, raises.
"""
from __future__ import annotations

import torch

from .cuda_kernels import check, library

__all__ = ["quad_middle", "quad_middle_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.float64: 1}
MAX_NQ = 1024      # (1+dim) Q columns the kernel's shared tile holds


def quad_middle_reference(ub, ua, PhiG, W, n_q_pts: int):
    """Plain torch version (stfem_tpu's _middle_reference after its
    premix)."""
    Q = n_q_pts
    qv = torch.einsum("tca,aq->tcq", ub, PhiG[:, :Q])
    qg = torch.einsum("tca,aq->tcq", ua, PhiG[:, Q:])
    yv = torch.einsum("tcq,aq->tca", qv * W[None, :, :Q], PhiG[:, :Q])
    yg = torch.einsum("tcq,aq->tca", qg * W[None, :, Q:], PhiG[:, Q:])
    return yv + yg


def quad_middle(ub: torch.Tensor, ua: torch.Tensor, PhiG: torch.Tensor,
                W: torch.Tensor, n_q_pts: int,
                PhiGT: torch.Tensor | None = None) -> torch.Tensor:
    """ub, ua: (T, C, A) premixed cell-local blocks -> (T, C, A).  PhiG:
    (A, NQ), W: (C, NQ) with NQ = (1+dim) n_q_pts; PhiGT, PhiG's
    contiguous transpose, may be passed to save its copy."""
    if ub.device.type == "cpu":
        return quad_middle_reference(ub, ua, PhiG, W, n_q_pts)
    if ub.device.type != "cuda":
        raise ValueError(f"quad_middle: unsupported device {ub.device}")
    T, C, A = ub.shape
    NQ = PhiG.shape[1]
    if ub.dtype not in _DTYPE_CODE:
        raise ValueError(f"quad_middle: dtype {ub.dtype} (kernel takes f32 "
                         "or f64)")
    if PhiGT is None:
        PhiGT = PhiG.t().contiguous()
    ts = (ub, ua, PhiG, PhiGT, W)
    if any(t.dtype != ub.dtype or t.device != ub.device for t in ts):
        raise ValueError("quad_middle: tensors differ in dtype or device")
    if (ua.shape != (T, C, A) or PhiG.shape != (A, NQ)
            or PhiGT.shape != (NQ, A) or W.shape != (C, NQ)
            or NQ <= n_q_pts or (NQ - n_q_pts) % n_q_pts
            or NQ > MAX_NQ or A > MAX_NQ):
        raise ValueError("quad_middle: shape mismatch")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("quad_middle: tensors must be contiguous")
    out = torch.empty_like(ub)
    code = library().stfem_quad_middle(
        ub.data_ptr(), ua.data_ptr(), PhiG.data_ptr(), PhiGT.data_ptr(),
        W.data_ptr(), out.data_ptr(), T, C, A, n_q_pts, NQ,
        _DTYPE_CODE[ub.dtype], torch.cuda.current_stream(ub.device).cuda_stream)
    check(code, "quad_middle")
    quad_middle.launches += 1
    return out


quad_middle.launches = 0

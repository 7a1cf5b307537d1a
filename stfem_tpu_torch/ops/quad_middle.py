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

In FP64 the kernel runs both products on the tensor cores over tiles of
64 (block, cell) rows (`tile_plan`), streaming PhiG in chunks of 32
quadrature columns; `pad_tables` gives it PhiG and W zero-padded so that
A is a multiple of 16 and the value and gradient column groups are
multiples of 32 (at the Q3 shape, A=64, Q=64, NQ=256, nothing is padded
and nothing is copied).  float32 runs on the CUDA cores.
"""
from __future__ import annotations

import torch

from .cuda_kernels import check, library

__all__ = ["quad_middle", "quad_middle_reference", "pad_tables",
           "tile_plan"]

TILE_ROWS = 64     # (block, cell) rows of an FP64 tile
CHUNK = 32         # quadrature columns per streamed PhiG chunk
MAX_A = 128        # FP64: dofs per cell the register tile holds
MAX_NQ = 1024      # float32: (1+dim) Q columns the shared tile holds


def quad_middle_reference(ub, ua, PhiG, W, n_q_pts: int):
    """Plain torch version (stfem_tpu's _middle_reference after its
    premix)."""
    Q = n_q_pts
    qv = torch.einsum("tca,aq->tcq", ub, PhiG[:, :Q])
    qg = torch.einsum("tca,aq->tcq", ua, PhiG[:, Q:])
    yv = torch.einsum("tcq,aq->tca", qv * W[None, :, :Q], PhiG[:, :Q])
    yg = torch.einsum("tcq,aq->tca", qg * W[None, :, Q:], PhiG[:, Q:])
    return yv + yg


def tile_plan(T: int, C: int) -> tuple[int, int]:
    """(tt, cc): an FP64 tile holds tt blocks x cc cells, tt cc <= 64.
    T is cut into the fewest chunks of at most 8 blocks (T=24 -> 8 x 8
    cells, T=3 -> 3 x 21).  Thread block (bx, by) owns tile row r < tt cc
    = (t, c) = (by tt + r // cc, bx cc + r % cc) where t < T and c < C;
    the grid is (ceil(C / cc), ceil(T / tt)).  Each W row serves the
    tile's tt blocks."""
    chunks = -(-T // 8)
    tt = -(-T // chunks)
    return tt, min(TILE_ROWS // tt, C)


def pad_tables(PhiG: torch.Tensor, W: torch.Tensor, n_q_pts: int):
    """(P, Wp, qp): PhiG and W with zero rows and columns so that A is a
    multiple of 16 and the value columns (qp = Q rounded up to 32) and
    the gradient columns each fill whole chunks; the tables themselves
    where nothing needs padding."""
    A, NQ = PhiG.shape
    Q = n_q_pts
    up = lambda n, m: -(-n // m) * m
    ap, qp, gp = up(A, 16), up(Q, CHUNK), up(NQ - Q, CHUNK)
    if (ap, qp, gp) == (A, Q, NQ - Q):
        return PhiG, W, Q
    P = PhiG.new_zeros((ap, qp + gp))
    P[:A, :Q] = PhiG[:, :Q]
    P[:A, qp:qp + NQ - Q] = PhiG[:, Q:]
    Wp = W.new_zeros((W.shape[0], qp + gp))
    Wp[:, :Q] = W[:, :Q]
    Wp[:, qp:qp + NQ - Q] = W[:, Q:]
    return P, Wp, qp


def quad_middle(ub: torch.Tensor, ua: torch.Tensor, PhiG: torch.Tensor,
                W: torch.Tensor, n_q_pts: int,
                PhiGT: torch.Tensor | None = None) -> torch.Tensor:
    """ub, ua: (T, C, A) premixed cell-local blocks -> (T, C, A).  PhiG:
    (A, NQ), W: (C, NQ) with NQ = (1+dim) n_q_pts; PhiGT, PhiG's
    contiguous transpose, may be passed to save its copy (float32 reads
    it; FP64 reads PhiG both ways)."""
    if ub.device.type == "cpu":
        return quad_middle_reference(ub, ua, PhiG, W, n_q_pts)
    if ub.device.type != "cuda":
        raise ValueError(f"quad_middle: unsupported device {ub.device}")
    T, C, A = ub.shape
    NQ = PhiG.shape[1]
    if ub.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"quad_middle: dtype {ub.dtype} (kernel takes f32 "
                         "or f64)")
    f64 = ub.dtype == torch.float64
    if PhiGT is None and not f64:
        PhiGT = PhiG.t().contiguous()
    ts = (ub, ua, PhiG, W) + (() if PhiGT is None else (PhiGT,))
    if any(t.dtype != ub.dtype or t.device != ub.device for t in ts):
        raise ValueError("quad_middle: tensors differ in dtype or device")
    if (ua.shape != (T, C, A) or PhiG.shape != (A, NQ)
            or (PhiGT is not None and PhiGT.shape != (NQ, A))
            or W.shape != (C, NQ) or NQ <= n_q_pts
            or (NQ - n_q_pts) % n_q_pts
            or (A > MAX_A if f64 else (NQ > MAX_NQ or A > MAX_NQ))):
        raise ValueError("quad_middle: shape mismatch")
    if not all(t.is_contiguous() for t in ts):
        raise ValueError("quad_middle: tensors must be contiguous")
    out = torch.empty_like(ub)
    stream = torch.cuda.current_stream(ub.device).cuda_stream
    if f64:
        P, Wp, qp = pad_tables(PhiG, W, n_q_pts)
        # cp.async and the paired W loads move 16-byte words
        P, Wp = (t if t.data_ptr() % 16 == 0 else t.clone() for t in (P, Wp))
        tt, cc = tile_plan(T, C)
        code = library().stfem_quad_middle_f64(
            ub.data_ptr(), ua.data_ptr(), P.data_ptr(), Wp.data_ptr(),
            out.data_ptr(), T, C, A, P.shape[0], qp, P.shape[1], tt, cc,
            stream)
    else:
        code = library().stfem_quad_middle_f32(
            ub.data_ptr(), ua.data_ptr(), PhiG.data_ptr(), PhiGT.data_ptr(),
            W.data_ptr(), out.data_ptr(), T, C, A, n_q_pts, NQ, stream)
    check(code, "quad_middle")
    quad_middle.launches += 1
    return out


quad_middle.launches = 0

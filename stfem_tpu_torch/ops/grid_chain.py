"""K4: the fused per-block grid chain of the grid-mode Vanka down/up
(counterpart of stfem_tpu/ops/pallas_grid.py::chain_down / chain_up).

For every leading block b,
    y[b] = (M_0 (x) M_1 (x) ... (x) M_{dim-1}) x[b],
with mats[d] of shape (out_d, in_d): (q_d, n_d) for the down chain (dof
grid -> eigen positions), (n_d, q_d) for the up chain.  The sums run in
float32 (float64 for float64 data) from bf16/f32 data and matrices, and
the result is rounded once to the output dtype, as the TPU kernel does.
Both chains keep the natural axis order (q_0, q_1, ...): the rotated order
of stfem_tpu's chain_down (pallas_grid.chain_down_order) is a Mosaic
artifact that the port does not carry.

`chain_down` / `chain_up` launch the hand-written CUDA kernel
(csrc/grid_chain.cu; dim 3, and dim 2 as a leading axis of size 1) on CUDA
tensors and use the plain torch version only for tensors on the CPU.
There is no fallback: a CUDA tensor that the kernel does not take, or a
failed build or launch, raises.
"""
from __future__ import annotations

import torch

from .cuda_kernels import check, library
from .gridsumfac import axis_apply

__all__ = ["chain_down", "chain_up", "chain_down_reference",
           "chain_up_reference"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}


def _acc(dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def chain_reference(x: torch.Tensor, mats, out_dtype=None) -> torch.Tensor:
    """Plain torch version: the per-axis tensordot chain in the
    accumulation dtype, one cast at the end."""
    acc = _acc(x.dtype)
    t = x.to(acc)
    for d, m in enumerate(mats):
        t = axis_apply(m.to(acc), t, 1 + d)
    return t.to(out_dtype or x.dtype)


chain_down_reference = chain_up_reference = chain_reference


def _launch(x: torch.Tensor, mats, out_dtype, name: str) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    dim = len(mats)
    if dim not in (2, 3) or x.ndim != dim + 1:
        raise ValueError(f"{name}: the kernel takes x of shape (nb, n_0.."
                         f"n_{{dim-1}}) with dim 2 or 3, got {tuple(x.shape)}"
                         f" and {dim} matrices")
    mdt = mats[0].dtype
    if any(m.dtype != mdt or m.device != x.device or m.ndim != 2
           for m in mats):
        raise ValueError(f"{name}: the matrices must be 2D, of one dtype, "
                         "on x's device")
    wide = x.dtype == torch.float64
    if (x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE
            or mdt not in _DTYPE_CODE
            or wide != (mdt == torch.float64)
            or wide != (out_dtype == torch.float64)):
        raise ValueError(f"{name}: dtypes x {x.dtype}, matrices {mdt}, out "
                         f"{out_dtype} (bf16/f32 data and matrices, or all "
                         "f64)")
    if any(m.shape[1] != n for m, n in zip(mats, x.shape[1:])):
        shapes = [tuple(m.shape) for m in mats]
        raise ValueError(f"{name}: matrix shapes {shapes} do not match x "
                         f"{tuple(x.shape)}")
    mats = [m.contiguous() for m in mats]
    if dim == 2:
        x = x.unsqueeze(1)
        mats = [torch.ones((1, 1), dtype=mdt, device=x.device)] + mats
    x = x.contiguous()
    nb = x.shape[0]
    n = tuple(x.shape[1:])
    q = tuple(m.shape[0] for m in mats)
    # a plane beyond an SM's shared memory makes the launcher return an
    # error, which check() raises
    t = torch.empty((nb, n[0], q[1], q[2]), dtype=_acc(x.dtype),
                    device=x.device)
    y = torch.empty((nb,) + q, dtype=out_dtype, device=x.device)
    code = library().stfem_grid_chain(
        x.data_ptr(), mats[0].data_ptr(), mats[1].data_ptr(),
        mats[2].data_ptr(), t.data_ptr(), y.data_ptr(), nb, *n, *q,
        _DTYPE_CODE[x.dtype], _DTYPE_CODE[mdt], _DTYPE_CODE[out_dtype],
        torch.cuda.current_stream(x.device).cuda_stream)
    check(code, name)
    return y[:, 0] if dim == 2 else y


def chain_down(x: torch.Tensor, mats, out_dtype=None) -> torch.Tensor:
    """x: (nb, n_0, .., n_{dim-1}); mats[d]: (q_d, n_d) ->
    (nb, q_0, .., q_{dim-1}) in out_dtype (default x.dtype)."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return chain_reference(x, mats, out_dtype)
    y = _launch(x, mats, out_dtype, "chain_down")
    chain_down.launches += 1
    return y


def chain_up(w: torch.Tensor, mats, out_dtype=None) -> torch.Tensor:
    """w: (nb, q_0, .., q_{dim-1}); mats[d]: (n_d, q_d) ->
    (nb, n_0, .., n_{dim-1}) in out_dtype (default w.dtype)."""
    out_dtype = out_dtype or w.dtype
    if w.device.type == "cpu":
        return chain_reference(w, mats, out_dtype)
    y = _launch(w, mats, out_dtype, "chain_up")
    chain_up.launches += 1
    return y


chain_down.launches = 0
chain_up.launches = 0

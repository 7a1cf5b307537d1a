"""Full-precision matmul guard (the counterpart of stfem_tpu's
`jax.default_matmul_precision("highest")` around the outer operator).

On Hopper a float32 matmul may run in TF32 (about three decimal digits)
when `torch.backends.cuda.matmul.allow_tf32` is set; the outer operator,
the rhs coupling and the residual must never do so.  `full_precision()`
switches TF32 off for the duration of the block and restores the caller's
settings afterwards.
"""
from __future__ import annotations

import contextlib

import torch


@contextlib.contextmanager
def full_precision():
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = saved[0]
        torch.backends.cudnn.allow_tf32 = saved[1]
        torch.set_float32_matmul_precision(saved[2])

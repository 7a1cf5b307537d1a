"""Heat and acoustic-wave manufactured solutions and right-hand sides
(counterpart of stfem_tpu/problems/heat.py; reference
include/exact_solution.h).  The wave's u is exact_solution itself
(stfem_tpu has no separate wave u).

`t` may be a float or a tensor that broadcasts against pts[..., 0] (one
time per leading block for the batched force assembly)."""
from __future__ import annotations

import numpy as np
import torch

PI = np.pi


def _sin(x):
    return torch.sin(x) if torch.is_tensor(x) else float(np.sin(x))


def _cos(x):
    return torch.cos(x) if torch.is_tensor(x) else float(np.cos(x))


def exact_solution(pts, t, f=1.0):
    """u = sin(2 pi f t) prod_i sin(2 pi f x_i)."""
    v = _sin(2 * PI * f * t)
    for i in range(pts.shape[-1]):
        v = v * torch.sin(2 * PI * f * pts[..., i])
    return v


def rhs(pts, t, f=1.0):
    dim = pts.shape[-1]
    v = (dim * 4 * PI ** 2 * f ** 2 * _sin(2 * PI * f * t)
         + 2 * PI * f * _cos(2 * PI * f * t))
    for i in range(dim):
        v = v * torch.sin(2 * PI * f * pts[..., i])
    return v


# -- acoustic wave ----------------------------------------------------------
def wave_exact_v(pts, t, f=1.0):
    """v = du/dt."""
    v = 2 * PI * f * _cos(2 * PI * f * t)
    for i in range(pts.shape[-1]):
        v = v * torch.sin(2 * PI * f * pts[..., i])
    return v


def wave_rhs(pts, t, f=1.0):
    dim = pts.shape[-1]
    v = 2.0 ** dim * (PI * f) ** 2 * _sin(2 * PI * f * t)
    for i in range(dim):
        v = v * torch.sin(2 * PI * f * pts[..., i])
    return v

"""The Stokes manufactured solution (2D, trigonometric, divergence-free)
and its momentum right-hand side (counterpart of
stfem_tpu/problems/stokes.py; reference include/exact_solution.h:
199-325).

pts is a float64 tensor [..., 2] on any device; `t` a float or a tensor
that broadcasts against pts[..., 0] (one time per leading block for the
batched error and force evaluation)."""
from __future__ import annotations

import numpy as np
import torch

PI = np.pi


def _trig(t):
    if torch.is_tensor(t):
        return torch.sin(t), torch.cos(t)
    return float(np.sin(t)), float(np.cos(t))


def exact_u(pts, t):
    """[..., 2] velocity."""
    x, y = pts[..., 0], pts[..., 1]
    st = _trig(t)[0]
    sx, sy = torch.sin(PI * x), torch.sin(PI * y)
    cx, cy = torch.cos(PI * x), torch.cos(PI * y)
    u0 = cy * st * sx * sx * sy
    u1 = -cx * st * sx * sy * sy
    return torch.stack([u0, u1], dim=-1)


def exact_grad_u(pts, t):
    """[..., 2, 2]: grad_u[..., c, d] = d u_c / d x_d."""
    x, y = pts[..., 0], pts[..., 1]
    sx, sy = torch.sin(PI * x), torch.sin(PI * y)
    cx, cy = torch.cos(PI * x), torch.cos(PI * y)
    Pst = PI * _trig(t)[0]
    g00 = 2 * Pst * cx * sx * cy * sy
    g01 = Pst * (sx * sx * cy * cy - sx * sx * sy * sy)
    g10 = Pst * (sx * sx - cx * cx) * sy * sy
    g11 = -2 * Pst * cx * sx * cy * sy
    return torch.stack([torch.stack([g00, g01], dim=-1),
                        torch.stack([g10, g11], dim=-1)], dim=-2)


def exact_p(pts, t):
    x, y = pts[..., 0], pts[..., 1]
    return (torch.cos(PI * x) * torch.cos(PI * y) * _trig(t)[0]
            * torch.sin(PI * x) * torch.sin(PI * y))


def exact_grad_p(pts, t):
    x, y = pts[..., 0], pts[..., 1]
    sx, sy = torch.sin(PI * x), torch.sin(PI * y)
    cx, cy = torch.cos(PI * x), torch.cos(PI * y)
    Pst = PI * _trig(t)[0]
    g0 = Pst * (cx * cx - sx * sx) * cy * sy
    g1 = Pst * (cy * cy - sy * sy) * cx * sx
    return torch.stack([g0, g1], dim=-1)


def rhs_u(pts, t, viscosity=1.0, navier=False):
    """[..., 2] momentum right-hand side; navier adds the convection
    term's contribution (u . grad) u."""
    x, y = pts[..., 0], pts[..., 1]
    nu = viscosity
    nl = 1.0 if navier else 0.0
    st, ct = _trig(t)
    sx, sy = torch.sin(PI * x), torch.sin(PI * y)
    cx, cy = torch.cos(PI * x), torch.cos(PI * y)
    f0 = sy * (PI * (1.0 - 2.0 * PI * nu) * cx * cx * cy * st
               + cy * (ct + PI * (-1.0 + 6.0 * PI * nu) * st) * sx * sx
               + nl * PI * cx * st * st * sx * sx * sx * sy)
    f1 = sx * (nl * PI * cy * st * st * sx * sy * sy * sy
               + cx * (PI * (-2.0 * PI * nu
                             + (1.0 + 4.0 * PI * nu)
                             * torch.cos(2.0 * PI * y))
                       * st - ct * sy * sy))
    return torch.stack([f0, f1], dim=-1)

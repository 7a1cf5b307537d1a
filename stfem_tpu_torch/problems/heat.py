"""Heat and acoustic-wave manufactured solutions and right-hand sides,
and the practical mode's C-infinity bump (counterpart of
stfem_tpu/problems/heat.py; reference include/exact_solution.h).  The
wave's u is exact_solution itself (stfem_tpu has no separate wave u).

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


def exact_gradient(pts, t, f=1.0):
    """grad u, shape [..., dim]."""
    dim = pts.shape[-1]
    tv = 2 * PI * f * _sin(2 * PI * f * t)
    comps = []
    for i in range(dim):
        g = tv
        for j in range(dim):
            trig = torch.cos if i == j else torch.sin
            g = g * trig(2 * PI * f * pts[..., j])
        comps.append(g)
    return torch.stack(comps, dim=-1)


def rhs(pts, t, f=1.0):
    dim = pts.shape[-1]
    v = (dim * 4 * PI ** 2 * f ** 2 * _sin(2 * PI * f * t)
         + 2 * PI * f * _cos(2 * PI * f * t))
    for i in range(dim):
        v = v * torch.sin(2 * PI * f * pts[..., i])
    return v


def cutoff_cinfty(pts: torch.Tensor, center, radius: float = 1e-2,
                  integrate_to_one: bool = True) -> torch.Tensor:
    """C-infinity cutoff bump (deal.II Functions::CutOffFunctionCinfty):
    e * exp(-r^2/(r^2 - d^2)) inside the ball of `radius` around `center`,
    zero outside; the practical configs' initial value (reference
    tests/tp_01.cc:376-380), with unit integral by default."""
    center = torch.as_tensor(center, dtype=pts.dtype, device=pts.device)
    d2 = torch.sum((pts - center) ** 2, dim=-1)
    r2 = radius * radius
    inside = d2 < r2
    # guard the pole: clamp the exponent like deal.II's e < -50 cutoff
    denom = torch.where(inside, r2 - d2, torch.ones_like(d2))
    e = torch.where(inside, -r2 / denom, torch.full_like(d2, -np.inf))
    v = torch.where(e < -50.0, torch.zeros_like(d2),
                    np.e * torch.exp(torch.clamp(e, min=-50.0)))
    if integrate_to_one:
        v = v / _cinfty_unit_integral(pts.shape[-1], radius)
    return v


def _cinfty_unit_integral(dim: int, radius: float) -> float:
    """Integral over R^dim of the unnormalized bump of `radius`:
    surface(dim) * int_0^R e * exp(-R^2/(R^2-s^2)) s^(dim-1) ds, by the
    trapezoid rule on 20,000 radial intervals."""
    s = np.linspace(0.0, 1.0, 20001)[:-1]
    f = np.e * np.exp(-1.0 / np.maximum(1.0 - s * s, 1e-300)) \
        * s ** (dim - 1)
    # the trapezoid rule as numpy.trapezoid writes it (older NumPy lacks
    # that name)
    radial = float((np.diff(s) * (f[1:] + f[:-1]) / 2.0).sum())
    surface = {1: 2.0, 2: 2.0 * np.pi, 3: 4.0 * np.pi}[dim]
    return float(surface * radial * radius ** dim)


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

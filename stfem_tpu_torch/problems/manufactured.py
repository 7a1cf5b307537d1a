"""Symbolically derived manufactured solutions (counterpart of
stfem_tpu/problems/manufactured.py): heat "solution 2" and the
"stokespoly" polynomial Stokes flow (reference exact_solution.h:87-144,
328-501).  The right-hand sides are derived from the exact solutions
with sympy and lambdified to torch functions, the same expressions as
stfem_tpu's.

Every function takes points [..., dim] (a float tensor) and a time t (a
float, or a tensor that broadcasts against pts[..., 0]) and returns a
tensor of their broadcast shape (with a trailing component axis where
the quantity is a vector).  An expression that is constant in space is
broadcast to that shape too."""
from __future__ import annotations

from functools import lru_cache

import sympy as sp
import torch


def _pow(a, b):
    """a ** b for the printer's pow(): a tensor to a whole power by
    squaring and multiplying, in the order of XLA's integer_pow (which
    stfem_tpu's lambdified ** runs), else Python's ** (torch.pow rejects
    two numbers, e.g. the printer's pow(pi, 2))."""
    if not (torch.is_tensor(a) and isinstance(b, int) and b > 0):
        return a ** b
    acc = None
    while b:
        if b & 1:
            acc = a if acc is None else acc * a
        b >>= 1
        if b:
            a = a * a
    return acc


def _lambdify(args, expr):
    """A torch function of the tensors `args` whose value has their
    broadcast shape, also where expr does not depend on all of them."""
    fn = sp.lambdify(args, expr, modules=[{"pow": _pow}, "torch"])

    def call(*vals):
        out = fn(*vals)
        shape = torch.broadcast_shapes(*(v.shape for v in vals))
        if not torch.is_tensor(out):
            out = torch.as_tensor(out, dtype=vals[0].dtype,
                                  device=vals[0].device)
        return torch.broadcast_to(out, shape)

    return call


def _args(pts, tt):
    """The coordinate tensors of pts and t as a tensor on their device
    (torch's functions reject a Python float)."""
    t = torch.as_tensor(tt, dtype=pts.dtype, device=pts.device)
    return [pts[..., d] for d in range(pts.shape[-1])], t


@lru_cache(maxsize=None)
def heat2(dim: int = 2):
    """Heat "solution 2": u = sin(2 pi x) sin(2 pi y) [sin(2 pi z)]
    (1 + sin(pi t)) exp(-t/2) and its derived rhs f = u_t - lap u
    (reference ExactSolution2 / RHSFunction2).  Returns (exact,
    exact_grad, rhs)."""
    t = sp.Symbol("t")
    xs = sp.symbols(f"x0:{dim}")
    u = (1 + sp.sin(sp.pi * t)) * sp.exp(-t / 2)
    for x in xs:
        u *= sp.sin(2 * sp.pi * x)
    f = sp.diff(u, t) - sum(sp.diff(u, x, 2) for x in xs)
    u_fn = _lambdify((*xs, t), sp.simplify(u))
    f_fn = _lambdify((*xs, t), sp.simplify(f))
    g_fns = [_lambdify((*xs, t), sp.simplify(sp.diff(u, x))) for x in xs]

    def exact(pts, tt):
        X, T = _args(pts, tt)
        return u_fn(*X, T)

    def rhs(pts, tt):
        X, T = _args(pts, tt)
        return f_fn(*X, T)

    def exact_grad(pts, tt):
        X, T = _args(pts, tt)
        return torch.stack([g(*X, T) for g in g_fns], dim=-1)

    return exact, exact_grad, rhs


@lru_cache(maxsize=None)
def stokes_poly(viscosity: float = 1.0):
    """The "stokespoly" polynomial Stokes solution (2D): a divergence-free
    polynomial velocity and a zero-mean polynomial pressure, the rhs
    derived as f = u_t - nu lap u + grad p (reference
    stokespoly::ExactSolution* / RHSFunction).  Returns dict(exact_u,
    exact_grad_u, exact_p, exact_grad_p, rhs_u)."""
    t, x, y = sp.symbols("t x y")
    nu = sp.Float(viscosity)
    u0 = 1000 * t * x ** 2 * (1 - x) ** 4 * y ** 2 * (1 - y) * (3 - 5 * y)
    u1 = (1000 * t * (-2) * x * (1 - x) ** 3 * (1 - 3 * x) * y ** 3
          * (1 - y) ** 2)
    p = t * (-16 * x * (1 - x) * y * (1 - y) + sp.Rational(4, 9))
    assert sp.simplify(sp.diff(u0, x) + sp.diff(u1, y)) == 0
    f0 = sp.diff(u0, t) - nu * (sp.diff(u0, x, 2) + sp.diff(u0, y, 2)) \
        + sp.diff(p, x)
    f1 = sp.diff(u1, t) - nu * (sp.diff(u1, x, 2) + sp.diff(u1, y, 2)) \
        + sp.diff(p, y)
    fns = {name: _lambdify((x, y, t), sp.expand(e)) for name, e in (
        ("u0", u0), ("u1", u1), ("p", p), ("f0", f0), ("f1", f1),
        ("du0x", sp.diff(u0, x)), ("du0y", sp.diff(u0, y)),
        ("du1x", sp.diff(u1, x)), ("du1y", sp.diff(u1, y)),
        ("dpx", sp.diff(p, x)), ("dpy", sp.diff(p, y)))}

    def ev(pts, tt, *names):
        (X, Y), T = _args(pts, tt)
        return [fns[n](X, Y, T) for n in names]

    def exact_u(pts, tt):
        return torch.stack(ev(pts, tt, "u0", "u1"), dim=-1)

    def exact_grad_u(pts, tt):
        a, b, c, d = ev(pts, tt, "du0x", "du0y", "du1x", "du1y")
        return torch.stack([torch.stack([a, b], -1),
                            torch.stack([c, d], -1)], dim=-2)

    def exact_p(pts, tt):
        return ev(pts, tt, "p")[0]

    def exact_grad_p(pts, tt):
        return torch.stack(ev(pts, tt, "dpx", "dpy"), dim=-1)

    def rhs_u(pts, tt, viscosity=None, navier=False):
        return torch.stack(ev(pts, tt, "f0", "f1"), dim=-1)

    return dict(exact_u=exact_u, exact_grad_u=exact_grad_u, exact_p=exact_p,
                exact_grad_p=exact_grad_p, rhs_u=rhs_u)

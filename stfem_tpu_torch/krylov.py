"""Outer solvers (counterpart of stfem_tpu/krylov.py): preconditioned
Richardson, flexible GMRES and the error-propagator radius estimate.

Convergence semantics follow deal.II's ReductionControl: stop when
||r|| <= max(abstol, reltol * ||r0||) (the benches pass bench.py's abstol
of 1e-30).  JAX's while_loop becomes a Python loop that reads back one
scalar norm per step for the stop test.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from .utils.precision import full_precision


class SolveResult(NamedTuple):
    x: torch.Tensor
    iterations: int
    residual: float      # Richardson: relative; FGMRES: Givens estimate
    converged: bool


def _norm(a) -> float:
    return float(torch.linalg.vector_norm(a.reshape(-1)))


def richardson_solve(A: Callable, b: torch.Tensor, x0: torch.Tensor,
                     precondition: Callable, maxiter: int = 100,
                     reltol: float = 1e-8) -> SolveResult:
    """x += P(b - A x) (bench.py's omega = 1) with a TRUE-residual stop
    test per step."""
    r = b - A(x0)
    beta = _norm(r)
    tol = reltol * beta
    x, res, j = x0, beta, 0
    while j < maxiter and res > tol:
        x = x + precondition(r)
        r = b - A(x)
        res = _norm(r)
        j += 1
    return SolveResult(x=x, iterations=j,
                       residual=res / (beta if beta != 0 else 1.0),
                       converged=res <= tol)


def fgmres(A: Callable, b: torch.Tensor, x0: torch.Tensor,
           precondition: Callable, maxiter: int = 100,
           reltol: float = 1e-12, abstol: float = 1e-12,
           reorthogonalize: bool = True) -> SolveResult:
    """Flexible GMRES without restart (basis size == maxiter): classical
    Gram-Schmidt with a second pass (stfem_tpu's default; the benches'
    IR mode passes reorthogonalize=False, one pass, since their untimed
    TRUE residual check gates the result), Givens rotations, stop on the
    Givens residual estimate."""
    shape = b.shape
    r0 = b - A(x0)
    beta = _norm(r0)
    tol = max(abstol, reltol * beta)
    V, Z = [], []
    H = torch.zeros((maxiter + 1, maxiter), dtype=torch.float64)
    cs, sn = [], []
    g = [beta]
    res, j = beta, 0
    v = (r0 / beta).reshape(-1) if beta > 0 else None
    while v is not None and j < maxiter and res > tol:
        V.append(v)
        z = precondition(v.reshape(shape))
        Z.append(z.reshape(-1))
        w = A(z).reshape(-1)
        Vm = torch.stack(V)
        with full_precision():      # never TF32 in the orthogonalisation
            h = Vm @ w
            w = w - Vm.T @ h
            if reorthogonalize:
                h2 = Vm @ w
                w = w - Vm.T @ h2
                h = h + h2
        wnorm = _norm(w)
        col = h.to(torch.float64).cpu().tolist() + [wnorm]
        for i in range(j):          # apply the earlier rotations
            a, c = col[i], col[i + 1]
            col[i] = cs[i] * a + sn[i] * c
            col[i + 1] = -sn[i] * a + cs[i] * c
        denom = (col[j] ** 2 + col[j + 1] ** 2) ** 0.5
        c_new = col[j] / denom if denom > 0 else 1.0
        s_new = col[j + 1] / denom if denom > 0 else 0.0
        cs.append(c_new)
        sn.append(s_new)
        col[j], col[j + 1] = denom, 0.0
        H[:j + 2, j] = torch.tensor(col, dtype=torch.float64)
        g.append(-s_new * g[j])
        g[j] = c_new * g[j]
        res = abs(g[j + 1])
        j += 1
        v = w / wnorm if wnorm > 0 else None
    x = x0
    if j > 0:
        R = H[:j, :j]
        y = torch.linalg.solve_triangular(
            R, torch.tensor(g[:j], dtype=torch.float64)[:, None],
            upper=True)[:, 0]
        Zm = torch.stack(Z)
        x = x0 + (Zm.T @ y.to(Zm.dtype).to(Zm.device)).reshape(shape)
    return SolveResult(x=x, iterations=j, residual=res, converged=res <= tol)


def estimate_error_propagator_radius(A: Callable, precondition: Callable,
                                     v0: torch.Tensor,
                                     n_iterations: int = 15) -> float:
    """Power-iteration estimate of rho(I - P A), the Richardson
    contraction factor."""
    v = v0 / _norm(v0)
    lam = 0.0
    for _ in range(n_iterations):
        w = v - precondition(A(v))
        lam = abs(float(torch.sum(v * w)))
        v = w / _norm(w)
    return lam

"""Outer solvers (counterpart of stfem_tpu/krylov.py): preconditioned
Richardson, Chebyshev-accelerated iteration, flexible GMRES, the
fixed-iteration left-preconditioned GMRES of the GMG coarse solve and the
error-propagator radius estimate.

Convergence semantics follow deal.II's ReductionControl: stop when
||r|| <= max(abstol, reltol * ||r0||) (the benches pass bench.py's abstol
of 1e-30).  JAX's while_loop becomes a Python loop that reads back one
scalar norm per step for the stop test.

richardson_solve and fgmres take an optional norm (and fgmres a dot):
the sharded solve passes the interface-weighted, all-reduced ones of
parallel/sharding.py::RankLayout.krylov_options.  Without them they use
the local 2-norm and products, as before.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
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
                     reltol: float = 1e-8, omega: float = 1.0,
                     abstol: float = 1e-30,
                     norm: Callable | None = None) -> SolveResult:
    """x += omega P(b - A x) with a TRUE-residual stop test per step,
    ||r|| <= max(abstol, reltol ||r0||) (stfem_tpu krylov.py:258-290).
    norm: a -> float (default the 2-norm)."""
    norm = norm or _norm
    r = b - A(x0)
    beta = norm(r)
    tol = max(abstol, reltol * beta)
    x, res, j = x0, beta, 0
    while j < maxiter and res > tol:
        step = precondition(r)
        x = x + (step if omega == 1.0 else omega * step)
        r = b - A(x)
        res = norm(r)
        j += 1
    return SolveResult(x=x, iterations=j,
                       residual=res / (beta if beta != 0 else 1.0),
                       converged=res <= tol)


def chebyshev_solve(A: Callable, b: torch.Tensor, x0: torch.Tensor,
                    precondition: Callable, lambda_min: float,
                    lambda_max: float, maxiter: int = 100,
                    abstol: float = 1e-30,
                    reltol: float = 1e-8) -> SolveResult:
    """Chebyshev-accelerated preconditioned iteration for spec(P A) within
    [lambda_min, lambda_max] (real and positive; estimate_error_propagator_
    radius gives the interval [1 - rho, 1 + rho]): deal.II's first-kind
    recurrence on the correction from x0, one step always, then a
    true-residual stop test per step, ||r|| <= max(abstol, reltol ||r0||).
    The step costs what a Richardson step costs."""
    theta = (lambda_max + lambda_min) / 2.0
    delta = max((lambda_max - lambda_min) / 2.0, 1e-30)
    r = b - A(x0)
    beta = _norm(r)
    tol = max(abstol, reltol * beta)
    # e carries the previous increment (deal.II's `update` vector)
    e = precondition(r) * (1.0 / theta)
    x = x0 + e
    r = b - A(x)
    res, j, rhok = _norm(r), 1, delta / theta
    sigma = 2.0 * theta / delta
    while j < maxiter and res > tol:
        rho_new = 1.0 / (sigma - rhok)
        e = rho_new * rhok * e + (2.0 * rho_new / delta) * precondition(r)
        x = x + e
        r = b - A(x)
        res, j, rhok = _norm(r), j + 1, rho_new
    return SolveResult(x=x, iterations=j,
                       residual=res / (beta if beta != 0 else 1.0),
                       converged=res <= tol)


def _least_squares(H: torch.Tensor, beta: torch.Tensor) -> torch.Tensor:
    """argmin ||beta e1 - H y|| of minimum norm for the (m + 1) x m
    Hessenberg matrix H, on the host in float64, singular values below
    eps(H's dtype) (m + 1) of the largest cut as stfem_tpu's lstsq cuts
    them; y on H's device.  The one host read of the coarse solve; a
    non-finite value raises."""
    m = H.shape[1]
    Hb = torch.cat([H.reshape(-1), beta.reshape(1)]).to(
        torch.float64).cpu().numpy()
    if not np.all(np.isfinite(Hb)):
        raise FloatingPointError("GMRES coarse solve: non-finite Hessenberg "
                                 "matrix or rhs")
    e1 = np.zeros(m + 1)
    e1[0] = Hb[-1]
    eps = torch.finfo(H.dtype if H.dtype != torch.bfloat16
                      else torch.float32).eps
    y = np.linalg.lstsq(Hb[:-1].reshape(m + 1, m), e1,
                        rcond=eps * (m + 1))[0]
    return torch.as_tensor(y, dtype=H.dtype, device=H.device)


def gmres_fixed_left(A: Callable, b: torch.Tensor, precondition: Callable,
                     n_iter: int) -> torch.Tensor:
    """Left-preconditioned GMRES with exactly n_iter iterations from a zero
    guess (the reference's coarse solve: deal.II SolverGMRES under
    IterationNumberControl, stmg.h:1240-1302): classical Gram-Schmidt
    with a second pass, a zero basis vector after a breakdown, and the
    least-squares problem's minimum-norm solution (_least_squares).  So a
    zero rhs gives zero, and a system with fewer unknowns than n_iter its
    solution."""
    shape, dtype = b.shape, b.dtype
    m = n_iter
    pb = precondition(b).reshape(-1)
    beta = torch.linalg.vector_norm(pb)
    V = torch.zeros((m + 1, pb.numel()), dtype=dtype, device=b.device)
    V[0] = torch.where(beta > 0, pb / torch.where(beta == 0, 1, beta), 0)
    H = torch.zeros((m + 1, m), dtype=dtype, device=b.device)
    with full_precision():
        for j in range(m):
            w = precondition(A(V[j].reshape(shape))).reshape(-1)
            Vj = V[:j + 1]
            h1 = Vj @ w
            w = w - Vj.T @ h1
            h2 = Vj @ w
            w = w - Vj.T @ h2
            wnorm = torch.linalg.vector_norm(w)
            H[:j + 1, j] = h1 + h2
            H[j + 1, j] = wnorm
            V[j + 1] = torch.where(wnorm > 0,
                                   w / torch.where(wnorm == 0, 1, wnorm), 0)
    y = _least_squares(H, beta)
    with full_precision():
        return (V[:m].T @ y).reshape(shape)


def fgmres(A: Callable, b: torch.Tensor, x0: torch.Tensor,
           precondition: Callable, maxiter: int = 100,
           reltol: float = 1e-12, abstol: float = 1e-12,
           reorthogonalize: bool | str = True, basis_dtype=None,
           flexible: bool = True, norm: Callable | None = None,
           dot: Callable | None = None) -> SolveResult:
    """GMRES without restart (basis size == maxiter), Givens rotations,
    stop on the Givens residual estimate, with stfem_tpu's options
    (krylov.py:40-81):

    reorthogonalize: True runs classical Gram-Schmidt with a second pass
        (stfem_tpu's default), False one pass (the benches' IR mode: their
        untimed TRUE residual check gates the result), "selective" the
        second pass only where the first cancelled most of w (the DGKS
        test ||w_after|| < ||w_before|| / sqrt(2)).
    basis_dtype: store the orthonormal basis V in this dtype (e.g. bf16;
        the Gram-Schmidt products run in the working dtype); the
        preconditioned directions Z and x keep the working dtype.
    flexible: False is right-preconditioned GMRES: no Z is kept and x =
        x0 + P(V y), one more preconditioner apply at the end; right only
        for a fixed linear P (the STMG V-cycle), where its iterates are
        FGMRES's.
    norm: a -> float, and dot: (V [m, n], w [n]) -> V w, the basis rows
        against a flattened vector (defaults: the 2-norm and V @ w)."""
    norm = norm or _norm
    _dot = dot or torch.matmul
    shape = b.shape
    r0 = b - A(x0)
    beta = norm(r0)
    tol = max(abstol, reltol * beta)
    V, Z = [], []
    H = torch.zeros((maxiter + 1, maxiter), dtype=torch.float64)
    cs, sn = [], []
    g = [beta]
    res, j = beta, 0
    v = (r0 / beta).reshape(-1) if beta > 0 else None
    while v is not None and j < maxiter and res > tol:
        V.append(v if basis_dtype is None else v.to(basis_dtype))
        z = precondition(v.reshape(shape))
        if flexible:
            Z.append(z.reshape(-1))
        w = A(z).reshape(-1)
        Vm = torch.stack(V).to(w.dtype)
        with full_precision():      # never TF32 in the orthogonalisation
            w_pre = norm(w) if reorthogonalize == "selective" else 0.0
            h = _dot(Vm, w)
            w = w - Vm.T @ h
            if reorthogonalize == "selective":
                again = norm(w) < 0.7071 * w_pre
            else:
                again = bool(reorthogonalize)
            if again:
                h2 = _dot(Vm, w)
                w = w - Vm.T @ h2
                h = h + h2
        wnorm = norm(w)
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
        basis = torch.stack(Z) if flexible else torch.stack(V).to(b.dtype)
        with full_precision():
            step = (basis.T @ y.to(basis.dtype).to(basis.device)).reshape(
                shape)
        x = x0 + (step if flexible else precondition(step))
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

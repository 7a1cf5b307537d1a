"""Relaxation smoother with deterministic eigenvalue estimates (counterpart
of stfem_tpu/stmg/smoother.py; deal.II PreconditionRelaxation semantics as
configured by the reference GMG, stmg.h:1199-1238).

  * start vector per block: v_i = i mod 11, minus the block mean, zeroed on
    constrained dofs -- ported exactly: the estimate, hence omega and the
    iteration counts, depend on it
  * method "arnoldi": converged lambda_max(P A) (ARPACK, tol 1e-5), no
    safety factor; "power": 20 power iterations on float32 probes,
    max = 1.2 * estimate
  * relaxation omega = 2 / (alpha + max_eig), alpha = max_eig / range if
    the smoothing range is above 1 (the Stokes bench's 5), else
    min(0.9 max_eig, min_eig) (the heat and wave benches' range 1)
The Chebyshev smoother is not ported yet.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def initial_guess(shape_blocks, mask, dtype=torch.float32, device="cpu"):
    """[n_blocks, *dofshape] deterministic high-frequency start vector."""
    n_blocks = shape_blocks[0]
    n = int(np.prod(shape_blocks[1:]))
    v = (np.arange(n) % 11).astype(np.float64)
    v = np.tile(v[None, :], (n_blocks, 1)).reshape(shape_blocks)
    v = v * np.asarray(mask)[None]
    v = v - v.mean(axis=tuple(range(1, len(shape_blocks))), keepdims=True)
    v = v * np.asarray(mask)[None]
    return torch.as_tensor(v, dtype=dtype, device=device)


@dataclass
class EigInfo:
    min_eigenvalue: float
    max_eigenvalue: float


def power_estimate(matrix, precond, v0: torch.Tensor,
                   n_iterations: int) -> float:
    """deal.II internal::power_iteration: <v, (P A) v> after n steps."""
    v = v0 / torch.linalg.vector_norm(v0)
    lam = torch.zeros((), dtype=v.dtype, device=v.device)
    for _ in range(n_iterations):
        w = precond.vmult(matrix.vmult(v)).to(v.dtype)
        lam = torch.sum(v * w)
        v = w / torch.linalg.vector_norm(w)
    return float(lam)


def arnoldi_lambda_max(matrix, precond, shape_blocks, mask, device="cpu",
                       tol: float = 1e-5, ncv: int = 24) -> float | None:
    """Converged largest |eigenvalue| of P A by implicitly restarted
    Arnoldi (scipy.sparse.linalg.eigs) from the deterministic start vector;
    float32 sweeps on `device`.  None if ARPACK fails."""
    import scipy.sparse.linalg as spla

    n = int(np.prod(shape_blocks))
    v0 = initial_guess(shape_blocks, mask, torch.float32).numpy()
    v0 = v0.reshape(-1).astype(np.float64)
    if not np.any(v0):
        return None

    def matvec(v):
        x = torch.as_tensor(np.asarray(v).reshape(shape_blocks),
                            dtype=torch.float32, device=device)
        w = precond.vmult(matrix.vmult(x)).reshape(-1).to(torch.float32)
        return w.cpu().numpy().astype(np.float64)

    op = spla.LinearOperator((n, n), matvec=matvec, dtype=np.float64)
    try:
        w = spla.eigs(op, k=1, which="LM", v0=v0, ncv=min(ncv, n - 1),
                      maxiter=300, tol=tol, return_eigenvectors=False)
    except Exception:
        return None
    lam = float(np.max(np.abs(w)))
    return lam if np.isfinite(lam) and lam > 0 else None


POWER_ITERATIONS, SAFETY_FACTOR = 20, 1.2


def estimate_eigenvalues(matrix, precond, shape_blocks, mask, device="cpu",
                         method: str = "power") -> EigInfo:
    """method="power": deal.II semantics (min = estimate, max = safety *
    estimate); method="arnoldi": converged lambda_max, min = max, falling
    back to the power iteration if ARPACK fails."""
    if method == "arnoldi":
        lam = arnoldi_lambda_max(matrix, precond, shape_blocks, mask,
                                 device=device)
        if lam is not None:
            return EigInfo(min_eigenvalue=lam, max_eigenvalue=lam)
    v0 = initial_guess(shape_blocks, mask, torch.float32, device)
    est = power_estimate(matrix, precond, v0, POWER_ITERATIONS)
    return EigInfo(min_eigenvalue=est, max_eigenvalue=SAFETY_FACTOR * est)


def relaxation_parameters(info: EigInfo, smoothing_range: float) -> float:
    alpha = (info.max_eigenvalue / smoothing_range if smoothing_range > 1.0
             else min(0.9 * info.max_eigenvalue, info.min_eigenvalue))
    return 2.0 / (alpha + info.max_eigenvalue)


class RelaxationSmoother:
    """x = 0; n_iterations of x += omega P (b - A x)
    (deal.II PreconditionRelaxation.vmult)."""

    def __init__(self, matrix, precond, omega: float, n_iterations: int = 1):
        self.matrix = matrix
        self.precond = precond
        self.omega = omega
        self.n_iterations = n_iterations

    def vmult(self, b: torch.Tensor):
        x = self.omega * self.precond.vmult(b)
        for _ in range(self.n_iterations - 1):
            x = x + self.omega * self.precond.vmult(b - self.matrix.vmult(x))
        return x


class IdentitySmoother:
    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        return b

"""Relaxation and Chebyshev smoothers with deterministic eigenvalue
estimates (counterpart of stfem_tpu/stmg/smoother.py; deal.II
PreconditionRelaxation and PreconditionChebyshev semantics as configured
by the reference GMG, stmg.h:1199-1238).

  * start vector per block: v_i = i mod 11, minus the block mean, zeroed on
    constrained dofs -- ported exactly: the estimate, hence omega and the
    iteration counts, depend on it
  * method "arnoldi": converged lambda_max(P A) (tol 1e-5), no safety
    factor -- ARPACK on the host up to ARPACK_HOST_MAX_N unknowns, the
    same restarted Arnoldi (Krylov-Schur) on the operator's device above;
    "power": 20 power iterations on float32 probes, max = 1.2 * estimate
  * relaxation omega = 2 / (alpha + max_eig), alpha = max_eig / range if
    the smoothing range is above 1 (the Stokes bench's 5), else
    min(0.9 max_eig, min_eig) (the heat and wave benches' range 1)
  * Chebyshev: the same interval [alpha, max_eig] as theta = (max_eig +
    alpha) / 2, delta = (max_eig - alpha) / 2; degree 1 is the Relaxation
    smoother with omega = 1 / theta
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


def initial_guess(shape_blocks, mask, dtype=torch.float32, device="cuda"):
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


# ARPACK keeps its Krylov basis on the host, orthogonalises there and
# round-trips every vector; on the coefficient levels' clustered complex
# spectra it takes thousands of applies (4,660 on a 26k-unknown level).
# Up to this many unknowns it runs all the same, for parity with
# stfem_tpu, whose engine it is: that covers every proxy estimate of the
# benches (the largest, the heat fine level's, has 29,478 unknowns).
# Above it the same criterion is met by the device Krylov-Schur, in
# ~10-35x fewer applies
ARPACK_HOST_MAX_N = 32_768


def krylov_schur_lambda_max(apply, v0: torch.Tensor, tol: float = 1e-5,
                            ncv: int = 24, max_matvecs: int = 6900
                            ) -> float | None:
    """Largest |eigenvalue| of the operator `apply` by the Krylov-Schur
    restarted Arnoldi method (Stewart 2001), with the basis on v0's
    device in float64: each cycle extends the factorization A V = V H +
    v e^T to ncv vectors (classical Gram-Schmidt, two passes), orders the
    real Schur form of H by |eigenvalue| and keeps the larger half.  The
    wanted Ritz value theta converges when its residual |h y_last| <=
    tol |theta| (ARPACK's test).  None if it does not converge within
    max_matvecs applies (ARPACK's maxiter=300 at ncv=24 allows ~6,900)."""
    import scipy.linalg

    n = v0.numel()
    m = min(ncv, n - 1)
    V = torch.zeros((m + 1, n), dtype=torch.float64, device=v0.device)
    V[0] = v0.reshape(-1).to(torch.float64) / torch.linalg.vector_norm(v0)
    H = np.zeros((m + 1, m))
    k, matvecs = 0, 0
    while True:
        for j in range(k, m):
            w = apply(V[j])
            matvecs += 1
            Vj = V[:j + 1]
            h = Vj @ w
            w = w - Vj.T @ h
            h2 = Vj @ w
            w = w - Vj.T @ h2
            beta = float(torch.linalg.vector_norm(w))
            H[:j + 1, j] = (h + h2).cpu().numpy()
            H[j + 1, j] = beta
            if beta == 0.0:                  # an invariant subspace
                return float(np.max(np.abs(np.linalg.eigvals(
                    H[:j + 1, :j + 1]))))
            V[j + 1] = w / beta
        ev, Y = np.linalg.eig(H[:m, :m])
        i = int(np.argmax(np.abs(ev)))
        theta = abs(ev[i])
        if abs(H[m, m - 1] * Y[m - 1, i]) <= tol * theta:
            return float(theta)
        if matvecs >= max_matvecs:
            return None
        # keep the Schur vectors of the larger half of |eigenvalue|
        mags = np.sort(np.abs(ev))[::-1]
        cut = mags[m // 2 - 1] * (1.0 - 1e-12)
        T, Z, k = scipy.linalg.schur(
            H[:m, :m], output="real",
            sort=lambda re, im: np.hypot(re, im) >= cut)
        if not 0 < k < m:
            return None
        Zk = torch.as_tensor(Z[:, :k], device=V.device)
        V[:k] = Zk.T @ V[:m]
        V[k] = V[m]
        H_new = np.zeros_like(H)
        H_new[:k, :k] = T[:k, :k]
        H_new[k, :k] = H[m, m - 1] * Z[m - 1, :k]
        H = H_new


def arpack_lambda_max(apply, v0: np.ndarray, device, tol: float = 1e-5,
                      ncv: int = 24) -> float | None:
    """Largest |eigenvalue| of the operator `apply` (float64 vectors on
    `device`) by implicitly restarted ARPACK on the host
    (scipy.sparse.linalg.eigs, stfem_tpu's engine) from the host start
    vector v0.  None if the iteration fails."""
    import scipy.sparse.linalg as spla

    n = v0.size

    def matvec(v):
        x = torch.as_tensor(np.asarray(v).reshape(-1), device=device)
        return apply(x).cpu().numpy()

    op = spla.LinearOperator((n, n), matvec=matvec, dtype=np.float64)
    try:
        w = spla.eigs(op, k=1, which="LM", v0=v0, ncv=min(ncv, n - 1),
                      maxiter=300, tol=tol, return_eigenvectors=False)
    except Exception:
        return None
    lam = float(np.max(np.abs(w)))
    return lam if np.isfinite(lam) and lam > 0 else None


def pa_apply(matrix, precond, shape_blocks):
    """v -> P A v on flat float64 vectors, swept in float32."""
    def apply(v: torch.Tensor) -> torch.Tensor:
        x = v.reshape(shape_blocks).to(torch.float32)
        return precond.vmult(matrix.vmult(x)).reshape(-1).to(torch.float64)

    return apply


def start_vector(shape_blocks, mask) -> np.ndarray:
    """initial_guess as a flat float64 host vector (float32 values)."""
    v0 = initial_guess(shape_blocks, mask, torch.float32, "cpu").numpy()
    return v0.reshape(-1).astype(np.float64)


def arnoldi_lambda_max(matrix, precond, shape_blocks, mask, device=None,
                       tol: float = 1e-5, ncv: int = 24) -> float | None:
    """Converged largest |eigenvalue| of P A by restarted Arnoldi from the
    deterministic start vector, float32 sweeps on `device` (None: the
    device of `matrix`): arpack_lambda_max up to ARPACK_HOST_MAX_N
    unknowns, krylov_schur_lambda_max on the device above.  None if the
    iteration fails."""
    device = _device_of(matrix, device, precond)
    v0 = start_vector(shape_blocks, mask)
    if not np.any(v0):
        return None
    apply = pa_apply(matrix, precond, shape_blocks)
    if v0.size <= ARPACK_HOST_MAX_N:
        return arpack_lambda_max(apply, v0, device, tol, ncv)
    return krylov_schur_lambda_max(apply, torch.as_tensor(v0, device=device),
                                   tol, ncv)


POWER_ITERATIONS, SAFETY_FACTOR = 20, 1.2


def _device_of(matrix, device, precond=None):
    """The explicit device, else the device of the operator's (or the
    preconditioner's) tensors, else the card."""
    if device is not None:
        return torch.device(device)
    for op in (matrix, precond):
        if getattr(op, "device", None) is not None:
            return torch.device(op.device)
    return torch.device("cuda")


def estimate_eigenvalues(matrix, precond, shape_blocks, mask, device=None,
                         method: str = "power",
                         n_iterations: int = POWER_ITERATIONS,
                         safety_factor: float = SAFETY_FACTOR) -> EigInfo:
    """method="power": deal.II semantics (min = estimate, max = safety *
    estimate); method="arnoldi": converged lambda_max, min = max, falling
    back to the power iteration if ARPACK fails.  The sweeps run on
    `device`, by default the device of `matrix`."""
    device = _device_of(matrix, device, precond)
    if method == "arnoldi":
        lam = arnoldi_lambda_max(matrix, precond, shape_blocks, mask,
                                 device=device)
        if lam is not None:
            return EigInfo(min_eigenvalue=lam, max_eigenvalue=lam)
    v0 = initial_guess(shape_blocks, mask, torch.float32, device)
    est = power_estimate(matrix, precond, v0, n_iterations)
    return EigInfo(min_eigenvalue=est, max_eigenvalue=safety_factor * est)


def _lower_end(info: EigInfo, smoothing_range: float) -> float:
    """alpha, the lower end of the smoothed interval [alpha, max_eig]."""
    return (info.max_eigenvalue / smoothing_range if smoothing_range > 1.0
            else min(0.9 * info.max_eigenvalue, info.min_eigenvalue))


def relaxation_parameters(info: EigInfo, smoothing_range: float) -> float:
    alpha = _lower_end(info, smoothing_range)
    return 2.0 / (alpha + info.max_eigenvalue)


def chebyshev_parameters(info: EigInfo,
                         smoothing_range: float) -> tuple[float, float]:
    """(theta, delta): the centre and half-width of [alpha, max_eig]."""
    alpha = _lower_end(info, smoothing_range)
    theta = (info.max_eigenvalue + alpha) / 2.0
    delta = (info.max_eigenvalue - alpha) / 2.0
    return theta, delta


class RelaxationSmoother:
    """x = 0; n_iterations of x += omega P (b - A x)
    (deal.II PreconditionRelaxation.vmult)."""

    def __init__(self, matrix, precond, omega: float, n_iterations: int = 1):
        self.matrix = matrix
        self.precond = precond
        self.omega = omega
        self.n_iterations = n_iterations

    def vmult(self, b: torch.Tensor, n_iterations: int | None = None):
        """n_iterations: this application's sweeps (None: the
        smoother's)."""
        n = self.n_iterations if n_iterations is None else n_iterations
        x = self.omega * self.precond.vmult(b)
        for _ in range(n - 1):
            x = x + self.omega * self.precond.vmult(b - self.matrix.vmult(x))
        return x


class ChebyshevSmoother:
    """deal.II PreconditionChebyshev.vmult: the first-kind polynomial of
    `degree` in P A on [theta - delta, theta + delta], from a zero guess,
    `degree` applications of P and degree - 1 of A."""

    def __init__(self, matrix, precond, theta: float, delta: float,
                 degree: int = 1):
        self.matrix = matrix
        self.precond = precond
        self.theta = theta
        self.delta = delta
        self.degree = degree

    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        x = self.precond.vmult(b) * (1.0 / self.theta)
        if self.degree == 1:
            return x
        x_old = torch.zeros_like(x)
        rhok = self.delta / self.theta
        sigma = 2.0 * self.theta / self.delta
        for _ in range(1, self.degree):
            rho_new = 1.0 / (sigma - rhok)
            factor1 = rho_new * rhok
            factor2 = 2.0 * rho_new / self.delta
            rhok = rho_new
            r = b - self.matrix.vmult(x)
            x_new = x + factor1 * (x - x_old) + factor2 * self.precond.vmult(r)
            x_old, x = x, x_new
        return x


class IdentitySmoother:
    def vmult(self, b: torch.Tensor) -> torch.Tensor:
        return b

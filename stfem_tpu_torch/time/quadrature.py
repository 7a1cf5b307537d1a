"""1D quadrature rules and Lagrange bases on the reference interval [0, 1].

These are the time-direction building blocks of the space-time discretization:
CGP(r) uses Gauss-Lobatto points, DG(r) uses right Gauss-Radau points, and all
weak-form integrals use Gauss-Legendre quadrature (reference:
include/fe_time.cc:152-169, include/fe_time.h:643-744).

Everything here is plain NumPy float64 executed at *setup/trace* time; nothing
in this module touches a device.
"""
from __future__ import annotations

import numpy as np
from numpy.polynomial import legendre as npleg


def gauss(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Legendre points/weights on [0,1] (deal.II QGauss<1>(n))."""
    x, w = npleg.leggauss(n)
    return 0.5 * (x + 1.0), 0.5 * w


def gauss_lobatto(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Gauss-Lobatto points/weights on [0,1] (deal.II QGaussLobatto<1>(n)).

    Interior points are the roots of P'_{n-1}; weights 2/(n(n-1) P_{n-1}(x)^2)
    on [-1,1], scaled to [0,1].
    """
    assert n >= 2
    # derivative of Legendre P_{n-1}
    c = np.zeros(n)
    c[-1] = 1.0
    dc = npleg.legder(c)
    interior = npleg.legroots(dc)
    x = np.concatenate(([-1.0], np.sort(interior), [1.0]))
    # polish roots with a couple of Newton steps for full double accuracy
    for _ in range(3):
        d1 = npleg.legval(x[1:-1], dc)
        d2 = npleg.legval(x[1:-1], npleg.legder(dc))
        x[1:-1] -= d1 / d2
    pn1 = npleg.legval(x, c)
    w = 2.0 / (n * (n - 1) * pn1 ** 2)
    return 0.5 * (x + 1.0), 0.5 * w


def gauss_radau_right(n: int) -> tuple[np.ndarray, np.ndarray]:
    """Right Gauss-Radau points/weights on [0,1].

    deal.II QGaussRadau<1>(n, EndPoint::right) == mirror of the left rule.
    Left rule on [-1,1]: x_0=-1 plus roots of (P_{n-1}(x)+P_n(x))/(1+x);
    weights w_0 = 2/n^2, w_i = (1-x_i)/(n^2 P_{n-1}(x_i)^2).
    """
    assert n >= 1
    if n == 1:
        return np.array([1.0]), np.array([1.0])
    cn = np.zeros(n + 1)
    cn[-1] = 1.0
    cn1 = np.zeros(n)
    cn1[-1] = 1.0
    # roots of P_{n-1} + P_n, excluding x=-1
    csum = np.zeros(n + 1)
    csum[: n] += cn1
    csum += cn
    r = npleg.legroots(csum)
    r = np.real(r[np.abs(np.imag(r)) < 1e-12]) if np.iscomplexobj(r) else r
    r = np.sort(r[r > -1.0 + 1e-10])
    # Newton polish
    dcsum = npleg.legder(csum)
    for _ in range(3):
        r -= npleg.legval(r, csum) / npleg.legval(r, dcsum)
    x_left = np.concatenate(([-1.0], r))
    w_left = np.empty(n)
    w_left[0] = 2.0 / n ** 2
    pn1 = npleg.legval(x_left[1:], cn1)
    w_left[1:] = (1.0 - x_left[1:]) / (n ** 2 * pn1 ** 2)
    # mirror to right rule and sort ascending
    x = np.sort(-x_left)
    w = w_left[::-1].copy()
    return 0.5 * (x + 1.0), 0.5 * w


class LagrangeBasis:
    """Lagrange basis on arbitrary distinct points (deal.II
    Polynomials::generate_complete_Lagrange_basis analogue).

    Provides values and derivatives of all basis polynomials at given points.
    """

    def __init__(self, points: np.ndarray):
        self.points = np.asarray(points, dtype=np.float64)
        self.n = len(self.points)

    def value(self, j: int, x: float | np.ndarray) -> np.ndarray:
        """phi_j(x)."""
        x = np.asarray(x, dtype=np.float64)
        result = np.ones_like(x)
        xj = self.points[j]
        for m in range(self.n):
            if m != j:
                result = result * (x - self.points[m]) / (xj - self.points[m])
        return result

    def derivative(self, j: int, x: float | np.ndarray) -> np.ndarray:
        """phi_j'(x)."""
        x = np.asarray(x, dtype=np.float64)
        xj = self.points[j]
        total = np.zeros_like(x)
        for l in range(self.n):
            if l == j:
                continue
            term = np.ones_like(x) / (xj - self.points[l])
            for m in range(self.n):
                if m != j and m != l:
                    term = term * (x - self.points[m]) / (xj - self.points[m])
            total = total + term
        return total

    def eval_matrix(self, x: np.ndarray) -> np.ndarray:
        """V[i, j] = phi_j(x_i)."""
        x = np.asarray(x, dtype=np.float64)
        return np.stack([self.value(j, x) for j in range(self.n)], axis=-1)

    def deriv_matrix(self, x: np.ndarray) -> np.ndarray:
        """D[i, j] = phi_j'(x_i)."""
        x = np.asarray(x, dtype=np.float64)
        return np.stack([self.derivative(j, x) for j in range(self.n)], axis=-1)

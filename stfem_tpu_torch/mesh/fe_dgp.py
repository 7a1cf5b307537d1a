"""Discontinuous total-degree modal pressure element (copy of
stfem_tpu/mesh/fe_dgp.py, pure NumPy; deal.II FE_DGP analogue):
shifted-Legendre tensor products P_i(x)P_j(y)[P_l(z)] with i+j(+l) <=
degree, L2-orthonormal on the unit cell.

Orthonormality makes the pressure mass matrix diagonal (detJ * I per affine
cell), the mean-value fix a single-coefficient update, and DG h-transfers
exact small dense embeddings.
"""
from __future__ import annotations

import itertools
from functools import lru_cache

import numpy as np
from numpy.polynomial import legendre as npleg

from ..time.quadrature import gauss


def shifted_legendre_value(n: int, x: np.ndarray) -> np.ndarray:
    """Orthonormal shifted Legendre on [0,1]: sqrt(2n+1) P_n(2x-1)."""
    c = np.zeros(n + 1)
    c[n] = 1.0
    return np.sqrt(2 * n + 1) * npleg.legval(2.0 * np.asarray(x) - 1.0, c)


def shifted_legendre_deriv(n: int, x: np.ndarray) -> np.ndarray:
    c = np.zeros(n + 1)
    c[n] = 1.0
    dc = npleg.legder(c)
    return 2.0 * np.sqrt(2 * n + 1) * npleg.legval(
        2.0 * np.asarray(x) - 1.0, dc)


@lru_cache(maxsize=None)
def dgp_exponents(dim: int, degree: int) -> tuple[tuple[int, ...], ...]:
    """Multi-indices with total degree <= degree, ordered by total degree
    (deal.II PolynomialSpace ordering convention)."""
    out = []
    for d in range(degree + 1):
        for combo in itertools.product(range(d + 1), repeat=dim):
            if sum(combo) == d:
                out.append(combo)
    return tuple(out)


def n_dgp_dofs(dim: int, degree: int) -> int:
    return len(dgp_exponents(dim, degree))


@lru_cache(maxsize=None)
def dgp_values_at_tensor_gauss(dim: int, degree: int,
                               n_q: int) -> np.ndarray:
    """Psi[m, q1..qd]: modal basis values at the tensor Gauss points."""
    qx, _ = gauss(n_q)
    exps = dgp_exponents(dim, degree)
    out = np.ones((len(exps),) + (n_q,) * dim)
    for m, e in enumerate(exps):
        for d in range(dim):
            shape = [1] * dim
            shape[d] = n_q
            out[m] *= shifted_legendre_value(e[d], qx).reshape(shape)
    return out


@lru_cache(maxsize=None)
def dgp_gradients_at_tensor_gauss(dim: int, degree: int,
                                  n_q: int) -> np.ndarray:
    """dPsi[m, q1..qd, e]: reference-space gradients at tensor Gauss pts."""
    qx, _ = gauss(n_q)
    exps = dgp_exponents(dim, degree)
    out = np.ones((len(exps),) + (n_q,) * dim + (dim,))
    for m, ex in enumerate(exps):
        for e in range(dim):
            for d in range(dim):
                shape = [1] * dim
                shape[d] = n_q
                f = (shifted_legendre_deriv(ex[d], qx) if d == e
                     else shifted_legendre_value(ex[d], qx))
                out[m, ..., e] = out[m, ..., e] * f.reshape(shape)
    return out


@lru_cache(maxsize=None)
def dgp_child_embedding(dim: int, degree: int) -> np.ndarray:
    """E[child, m_child, m_coarse]: exact expansion of each coarse modal
    function restricted to child c in the child's own modal basis
    (orthonormality => E = integral of products)."""
    n = n_dgp_dofs(dim, degree)
    n_q = degree + 2
    qx, qw = gauss(n_q)
    exps = dgp_exponents(dim, degree)
    children = list(itertools.product((0, 1), repeat=dim))
    E = np.zeros((len(children), n, n))
    for ci, bits in enumerate(children):
        # 1D blocks: B1[d][i, j] = int psi_i(xi) psi_j((xi+b)/2) dxi
        B1 = []
        for d in range(dim):
            b = bits[d]
            M = np.zeros((degree + 1, degree + 1))
            for i in range(degree + 1):
                vi = shifted_legendre_value(i, qx)
                for j in range(degree + 1):
                    vj = shifted_legendre_value(j, (qx + b) / 2.0)
                    M[i, j] = np.sum(qw * vi * vj)
            B1.append(M)
        for mi, ei in enumerate(exps):
            for mj, ej in enumerate(exps):
                v = 1.0
                for d in range(dim):
                    v *= B1[d][ei[d], ej[d]]
                E[ci, mi, mj] = v
    return E


def dgp_p_embedding(dim: int, degree_coarse: int,
                    degree_fine: int) -> np.ndarray:
    """p-prolongation on the same cell: nested orthonormal bases => a 0/1
    selection matrix (n_fine, n_coarse)."""
    ef = dgp_exponents(dim, degree_fine)
    ec = dgp_exponents(dim, degree_coarse)
    P = np.zeros((len(ef), len(ec)))
    index = {e: i for i, e in enumerate(ef)}
    for j, e in enumerate(ec):
        P[index[e], j] = 1.0
    return P

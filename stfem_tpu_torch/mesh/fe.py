"""1D finite-element shape data on the reference interval [0, 1].

Continuous Q_k elements use Gauss-Lobatto support points (deal.II FE_Q
convention, which matters for nodal interpolation and p-transfer parity).
The tensor-product structure means ALL spatial operators reduce to these 1D
matrices applied axis-by-axis (sum factorization) -- on TPU each application
is a small dense matmul that XLA maps onto the MXU.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from functools import lru_cache

import numpy as np

from ..time.quadrature import LagrangeBasis, gauss, gauss_lobatto


@lru_cache(maxsize=None)
def q_nodes_1d(degree: int) -> tuple[float, ...]:
    """Support points of Q_degree on [0,1] in lexicographic order (GLL)."""
    if degree == 0:
        return (0.5,)
    return tuple(gauss_lobatto(degree + 1)[0])


@dataclass(frozen=True)
class ShapeData1D:
    """Values/derivatives of the 1D nodal basis at quadrature points.

    S[q, a] = phi_a(x_q),  D[q, a] = phi_a'(x_q), w[q] = quad weight.
    """
    degree: int
    n_q: int
    points: np.ndarray = field(repr=False)   # support points (degree+1,)
    quad_x: np.ndarray = field(repr=False)   # (n_q,)
    quad_w: np.ndarray = field(repr=False)   # (n_q,)
    S: np.ndarray = field(repr=False)        # (n_q, degree+1)
    D: np.ndarray = field(repr=False)        # (n_q, degree+1)


@lru_cache(maxsize=None)
def shape_data_1d(degree: int, n_q: int) -> ShapeData1D:
    pts = np.array(q_nodes_1d(degree))
    basis = LagrangeBasis(pts)
    qx, qw = gauss(n_q)
    return ShapeData1D(degree=degree, n_q=n_q, points=pts, quad_x=qx,
                       quad_w=qw, S=basis.eval_matrix(qx),
                       D=basis.deriv_matrix(qx))


@lru_cache(maxsize=None)
def prolongation_1d(degree: int) -> np.ndarray:
    """1D h-prolongation: coarse nodal values on one interval -> fine nodal
    values on its two half-intervals, as the (2*degree+1, degree+1)
    interpolation matrix on the refined node set.

    Row i corresponds to fine node at x = i/(2*degree) positions mapped
    through the two children; entries are coarse basis values there.  Shared
    center node appears once.  This is the exact FE embedding (spaces nested).
    """
    pts = np.array(q_nodes_1d(degree))
    basis = LagrangeBasis(pts)
    fine_nodes = np.concatenate([pts * 0.5, 0.5 + pts[1:] * 0.5])
    return basis.eval_matrix(fine_nodes)


@lru_cache(maxsize=None)
def p_interpolation_1d(degree_src: int, degree_dst: int) -> np.ndarray:
    """1D p-prolongation on the same cell: values at the degree_dst nodes of
    the degree_src basis -> (degree_dst+1, degree_src+1)."""
    src = LagrangeBasis(np.array(q_nodes_1d(degree_src)))
    dst_pts = np.array(q_nodes_1d(degree_dst))
    return src.eval_matrix(dst_pts)

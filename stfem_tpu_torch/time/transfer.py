"""Time-direction multigrid transfer matrices.

k-coarsening: L2 projection between time FE spaces of different degree on the
same intervals (reference include/fe_time.h:746-805, via deal.II
FETools::get_projection_matrix in lexicographic point ordering).
tau-coarsening: two-interval FE embedding (prolongation) and its
interpolation/projection-based restriction (include/fe_time.h:807-898).
All tiny dense NumPy matrices; oracle: tests/transfer_02.output.
"""
from __future__ import annotations

import numpy as np

from ..types import TimeStepType
from .quadrature import LagrangeBasis, gauss
from .tables import get_time_quad


def _l2_projection(src_pts: np.ndarray, dst_pts: np.ndarray) -> np.ndarray:
    """P = M_dst^{-1} B with M_dst the dst mass matrix and
    B[i,j] = int phi_dst_i phi_src_j on [0,1] (FETools::get_projection_matrix
    semantics)."""
    src = LagrangeBasis(src_pts)
    dst = LagrangeBasis(dst_pts)
    n_q = len(src_pts) + len(dst_pts)
    qx, qw = gauss(n_q)
    Vs = src.eval_matrix(qx)          # (q, n_src)
    Vd = dst.eval_matrix(qx)          # (q, n_dst)
    M = Vd.T @ (qw[:, None] * Vd)
    B = Vd.T @ (qw[:, None] * Vs)
    return np.linalg.solve(M, B)


def get_time_projection_matrix(type_: TimeStepType, r_src: int, r_dst: int,
                               n_timesteps_at_once: int) -> np.ndarray:
    """k-transfer across the whole slab (reference fe_time.h:749-805).

    Per-interval L2 projection, block-filled per timestep with overwrite on
    shared CGP interval endpoints, CGP drops the global first row/column.
    """
    src_pts = get_time_quad(type_, r_src)[0]
    dst_pts = get_time_quad(type_, r_dst)[0]
    proj = _l2_projection(src_pts, dst_pts)  # (r_dst+1, r_src+1)

    if type_ == TimeStepType.DG:
        nd, ns = r_dst + 1, r_src + 1
        n_dofs_dst = n_timesteps_at_once * nd
        n_dofs_src = n_timesteps_at_once * ns
        out = np.zeros((n_dofs_dst, n_dofs_src))
        for it in range(n_timesteps_at_once):
            out[it * nd:(it + 1) * nd, it * ns:(it + 1) * ns] = proj
        return out
    # CGP: intervals share endpoints; per-step fills overwrite, then drop
    # the initial-value row/column
    nd, ns = r_dst, r_src
    n_dofs_dst = n_timesteps_at_once * nd + 1
    n_dofs_src = n_timesteps_at_once * ns + 1
    out = np.zeros((n_dofs_dst, n_dofs_src))
    for it in range(n_timesteps_at_once):
        out[it * nd:it * nd + nd + 1, it * ns:it * ns + ns + 1] = proj
    return out[1:, 1:]


def _embedding_1d(pts: np.ndarray, child: int) -> np.ndarray:
    """P_c[i, j] = phi_j((pts_i + child)/2): interpolation of the parent basis
    at the child's mapped nodes (deal.II get_prolongation_matrix, lex order).
    """
    basis = LagrangeBasis(pts)
    return basis.eval_matrix((pts + child) / 2.0)


def get_time_prolongation_matrix(type_: TimeStepType, r: int,
                                 n_timesteps_at_once: int = 2) -> np.ndarray:
    """tau-transfer: coarse slab of n/2 double-length steps -> fine slab of n
    steps (reference fe_time.h:807-851)."""
    assert n_timesteps_at_once > 1 and \
        (n_timesteps_at_once & (n_timesteps_at_once - 1)) == 0
    pts = get_time_quad(type_, r)[0]
    left = _embedding_1d(pts, 0)
    right = _embedding_1d(pts, 1)
    if type_ == TimeStepType.DG:
        per2 = np.vstack([left, right])          # (2(r+1), r+1)
        nd = r + 1
    else:
        per2 = np.vstack([left[1:, 1:], right[1:, 1:]])  # (2r, r)
        nd = r
    out = np.zeros((nd * n_timesteps_at_once, nd * n_timesteps_at_once // 2))
    for it in range(n_timesteps_at_once // 2):
        out[it * 2 * nd:(it + 1) * 2 * nd, it * nd:(it + 1) * nd] = per2
    return out


def _restriction_1d(type_: TimeStepType, pts: np.ndarray,
                    child: int) -> np.ndarray:
    """deal.II element restriction per child: DG -> per-child L2 projection
    contribution (additive); CGP/FE_Q -> interpolation at parent nodes lying
    in the child (non-additive, later children overwrite)."""
    n = len(pts)
    basis = LagrangeBasis(pts)
    if type_ == TimeStepType.DG:
        # minimize over parent: M_parent R_c = B_c with
        # B_c[i,j] = int_{child} phi_i(x) phi_j(2x - child) dx
        qx, qw = gauss(2 * n)
        # map child quadrature to parent coords: x = (qx + child)/2
        xp = (qx + child) / 2.0
        Vp = basis.eval_matrix(xp)
        Vc = basis.eval_matrix(qx)
        M = basis.eval_matrix(qx).T @ (qw[:, None] * basis.eval_matrix(qx))
        B = Vp.T @ ((0.5 * qw)[:, None] * Vc)
        return np.linalg.solve(M, B)
    R = np.zeros((n, n))
    for i, x in enumerate(pts):
        lo, hi = child / 2.0, (child + 1) / 2.0
        if lo - 1e-12 <= x <= hi + 1e-12:
            R[i, :] = basis.eval_matrix(np.array([2 * x - child]))[0]
    return R


def get_time_restriction_matrix(type_: TimeStepType, r: int,
                                n_timesteps_at_once: int = 2) -> np.ndarray:
    """Interpolation/projection-down tau-restriction (reference
    fe_time.h:853-898); the time restriction when
    restrict_is_transpose_prolongate is False."""
    assert n_timesteps_at_once > 1 and \
        (n_timesteps_at_once & (n_timesteps_at_once - 1)) == 0
    pts = get_time_quad(type_, r)[0]
    left = _restriction_1d(type_, pts, 0)
    right = _restriction_1d(type_, pts, 1)
    if type_ == TimeStepType.DG:
        per2 = np.hstack([left, right])
        nd = r + 1
    else:
        per2 = np.hstack([left[1:, 1:], right[1:, 1:]])
        nd = r
    out = np.zeros((nd * n_timesteps_at_once // 2, nd * n_timesteps_at_once))
    for it in range(n_timesteps_at_once // 2):
        out[it * nd:(it + 1) * nd, it * 2 * nd:(it + 1) * 2 * nd] = per2
    return out

"""Variational time-stepping weight tables.

Dense (tiny) matrices defining the CGP(r) / DG(r) time discretizations and
their multi-timestep block assembly, the Schur-reduced wave tables, the
two-variable Stokes tables and the nonlinear extrapolation (Picard
predictor) tables.  All NumPy float64, computed at setup time;
parity oracle is the reference's golden file tests/tp_02.output
(reference: include/fe_time.h:157-744, include/fe_time.cc).

Conventions (identical to the reference):
  * the slab system for first-order problems reads
        (Alpha (x) K + Beta (x) M) x = rhs,
    with Alpha carrying the time mass (scaled by tau) pairing the stiffness
    operator K, and Beta carrying the time derivative (+ DG jump) pairing the
    mass operator M (reference include/operators.h:536-559).
  * Gamma/Zeta are the single-column RHS couplings to the previous slab,
    applied as  rhs = (Gamma (x) K + Zeta (x) M) x_prev
    (reference include/fe_time.h:351-409, tests/tp_01.cc:160-168).
"""
from __future__ import annotations

from functools import lru_cache

import numpy as np

from ..types import MGType, NonlinearExtrapolation, TimeStepType
from .quadrature import (LagrangeBasis, gauss, gauss_lobatto,
                         gauss_radau_right)


def get_time_quad(type_: TimeStepType, r: int) -> tuple[np.ndarray, np.ndarray]:
    """Support points/weights of the time basis (fe_time.cc:152-161)."""
    if type_ == TimeStepType.DG:
        return gauss_radau_right(r + 1)
    elif type_ == TimeStepType.CGP:
        return gauss_lobatto(r + 1)
    raise ValueError(f"unsupported time type {type_}")


def get_time_basis(type_: TimeStepType, r: int) -> LagrangeBasis:
    """Lagrange basis on the time support points (fe_time.cc:163-169)."""
    return LagrangeBasis(get_time_quad(type_, r)[0])


def get_time_evaluation_matrix(basis: LagrangeBasis,
                               samples_per_interval: int) -> np.ndarray:
    """E[s, j] = phi_j(s/(S-1)) (reference include/fe_time.h:307-326)."""
    x = np.arange(samples_per_interval) / (samples_per_interval - 1)
    return basis.eval_matrix(x)


@lru_cache(maxsize=None)
def get_cg_weights(r: int) -> tuple[np.ndarray, np.ndarray]:
    """CGP(r) Petrov-Galerkin weights on the unit interval.

    Trial space: Lagrange on the r+1 Gauss-Lobatto points; test space:
    Lagrange on the last r of them.  Returns (mass, derivative), both (r, r+1):
        mass[i,j] = int test_i trial_j dt,   der[i,j] = int test_i trial_j' dt
    (reference include/fe_time.h:643-696).
    """
    trial_pts, _ = gauss_lobatto(r + 1)
    trial = LagrangeBasis(trial_pts)
    test = LagrangeBasis(trial_pts[1:])
    qx, qw = gauss(r + 2)
    mass = np.zeros((r, r + 1))
    der = np.zeros((r, r + 1))
    for i in range(r):
        ti = test.value(i, qx)
        for j in range(r + 1):
            mass[i, j] = np.sum(qw * ti * trial.value(j, qx))
            der[i, j] = np.sum(qw * ti * trial.derivative(j, qx))
    return mass, der


@lru_cache(maxsize=None)
def get_dg_weights(r: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """DG(r) weights: Lagrange basis on r+1 right-Radau points.

    Returns (mass, der_jump, jump):
        mass[i,j]     = int phi_i phi_j dt                      (r+1, r+1)
        der_jump[i,j] = int phi_i phi_j' dt + phi_i(0) phi_j(0) (r+1, r+1)
        jump[i,0]     = phi_i(0)                                (r+1, 1)
    (reference include/fe_time.h:698-744).
    """
    pts, _ = gauss_radau_right(r + 1)
    basis = LagrangeBasis(pts)
    qx, qw = gauss(r + 2)
    n = r + 1
    mass = np.zeros((n, n))
    der_jump = np.zeros((n, n))
    jump = np.zeros((n, 1))
    v0 = np.array([float(basis.value(i, 0.0)) for i in range(n)])
    for i in range(n):
        vi = basis.value(i, qx)
        jump[i, 0] = v0[i]
        for j in range(n):
            mass[i, j] = np.sum(qw * vi * basis.value(j, qx))
            der_jump[i, j] = v0[i] * v0[j] + np.sum(
                qw * vi * basis.derivative(j, qx))
    return mass, der_jump, jump


def split_lhs_rhs_cg(mass: np.ndarray, der: np.ndarray):
    """Split the (r, r+1) CGP tables into LHS (r,r) + RHS column (r,1).

    The first trial dof is the (known) value at the slab start; its column
    moves to the RHS with flipped sign (reference include/fe_time.h:485-503).
    Returns (Alpha, Beta, Gamma, Zeta).
    """
    return (mass[:, 1:].copy(), der[:, 1:].copy(),
            -mass[:, :1].copy(), -der[:, :1].copy())


def get_fe_time_weights(type_: TimeStepType, r: int, time_step_size: float,
                        n_timesteps_at_once: int = 1):
    """Assembled slab tables (Alpha, Beta, Gamma, Zeta).

    Per-interval tables are scaled (Alpha and CGP-Gamma by tau) and stitched
    into the block-bidiagonal multi-step system: the sub-diagonal couples each
    step's first equation block to the last time dof of the previous step via
    the (negated) RHS columns (reference include/fe_time.h:351-409).

    DG convention quirk kept from the reference: in the *returned* tuple the
    previous-slab coupling sits in Gamma (3rd slot) for DG -- the caller
    constructs the RHS operator as (Gamma_K (x) K + Gamma_M (x) M) with
    Gamma_K = zero, Gamma_M = returned Gamma for DG, while for CGP
    Gamma pairs K and Zeta pairs M (see tests/tp_01.cc:160-168).
    """
    if type_ == TimeStepType.CGP:
        a, b, g, z = split_lhs_rhs_cg(*get_cg_weights(r))
        g = g * time_step_size
    elif type_ == TimeStepType.DG:
        mass, der_jump, jump = get_dg_weights(r)
        a, b = mass.copy(), der_jump.copy()
        g = np.zeros((r + 1, 1))
        z = jump.copy()
    else:
        raise ValueError(f"unsupported time type {type_}")
    a = a * time_step_size

    nt = a.shape[0]
    n = nt * n_timesteps_at_once
    Alpha = np.zeros((n, n))
    Beta = np.zeros((n, n))
    Gamma = np.zeros((n, 1))
    Zeta = np.zeros((n, 1))
    for it in range(n_timesteps_at_once):
        sl = slice(it * nt, (it + 1) * nt)
        Alpha[sl, sl] = a
        Beta[sl, sl] = b
        if it < n_timesteps_at_once - 1:
            col = it * nt + nt - 1
            nsl = slice((it + 1) * nt, (it + 2) * nt)
            Alpha[nsl, col] = -g[:, 0]
            Beta[nsl, col] = -z[:, 0]
    if type_ == TimeStepType.CGP:
        Gamma[:nt, 0] = g[:, 0]
        Zeta[:nt, 0] = z[:, 0]
    else:  # DG: coupling vector lands in the Gamma slot (see docstring)
        Gamma[:nt, 0] = z[:, 0]
        Zeta[:nt, 0] = g[:, 0]
    return Alpha, Beta, Gamma, Zeta


def get_fe_time_weights_wave(type_: TimeStepType, Alpha: np.ndarray,
                             Beta: np.ndarray, Gamma: np.ndarray,
                             Zeta: np.ndarray, n_timesteps_at_once: int = 1):
    """Schur-reduced tables for the 2nd-order (acoustic wave) formulation.

    Starting from the single-interval first-order tables, the velocity
    v = du/dt is eliminated analytically, yielding the u-only system
        (Alpha_lhs (x) K + Beta_lhs (x) M) u = rhs(u_prev, v_prev)
    with Beta_lhs = Beta Alpha^{-1} Beta, plus lower-triangular cross-step
    coupling with geometric decay gxai = Gamma_last/Alpha_last
    (reference include/fe_time.h:157-305).

    Returns (Alpha_lhs, Beta_lhs, rhs_uK, rhs_uM, rhs_vM): the three RHS
    columns multiply {K u_prev, M u_prev, M v_prev} respectively.
    """
    Ainv = np.linalg.inv(Alpha)
    BAiB = Beta @ Ainv @ Beta
    BAiG = Beta @ Ainv @ Gamma
    m = Alpha.shape[0]
    gxai = Gamma[m - 1, 0] / Alpha[m - 1, m - 1]
    GAiG = Gamma * gxai
    beta_last_row = Beta[m - 1:m, :]          # (1, m)
    GAiB = (Gamma @ beta_last_row) / Alpha[m - 1, m - 1]

    nt = m
    n = nt * n_timesteps_at_once
    A_lhs = np.zeros((n, n))
    B_lhs = np.zeros((n, n))
    rhs_uK = np.zeros((n, 1))
    rhs_uM = np.zeros((n, 1))
    rhs_vM = np.zeros((n, 1))

    if type_ == TimeStepType.CGP:
        BAiZ = Beta @ Ainv @ Zeta
        ZmBAiG = Zeta - BAiG
        ZmBAiB = (ZmBAiG @ beta_last_row) / Alpha[m - 1, m - 1]
        zxai = Zeta[m - 1, 0] / Alpha[m - 1, m - 1]
        for it in range(n_timesteps_at_once):
            for jt in range(it + 1):
                ro = it * nt
                co = jt * nt
                if it == 0 and jt == 0:
                    rhs_uK[:nt, 0] = Gamma[:, 0]
                    rhs_uM[:nt, 0] = BAiZ[:, 0]
                    rhs_vM[:nt, 0] = ZmBAiG[:, 0]
                elif jt == 0:
                    rhs_uM[ro:ro + nt, 0] = (-zxai * gxai ** (it - 1)
                                             * ZmBAiG[:, 0])
                    rhs_vM[ro:ro + nt, 0] = gxai ** it * ZmBAiG[:, 0]
                if it == jt + 1:  # first lower block diagonal: column of the
                    # previous step's last dof
                    A_lhs[ro:ro + nt, co + nt - 1] = -Gamma[:, 0]
                    B_lhs[ro:ro + nt, co + nt - 1] += -BAiZ[:, 0]
                if it == jt:
                    A_lhs[ro:ro + nt, co:co + nt] = Alpha
                    B_lhs[ro:ro + nt, co:co + nt] += BAiB
                else:  # strict lower triangle: decaying coupling
                    B_lhs[ro:ro + nt, co:co + nt] += (
                        -gxai ** (it - jt - 1) * ZmBAiB)
                    if it > 1 and it - 1 > jt:
                        B_lhs[ro:ro + nt, co + nt - 1] += (
                            gxai ** (it - jt - 2) * zxai * ZmBAiG[:, 0])
    elif type_ == TimeStepType.DG:
        for it in range(n_timesteps_at_once):
            ro = it * nt
            if it == 0:
                rhs_uM[:nt, 0] = BAiG[:, 0]
                rhs_vM[:nt, 0] = Gamma[:, 0]
            if it == 1:
                rhs_uM[nt:2 * nt, 0] = -GAiG[:, 0]
            if it < n_timesteps_at_once - 1:
                # 1st lower block diagonal
                B_lhs[ro + nt:ro + 2 * nt, ro:ro + nt] += -GAiB
                B_lhs[ro + nt:ro + 2 * nt, ro + nt - 1] += -BAiG[:, 0]
            if it < n_timesteps_at_once - 2:
                # 2nd lower diagonal (column of step it's last dof)
                B_lhs[ro + 2 * nt:ro + 3 * nt, ro + nt - 1] = GAiG[:, 0]
            A_lhs[ro:ro + nt, ro:ro + nt] = Alpha
            B_lhs[ro:ro + nt, ro:ro + nt] += BAiB
    else:
        raise ValueError(f"unsupported time type {type_}")
    return A_lhs, B_lhs, rhs_uK, rhs_uM, rhs_vM


def get_fe_time_weights_sequence(type_: TimeStepType, time_step_size: float,
                                 n_timesteps_at_once: int,
                                 mg_type_level: list[MGType],
                                 poly_time_sequence: list[int],
                                 weight_fn=get_fe_time_weights):
    """Per-MG-level tables, finest last (weight_fn: get_fe_time_weights,
    or get_fe_time_weights_stokes for the saddle-point levels).

    Walking the type ladder from the finest level: a k-level steps to the next
    coarser time degree, a tau-level halves the steps-at-once and doubles tau
    (reference include/fe_time.h:411-442).
    """
    n_levels = len(mg_type_level) + 1
    out: list = [None] * n_levels
    p_it = len(poly_time_sequence) - 1
    n_at_once = n_timesteps_at_once
    tau = time_step_size
    out[-1] = weight_fn(type_, poly_time_sequence[p_it], tau, n_at_once)
    lvl = n_levels - 2
    for mgt in reversed(mg_type_level):
        if mgt == MGType.k:
            p_it -= 1
        elif mgt == MGType.tau:
            n_at_once //= 2
            tau *= 2.0
        out[lvl] = weight_fn(type_, poly_time_sequence[p_it], tau, n_at_once)
        lvl -= 1
    assert lvl == -1
    return out


def get_fe_time_weights_wave_sequence(type_: TimeStepType,
                                      time_step_size: float,
                                      n_timesteps_at_once: int,
                                      mg_type_level: list[MGType],
                                      poly_time_sequence: list[int]):
    """Per-level wave tables (reference include/fe_time.h:444-474).

    Note the single-interval tables feed get_fe_time_weights_wave with the
    level's n_timesteps_at_once folded in by the first-order assembly already,
    hence n_timesteps_at_once=1 in the wave expansion (matching the reference,
    which passes the assembled multi-step Alpha..Zeta).
    """
    fo = get_fe_time_weights_sequence(type_, time_step_size,
                                      n_timesteps_at_once, mg_type_level,
                                      poly_time_sequence)
    return [get_fe_time_weights_wave(type_, a, b, g, z)
            for (a, b, g, z) in fo]


def construct_extrapolation_matrix(type_: TimeStepType, r: int, shift: float,
                                   gradient_penalty: float,
                                   filter_strength: float,
                                   extrapolate_constant: bool = False
                                   ) -> np.ndarray:
    """Predictor matrix evaluating the previous slab's polynomial at shifted
    times, re-expanded in the current basis, with optional gradient penalty
    (I + g D^T D) and modal-index filter 1/(1 + s i^2)
    (stfem_tpu time/tables.py::construct_extrapolation_matrix; reference
    include/fe_time.h:530-616).  Columns: the previous slab's start value,
    then its time dofs (DG); rows: the new slab's time dofs."""
    old_n_dofs = r + 2 if type_ == TimeStepType.DG else r + 1
    if extrapolate_constant:
        new_n_dofs = r + 1 if type_ == TimeStepType.DG else r
        M = np.zeros((new_n_dofs, old_n_dofs))
        M[:, old_n_dofs - 1] = 1.0
        return M
    new_basis = get_time_basis(type_, r)
    new_points, _ = get_time_quad(type_, r)
    old_points = (np.concatenate(([0.0], new_points))
                  if type_ == TimeStepType.DG else new_points)
    M_interp = LagrangeBasis(old_points).eval_matrix(new_points + shift)
    M_extrap = np.linalg.solve(new_basis.eval_matrix(new_points), M_interp)
    # derivative of the new basis at the first r+1 old points (the
    # reference's build_derivative_matrix uses basis.size() points)
    D = new_basis.deriv_matrix(old_points[: r + 1])
    G = np.eye(r + 1) + gradient_penalty * (D.T @ D)
    F = np.diag(1.0 / (1.0 + filter_strength * np.arange(r + 1) ** 2))
    M_extrap = F @ (G @ M_extrap)
    return M_extrap if type_ == TimeStepType.DG else M_extrap[1:, :]


def get_extrapolation_matrix(type_: TimeStepType,
                             nonlinear_extra: NonlinearExtrapolation, r: int,
                             shift: float, gradient_penalty: float,
                             filter_strength: float) -> np.ndarray:
    """The predictor of a NonlinearExtrapolation choice (reference
    include/fe_time.h:618-641): Auto is Constant for r <= 1, else
    Polynomial; LeastSquares has no implementation (ValueError)."""
    if nonlinear_extra == NonlinearExtrapolation.Auto:
        constant = r <= 1
    elif nonlinear_extra == NonlinearExtrapolation.Constant:
        constant = True
    elif nonlinear_extra == NonlinearExtrapolation.Polynomial:
        constant = False
    else:
        raise ValueError(f"no implementation for {nonlinear_extra}")
    return construct_extrapolation_matrix(type_, r, shift, gradient_penalty,
                                          filter_strength, constant)


def get_fe_time_weights_stokes(type_: TimeStepType, r: int,
                               time_step_size: float,
                               n_timesteps_at_once: int = 1):
    """Two-variable (velocity, pressure) saddle-point expansion.

    Alpha couples all (u,p)x(u,p) pairs except p-p; the time derivative Beta
    acts only on u-u; the RHS columns act on the u rows (plus the CGP Gamma on
    the p rows) (reference include/fe_time.h:1242-1325).
    """
    from ..blocks import BlockSlice
    a, b, g, z = get_fe_time_weights(type_, r, time_step_size,
                                     n_timesteps_at_once)
    n = a.shape[0]
    blk = BlockSlice(n_timesteps_at_once, 2,
                     r + 1 if type_ == TimeStepType.DG else r)
    A = np.zeros((2 * n, 2 * n))
    B = np.zeros((2 * n, 2 * n))
    G = np.zeros((2 * n, 1))
    Z = np.zeros((2 * n, 1))
    for iv in range(2):
        rows = blk.get_time(iv)
        for jv in range(2):
            cols = blk.get_time(jv)
            if not (iv == 1 and jv == 1):
                A[np.ix_(rows, cols)] = a
        if iv == 0:
            B[np.ix_(rows, rows)] = b
            G[rows, 0] = g[:, 0]
            Z[rows, 0] = z[:, 0]
        if iv == 1 and type_ == TimeStepType.CGP:
            G[rows, 0] = g[:, 0]
    return A, B, G, Z

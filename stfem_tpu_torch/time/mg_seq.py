"""Multigrid level-ladder logic: which coarsening type (tau/k/h/p) connects
each pair of adjacent levels, and which levels get a real smoother.

Ported from the reference's algorithm (include/fe_time.cc:16-150); oracle:
tests/tp04.output (the reference's 147 PASS asserts, re-expressed in pytest).
"""
from __future__ import annotations

import math

from ..types import (CoarseningType, MGType, PolynomialCoarseningSequenceType,
                     SupportedSmoothers)


def is_space_lvl(mg: MGType) -> bool:
    return mg in (MGType.h, MGType.p)


def is_time_lvl(mg: MGType) -> bool:
    return mg in (MGType.tau, MGType.k)


def create_next_polynomial_coarsening_degree(
        previous_fe_degree: int,
        p_sequence: PolynomialCoarseningSequenceType,
        k_min: int = 0) -> int:
    if p_sequence == PolynomialCoarseningSequenceType.bisect:
        return max(previous_fe_degree // 2, k_min)
    if p_sequence == PolynomialCoarseningSequenceType.decrease_by_one:
        return max(previous_fe_degree - 1, k_min)
    if p_sequence == PolynomialCoarseningSequenceType.go_to_one:
        return k_min
    raise ValueError(p_sequence)


def get_poly_mg_sequence(k_max: int, k_min: int,
                         p_seq: PolynomialCoarseningSequenceType) -> list[int]:
    """Increasing degree ladder [k_min, ..., k_max]
    (reference include/fe_time.cc:40-56)."""
    degrees = [k_max]
    if degrees[-1] == k_min:
        return degrees
    while degrees[-1] > k_min:
        degrees.append(create_next_polynomial_coarsening_degree(
            degrees[-1], p_seq, k_min))
    return degrees[::-1]


def get_mg_sequence(n_sp_lvl: int,
                    k_seq: list[int],
                    p_seq: list[int],
                    n_timesteps_at_once: int,
                    n_timesteps_at_once_min: int = 1,
                    lower_lvl: MGType = MGType.k,
                    coarsening_type: CoarseningType =
                    CoarseningType.space_and_time,
                    time_before_space: bool = False,
                    use_p_multigrid_space: bool = False,
                    zip_from_back: bool = True) -> list[MGType]:
    """Level-type ladder ordered coarse -> fine; entry i is the transfer type
    between levels i and i+1 (reference include/fe_time.cc:58-127)."""
    assert n_sp_lvl >= 1 and len(k_seq) >= 1
    n_k_lvl = len(k_seq) - 1
    n_t_lvl = int(math.log2(n_timesteps_at_once // n_timesteps_at_once_min))
    upper_lvl = MGType.tau if lower_lvl == MGType.k else MGType.k
    lower_lvl_s = MGType.p if lower_lvl == MGType.k else MGType.h
    upper_lvl_s = MGType.h if lower_lvl == MGType.k else MGType.p
    n_ll = n_k_lvl if lower_lvl == MGType.k else n_t_lvl
    n_ul = n_t_lvl if lower_lvl == MGType.k else n_k_lvl
    # With an empty p_seq and p-MG enabled the p-ladder mirrors the k-ladder
    # (one p level per k level) -- the behavior pinned by tests/tp04.output.
    if use_p_multigrid_space:
        n_p_lvl = (len(p_seq) - 1) if p_seq else n_k_lvl
    else:
        n_p_lvl = 0
    n_ll_s = n_p_lvl if lower_lvl == MGType.k else n_sp_lvl - 1
    n_ul_s = (n_sp_lvl - 1) if lower_lvl == MGType.k else n_p_lvl

    time_levels = [lower_lvl] * n_ll + [upper_lvl] * n_ul
    space_levels = [lower_lvl_s] * n_ll_s + [upper_lvl_s] * n_ul_s

    out: list[MGType] = []
    if coarsening_type == CoarseningType.space_or_time:
        first = time_levels if time_before_space else space_levels
        second = space_levels if time_before_space else time_levels
        if zip_from_back:
            out = first[::-1] + second[::-1]
        else:
            out = first + second
    else:
        tsz, ssz = len(time_levels), len(space_levels)

        def get(levels, i):
            return levels[len(levels) - 1 - i] if zip_from_back else levels[i]

        for i in range(max(tsz, ssz)):
            if i < (tsz if time_before_space else ssz):
                out.append(get(time_levels if time_before_space
                               else space_levels, i))
            if i < (ssz if time_before_space else tsz):
                out.append(get(space_levels if time_before_space
                               else time_levels, i))
        if zip_from_back:
            out.reverse()
    return out


def get_precondition_stmg_types(
        mg_type_level: list[MGType],
        coarsening_type: CoarseningType,
        time_before_space: bool,
        zip_from_back: bool = True,
        smoother: SupportedSmoothers = SupportedSmoothers.Relaxation
) -> list[SupportedSmoothers]:
    """Per-level smoother types; when consecutive time/space levels pair up in
    space_and_time mode, the upper one of the pair gets Identity
    (reference include/fe_time.cc:129-150)."""
    ret = [smoother] * (len(mg_type_level) + 1)
    if coarsening_type == CoarseningType.space_or_time:
        return ret
    i = 0
    while i < len(mg_type_level) - 1:
        a, b = mg_type_level[i], mg_type_level[i + 1]
        pair = (is_space_lvl(a) and is_time_lvl(b)) if time_before_space \
            else (is_time_lvl(a) and is_space_lvl(b))
        if pair:
            ret[i] = smoother
            ret[i + 1] = SupportedSmoothers.Identity
            i += 1
        i += 1
    return ret

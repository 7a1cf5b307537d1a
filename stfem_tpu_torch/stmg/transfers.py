"""Inter-level transfer operators (counterpart of
stfem_tpu/stmg/transfers.py).

Space transfers (h and p) are separable on tensor-product grids: one dense
1D matrix per axis with Dirichlet masks on both levels.  Time transfers
(k and tau) are small dense matrices over the block axis.  Time
restriction is the transpose of prolongation (restrict_is_transpose_
prolongate, the reference default, parameters.h:29) or, with that flag
off, the interpolation down (the L2 projection for k, the two-interval
restriction for tau).

On levels split over ranks (stmg/gmg.py::distribute_gmg) the time
transfers are block-local and stay as they are; a space transfer becomes
a ShardedSpaceTransfer, whose matrices and masks are the global ones'
slices for the rank's dofs.  Prolongation of a consistent coarse slab is
consistent as it is (a fine dof on a shared face interpolates from the
coarse dofs on that face).  Restriction counts a shared fine plane once
per rank, so its input is weighted by the interface weights first and
the coarse result accumulated; into a replicated coarse level the
weighted partial results over the whole coarse grid are summed in one
all-reduce.

Every restriction and prolongation is the tracer's span transfer.restrict
or transfer.prolongate (utils/timer.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..mesh.fe import p_interpolation_1d, prolongation_1d
from ..ops.gridsumfac import axis_apply, promote
from ..parallel.comm import all_reduce
from ..time.transfer import (get_time_projection_matrix,
                             get_time_prolongation_matrix,
                             get_time_restriction_matrix)
from ..types import MGType, TimeStepType
from ..utils.timer import span


def h_prolongation_global_1d(n_coarse_cells: int, degree: int) -> np.ndarray:
    """Global 1D h-prolongation (n_fine_dofs, n_coarse_dofs)."""
    k = degree
    P1 = prolongation_1d(degree)         # (2k+1, k+1)
    P = np.zeros((2 * n_coarse_cells * k + 1, n_coarse_cells * k + 1))
    for c in range(n_coarse_cells):
        P[2 * c * k:2 * (c + 1) * k + 1, c * k:(c + 1) * k + 1] = P1
    return P


def p_prolongation_global_1d(n_cells: int, degree_coarse: int,
                             degree_fine: int) -> np.ndarray:
    """Global 1D p-prolongation on the same cells."""
    Pc = p_interpolation_1d(degree_coarse, degree_fine)  # (kf+1, kc+1)
    kf, kc = degree_fine, degree_coarse
    P = np.zeros((n_cells * kf + 1, n_cells * kc + 1))
    for c in range(n_cells):
        P[c * kf:(c + 1) * kf + 1, c * kc:(c + 1) * kc + 1] = Pc
    return P


class SpaceTransfer:
    """Separable space transfer: per-axis 1D matrices + Dirichlet masks."""

    def __init__(self, P1d_per_axis, fine_mask, coarse_mask,
                 dtype=torch.float64, device="cuda"):
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                         device=device)
        self.P = [as_t(P) for P in P1d_per_axis]
        self.fine_mask = as_t(fine_mask)
        self.coarse_mask = as_t(coarse_mask)
        self.dim = len(P1d_per_axis)

    def _apply_axes(self, x, mats):
        for d, m in enumerate(mats):
            x = axis_apply(m, x, x.ndim - len(mats) + d)
        return x

    def prolongate(self, xc):
        with span("transfer.prolongate"):
            return self._apply_axes(xc * self.coarse_mask, self.P) \
                * self.fine_mask

    def restrict(self, xf):
        with span("transfer.restrict"):
            return self._apply_axes(xf * self.fine_mask,
                                    [p.T for p in self.P]) * self.coarse_mask

    def shard(self, layout, fine_cells, fine_degree: int, coarse_cells,
              coarse_degree: int, coarse_replicated: bool = False):
        """The rank's transfer (a ShardedSpaceTransfer) between its slab
        of the fine level (cells per axis fine_cells, degree fine_degree)
        and its slab of the coarse level, or the whole coarse level when
        that is replicated.  layout: parallel/sharding.py::RankLayout."""
        rf = layout.cell_ranges(fine_cells)
        rc = layout.cell_ranges(coarse_cells)
        kf, kc = fine_degree, coarse_degree
        fine = [slice(lo * kf, hi * kf + 1) for lo, hi in rf]
        coarse = [slice(None) if coarse_replicated
                  else slice(lo * kc, hi * kc + 1) for lo, hi in rc]
        P = [p[f, c].contiguous() for p, f, c in zip(self.P, fine, coarse)]
        return ShardedSpaceTransfer(
            P, self.fine_mask[tuple(fine)], self.coarse_mask[tuple(coarse)],
            layout, coarse_replicated)


class ShardedSpaceTransfer(SpaceTransfer):
    """A SpaceTransfer between a rank's consistent fine slab and its
    coarse slab (or the replicated coarse level): restriction weights the
    fine slab by the interface weights, applies the local P^T and
    accumulates the coarse partial sums (or all-reduces them over the
    whole coarse grid)."""

    def __init__(self, P, fine_mask, coarse_mask, layout,
                 coarse_replicated: bool):
        self.P = P
        self.coarse_mask = coarse_mask
        self.dim = len(P)
        self.layout = layout
        self.coarse_replicated = coarse_replicated
        w = layout.weights((1,) + tuple(fine_mask.shape), fine_mask.dtype,
                           fine_mask.device)[0]
        self.fine_mask = fine_mask
        self.fine_weighted = fine_mask * w

    def restrict(self, xf):
        with span("transfer.restrict"):
            yc = self._apply_axes(xf * self.fine_weighted,
                                  [p.T for p in self.P]) * self.coarse_mask
            if self.coarse_replicated:
                return all_reduce(yc, None)
            return self.layout.accumulate(yc)


class TimeTransfer:
    """Dense block-axis transfer (k- or tau-type); restriction is the
    transpose of prolongation, or with restrict_is_transpose_prolongate
    False the interpolation down."""

    def __init__(self, type_: TimeStepType, mg_type: MGType,
                 nt_dofs_hi: int, nt_dofs_lo: int, n_timesteps_hi: int,
                 restrict_is_transpose_prolongate: bool = True,
                 dtype=torch.float64, device="cuda"):
        if type_ == TimeStepType.DG:
            r_hi, r_lo = nt_dofs_hi - 1, nt_dofs_lo - 1
        else:
            r_hi, r_lo = nt_dofs_hi, nt_dofs_lo
        if mg_type == MGType.k:
            prol = get_time_projection_matrix(type_, r_lo, r_hi,
                                              n_timesteps_hi)
        elif mg_type == MGType.tau:
            prol = get_time_prolongation_matrix(type_, r_hi, n_timesteps_hi)
        else:
            raise ValueError(mg_type)
        self.prol = torch.as_tensor(prol, dtype=dtype, device=device)
        if restrict_is_transpose_prolongate:
            self.restr = self.prol.T
        else:
            down = (get_time_projection_matrix(type_, r_hi, r_lo,
                                               n_timesteps_hi)
                    if mg_type == MGType.k else
                    get_time_restriction_matrix(type_, r_hi, n_timesteps_hi))
            self.restr = torch.as_tensor(down, dtype=dtype, device=device)

    @staticmethod
    def _mix(T, x):
        T, x = promote(T, x)
        return torch.einsum("ij,j...->i...", T, x)

    def prolongate(self, xc):
        with span("transfer.prolongate"):
            return self._mix(self.prol, xc)

    def restrict(self, xf):
        with span("transfer.restrict"):
            return self._mix(self.restr, xf)

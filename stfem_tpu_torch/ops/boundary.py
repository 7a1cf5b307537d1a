"""Strong inhomogeneous time-dependent Dirichlet values (counterpart of
stfem_tpu/ops/boundary.py; reference include/operators.h:2168-2222,
tests/tp_03stokes.cc:1022-1063).

Per slab the reference interpolates the Dirichlet function g at every
(timestep, time-dof) quadrature time into per-block boundary values,
zeroes the constrained entries before the solve and pastes the values
after.  Its matrix-free operators read constrained dofs as zero, so the
boundary data never feeds the interior equations: faithful where g = 0
on the boundary, but it decouples the interior for truly inhomogeneous
data, so the drivers also offer the consistent lift rhs -= A x_g on the
interior rows (integrators.py::TimeIntegratorFO,
drivers/stokes.py::run_lid_driven).  Block time: t0 + dt it + dt
qt[shift + id], shift 0 for DG (Radau points) and 1 for CGP (Lobatto
points, skipping the interval start, which belongs to the previous
step)."""
from __future__ import annotations

import numpy as np
import torch

from ..time.tables import get_time_quad
from ..types import TimeStepType


def slab_time_offsets(type_: TimeStepType, time_degree: int,
                      time_step: float, n_timesteps_at_once: int):
    """Offsets from the slab start of each block's Dirichlet evaluation
    time, in block order (reference operators.h:2196-2210)."""
    qt = np.asarray(get_time_quad(type_, time_degree)[0], float)
    shift = 0 if type_ == TimeStepType.DG else 1
    nt = time_degree + 1 if type_ == TimeStepType.DG else time_degree
    return np.array([time_step * it + time_step * qt[shift + idx]
                     for it in range(n_timesteps_at_once)
                     for idx in range(nt)])


class SlabBoundaryValues:
    """g on the boundary dofs at every block time of a slab.

    g(coords, t) takes the dof coordinates [*dof_shape, dim] (a float64
    tensor on `device`) and a time, and returns the dof field (scalar
    problems [*dof_shape], vector ones [n_comp, *dof_shape]).  mask is the
    operator's elimination mask (1 free, 0 constrained); the values live
    on its complement."""

    def __init__(self, mesh, degree: int, g, type_: TimeStepType,
                 time_degree: int, time_step: float,
                 n_timesteps_at_once: int, mask=None, dtype=torch.float64,
                 device="cuda"):
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                         device=device)
        self.mask = as_t(mesh.boundary_dof_mask(degree) if mask is None
                         else mask)
        self.bnd = 1.0 - self.mask
        self.coords = as_t(mesh.dof_coordinates(degree))
        self.g = g
        self.offsets = slab_time_offsets(type_, time_degree, time_step,
                                         n_timesteps_at_once)

    def blocks(self, time: float) -> torch.Tensor:
        """[n_blocks, *field_shape]: g at each block time, zero off the
        constrained dofs."""
        return torch.stack([self.g(self.coords, time + float(dt)) * self.bnd
                            for dt in self.offsets])

    def set_zero(self, x: torch.Tensor) -> torch.Tensor:
        """Reference set_inhomogeneity_zero (operators.h:2133-2143)."""
        return x * self.mask

    def paste(self, x: torch.Tensor, blocks: torch.Tensor) -> torch.Tensor:
        """Reference set_inhomogeneity (operators.h:2121-2131)."""
        return x * self.mask + blocks

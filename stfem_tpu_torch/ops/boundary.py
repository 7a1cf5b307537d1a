"""Block times of strong time-dependent Dirichlet data (counterpart of
stfem_tpu/ops/boundary.py::slab_time_offsets; reference
include/operators.h:2168-2222, tests/tp_03stokes.cc:1022-1063).

Per slab the reference interpolates the Dirichlet function g at every
(timestep, time-dof) quadrature time into per-block boundary values,
zeroes the constrained entries before the solve and pastes the values
after; drivers/stokes.py::run_lid_driven does so for the strong lid, with
or without the consistent lift rhs -= A x_g.  Block time:
t0 + dt it + dt qt[shift + id], shift 0 for DG (Radau points) and 1 for
CGP (Lobatto points, skipping the interval start, which belongs to the
previous step)."""
from __future__ import annotations

import numpy as np

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

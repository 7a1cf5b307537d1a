"""Flat block index <-> (timestep, variable, timedof) mapping (copy of
stfem_tpu/blocks.py).

A space-time block vector is ONE dense array with a leading
block axis of length n_blocks = n_timesteps_at_once * n_variables * n_timedofs;
this module provides the index arithmetic connecting that axis to the
(timestep, variable, timedof) triple (reference include/fe_time.h:901-1221).

Unlike the reference there is no global variable-major switch; variable_major
is an explicit constructor argument (default True, the reference's default).
"""
from __future__ import annotations

import numpy as np


class BlockSlice:
    """Index helper over the block axis (reference BlockSlice/block_indexing)."""

    def __init__(self, n_timesteps_at_once: int = 1, n_variables: int = 1,
                 n_timedofs: int = 1, variable_major: bool = True):
        self.n_timesteps_at_once = n_timesteps_at_once
        self.n_variables = n_variables
        self.n_timedofs = n_timedofs
        self.variable_major = variable_major

    @property
    def n_blocks(self) -> int:
        return self.n_timesteps_at_once * self.n_variables * self.n_timedofs

    def index(self, timestep: int, variable: int, timedof: int) -> int:
        nv, nd = self.n_variables, self.n_timedofs
        if self.variable_major:
            return timestep * (nv * nd) + variable * nd + timedof
        return timestep * (nv * nd) + timedof * nv + variable

    def decompose(self, index: int) -> tuple[int, int, int]:
        nv, nd = self.n_variables, self.n_timedofs
        timestep, rem = divmod(index, nv * nd)
        if self.variable_major:
            variable, timedof = divmod(rem, nd)
        else:
            timedof, variable = divmod(rem, nv)
        return timestep, variable, timedof

    def get_variable(self, timestep: int, timedof: int) -> np.ndarray:
        """Block indices of all variables at one (timestep, timedof)."""
        return np.array([self.index(timestep, v, timedof)
                         for v in range(self.n_variables)], dtype=np.int32)

    def get_time(self, variable: int) -> np.ndarray:
        """Block indices of one variable over all (timestep, timedof)."""
        return np.array([self.index(ts, variable, td)
                         for ts in range(self.n_timesteps_at_once)
                         for td in range(self.n_timedofs)], dtype=np.int32)

    def __repr__(self) -> str:
        return (f"BlockSlice(n_timesteps_at_once={self.n_timesteps_at_once}, "
                f"n_variables={self.n_variables}, "
                f"n_timedofs={self.n_timedofs}, "
                f"variable_major={self.variable_major})")

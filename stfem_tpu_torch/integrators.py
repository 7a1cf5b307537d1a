"""Spatial right-hand-side assembly (counterpart of
stfem_tpu/integrators.py::ForceAssembler; the time integrator classes are
not ported -- the heat driver is bench_heat.py)."""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from .mesh.fe import shape_data_1d
from .mesh.grid import StructuredMesh
from .ops.spatial import _sumfac, cell_scatter
from .utils.precision import full_precision


class ForceAssembler:
    """F_i(t) = int f(x, t) phi_i dx on the Q_degree dof grid, with
    constrained dofs zeroed (reference include/time_integrators.h:73-110).
    rhs_fn(pts, t) takes pts [..., dim] and a time that broadcasts against
    pts[..., 0]."""

    def __init__(self, mesh: StructuredMesh, degree: int, n_q: int,
                 rhs_fn: Callable, mask, dtype=torch.float64, device="cpu"):
        self.mesh = mesh
        self.degree = degree
        self.dim = mesh.dim
        self.dtype = dtype
        self.device = torch.device(device)
        as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=self.device)
        self.S = as_t(shape_data_1d(degree, n_q).S)
        self.jxw = as_t(mesh.geometry(n_q).jxw)
        self.coords = as_t(mesh.quad_coordinates(n_q))
        self.rhs_fn = rhs_fn
        self.mask = as_t(np.asarray(mask))

    def _integrate(self, fq):
        y = _sumfac([self.S] * self.dim, fq, self.dim, forward=False)
        return cell_scatter(y, self.mesh.cells, self.degree) * self.mask

    def __call__(self, t) -> torch.Tensor:
        with full_precision():
            return self._integrate(self.rhs_fn(self.coords, t) * self.jxw)

    def batched(self, ts: torch.Tensor, scales: torch.Tensor):
        """F for a whole slab: ts/scales of shape (n_blocks,) ->
        (n_blocks, *dofshape) in one integrate + scatter sweep."""
        lead = (-1,) + (1,) * (2 * self.dim)
        with full_precision():
            fq = self.rhs_fn(self.coords, ts.reshape(lead))
            fq = fq * self.jxw * scales.reshape(lead)
            return self._integrate(fq)

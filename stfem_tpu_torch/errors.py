"""Space-time error norms L2(L2), Linf(Linf) and L2(H1-semi) of a slab
solution against an exact solution (counterpart of stfem_tpu/errors.py;
the reference's ErrorCalculator, include/exact_solution.h:503-649).

For each time step of the slab and each Gauss point t_q of
QGauss(time_degree + 1) on the step, u_h(t_q) is reconstructed from the
slab's blocks (a CGP step prepends its start value), evaluated at the
tensor Gauss points of every cell, and compared with the exact solution:
    err_L2  += tau w_q ||e||_L2^2,   err_Linf = max |e|,
    err_H1  += tau w_q |e|_H1^2.
All time points of a slab go through one batched sum-factorised pass on
the tensors' device, in float64; each norm is a 0-d tensor (no host sync).
The physical gradients follow stfem_tpu's three geometry paths: one
diagonal inverse Jacobian (uniform, also masked), per-cell inverse steps
(axis steps), or full inverse Jacobians at every quadrature point
(distorted, Q1-mapped or exactly mapped cells).
"""
from __future__ import annotations

import numpy as np
import torch

from .mesh.fe import shape_data_1d
from .mesh.grid import StructuredMesh
from .ops.spatial import _sumfac, cell_gather, geometry_factors
from .time.quadrature import gauss
from .time.tables import get_time_basis
from .types import TimeStepType

__all__ = ["ErrorCalculator", "SpatialEvaluator"]


class SpatialEvaluator:
    """Values and physical gradients of a dof-grid field [..., *dofshape] at
    the tensor Gauss points, [..., *cells, *q] and [..., *cells, *q, dim]
    (stfem_tpu/errors.py::SpatialEvaluator, all three geometry paths)."""

    def __init__(self, mesh: StructuredMesh, degree: int, n_q: int,
                 dtype=torch.float64, device="cuda"):
        geom = mesh.geometry(n_q)
        self.mesh, self.degree, self.n_q, self.dim = mesh, degree, n_q, \
            mesh.dim
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype,
                                         device=device)
        sd = shape_data_1d(degree, n_q)
        self.S, self.D = as_t(sd.S), as_t(sd.D)
        self.jxw = as_t(geom.jxw)
        # jinv[..., e, d] = d xi_e / d x_d, or per-axis factors jfac[e]
        self.jfac, self.jinv = geometry_factors(geom, mesh.cells, dtype,
                                                device)
        self.coords = as_t(mesh.quad_coordinates(n_q))

    def _ref(self, uc, e=None):
        mats = [self.D if d == e else self.S for d in range(self.dim)]
        return _sumfac(mats, uc, self.dim)

    def values(self, u: torch.Tensor) -> torch.Tensor:
        return self._ref(cell_gather(u, self.mesh.cells, self.degree))

    def gradients(self, u: torch.Tensor) -> torch.Tensor:
        uc = cell_gather(u, self.mesh.cells, self.degree)
        ref = [self._ref(uc, e) for e in range(self.dim)]
        if self.jinv is not None:
            # d u / d x_d = sum_e (d u / d xi_e) jinv[..., e, d]
            return torch.einsum("...e,...ed->...d", torch.stack(ref, -1),
                                self.jinv)
        return torch.stack([ref[e] * self.jfac[e] for e in range(self.dim)],
                           dim=-1)


class ErrorCalculator:
    """The reference's ErrorCalculator for scalar fields.  n_q: the spatial
    Gauss points per axis (the reference passes fe_degree + 1, i.e. it
    under-integrates, tp_01.cc:809-815; default space_degree + 1)."""

    def __init__(self, mesh: StructuredMesh, type_: TimeStepType,
                 time_degree: int, space_degree: int, exact_fn,
                 exact_grad_fn, dtype=torch.float64, n_q: int | None = None,
                 device="cuda"):
        self.type_ = type_
        self.nt_dofs = (time_degree + 1 if type_ == TimeStepType.DG
                        else time_degree)
        self.tq, self.tw = gauss(time_degree + 1)
        # basis values at the time quadrature points, (n_tq, basis size)
        self.phi = torch.as_tensor(
            get_time_basis(type_, time_degree).eval_matrix(self.tq),
            dtype=dtype, device=device)
        self.ev = SpatialEvaluator(mesh, space_degree,
                                   space_degree + 1 if n_q is None else n_q,
                                   dtype, device)
        self.exact_fn, self.exact_grad_fn = exact_fn, exact_grad_fn

    def reconstruct(self, x: torch.Tensor, prev: torch.Tensor,
                    n_timesteps_at_once: int) -> torch.Tensor:
        """u_h at every time quadrature point of every step of the slab,
        [steps, n_tq, *dofshape] (reference tp_01.cc:409-432): the basis
        coefficients of step s are its blocks, after (CGP) the step's
        start value -- prev for the first step, else the previous step's
        last block."""
        S, nt = n_timesteps_at_once, self.nt_dofs
        coef = x.reshape((S, nt) + x.shape[1:])
        if self.type_ == TimeStepType.CGP:
            start = torch.cat([prev[None], coef[:-1, -1]])
            coef = torch.cat([start[:, None], coef], dim=1)
        return torch.einsum("qi,si...->sq...", self.phi, coef)

    def evaluate_error(self, time: float, time_step: float, x: torch.Tensor,
                       prev: torch.Tensor, n_timesteps_at_once: int) -> dict:
        """{"l2": squared and time-integrated, "linf", "h1_semi": squared},
        each a 0-d tensor on x's device."""
        S = n_timesteps_at_once
        u = self.reconstruct(x, prev, S).flatten(0, 1)
        ts = (time + time_step * (np.arange(S)[:, None] + self.tq[None, :])
              ).reshape(-1)
        lead = (-1,) + (1,) * (2 * self.ev.dim)
        t = torch.as_tensor(ts, dtype=u.dtype, device=u.device).reshape(lead)
        wt = torch.as_tensor(np.tile(time_step * self.tw, S), dtype=u.dtype,
                             device=u.device)
        diff = self.ev.values(u) - self.exact_fn(self.ev.coords, t)
        gdiff = self.ev.gradients(u) - self.exact_grad_fn(self.ev.coords, t)
        sp = tuple(range(1, diff.ndim))
        l2 = wt @ torch.sum(self.ev.jxw * diff ** 2, dim=sp)
        h1 = wt @ torch.sum(self.ev.jxw * torch.sum(gdiff ** 2, dim=-1),
                            dim=sp)
        return {"l2": l2, "linf": diff.abs().amax(), "h1_semi": h1}

"""Point probes and the functionals file (counterpart of
stfem_tpu/utils/probes.py; reference tests/tp_01.cc:449-481, 584-635).

On a structured Cartesian mesh a physical point maps to (cell, reference
coordinates) arithmetically, so a point value is a (k+1)^dim contraction
of the owning cell's dofs: only those dofs leave the device.  Probes on
distorted meshes are not ported."""
from __future__ import annotations

import numpy as np
import torch

from ..mesh.fe import q_nodes_1d
from ..mesh.grid import StructuredMesh
from ..time.quadrature import LagrangeBasis
from ..time.tables import get_time_basis, get_time_evaluation_matrix
from ..types import TimeStepType


class PointEvaluator:
    """Evaluate a dof-grid field at fixed physical points."""

    def __init__(self, mesh: StructuredMesh, degree: int, points):
        self.mesh, self.degree = mesh, degree
        self.points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        basis = LagrangeBasis(np.asarray(q_nodes_1d(degree)))
        self.cells_of_point, self.weights = [], []
        for p in self.points:
            ci, w = [], []
            for d in range(mesh.dim):
                c = int(np.clip((p[d] - mesh.lower[d]) / mesh.h[d], 0,
                                mesh.cells[d] - 1))
                xi = (p[d] - mesh.lower[d]) / mesh.h[d] - c
                ci.append(c)
                w.append(basis.eval_matrix(np.array([xi]))[0])
            self.cells_of_point.append(ci)
            self.weights.append(w)

    def tensor(self, u: torch.Tensor) -> torch.Tensor:
        """u: [..., *dofshape] tensor -> [..., n_points] on u's device
        (no host read-back: a caller batches a row of functionals)."""
        k, dim = self.degree, self.mesh.dim
        out = []
        for ci, w in zip(self.cells_of_point, self.weights):
            loc = u[(Ellipsis,) + tuple(slice(c * k, c * k + k + 1)
                                        for c in ci)]
            for d in reversed(range(dim)):     # contract the last axis
                loc = loc @ torch.as_tensor(w[d], dtype=u.dtype,
                                            device=u.device)
            out.append(loc)
        return torch.stack(out, dim=-1)

    def __call__(self, u) -> np.ndarray:
        """u: [..., *dofshape] (tensor or array) -> [..., n_points] float64
        numpy values."""
        k, dim = self.degree, self.mesh.dim
        out = []
        for ci, w in zip(self.cells_of_point, self.weights):
            sl = (Ellipsis,) + tuple(slice(c * k, c * k + k + 1) for c in ci)
            loc = u[sl]
            if torch.is_tensor(loc):
                loc = loc.detach().cpu().double().numpy()
            loc = np.asarray(loc, np.float64)
            nb = loc.ndim - dim
            for d in range(dim):     # axis nb is always the next local axis
                loc = np.tensordot(loc, w[d], axes=([nb], [0]))
            out.append(loc)
        return np.stack(out, axis=-1)


class FunctionalsWriter:
    """Appends time-resampled point values to a functionals file in the
    reference's format (tp_01.cc:618-631): per sample row
    't  v(p1) v(p2) ...' in scientific notation, blank line between
    steps."""

    def __init__(self, path: str, type_: TimeStepType, time_degree: int,
                 samples_per_interval: int | None = None):
        self.path = path
        self.is_cgp = type_ == TimeStepType.CGP
        if samples_per_interval is None:
            samples_per_interval = (time_degree + 1) ** 2
        self.samples = samples_per_interval
        self.evaluator = get_time_evaluation_matrix(
            get_time_basis(type_, time_degree), samples_per_interval)

    def write_step(self, time: float, time_step: float,
                   values_per_tdof: np.ndarray,
                   prev_values: np.ndarray | None = None):
        """values_per_tdof: (nt_dofs, n_points) point values of the step's
        time dofs; prev_values: values at the step start (CGP only)."""
        vals = np.asarray(values_per_tdof)
        if self.is_cgp:
            assert prev_values is not None
            vals = np.vstack([np.atleast_2d(prev_values), vals])
        res = self.evaluator @ vals               # (samples, n_points)
        step = 1.0 / (self.samples - 1)
        with open(self.path, "a") as f:
            for row in range(res.shape[0]):
                f.write(f"{time + time_step * row * step:16.6e}")
                for c in range(res.shape[1]):
                    f.write(f" {res[row, c]:16.6e}")
                f.write("\n")
            f.write("\n")

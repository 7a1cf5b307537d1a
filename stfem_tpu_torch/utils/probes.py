"""Point probes and the functionals file (counterpart of
stfem_tpu/utils/probes.py; reference tests/tp_01.cc:449-481, 584-635).

On a structured Cartesian mesh a physical point maps to (cell, reference
coordinates) arithmetically; on a mesh with explicit (distorted or
Q1-mapped) vertices a per-cell Newton inversion of the Q1 cell map finds
them, once, on the host.  A point value is then a (k+1)^dim contraction
of the owning cell's dofs: only those dofs leave the device."""
from __future__ import annotations

import numpy as np
import torch

from ..mesh.fe import q_nodes_1d
from ..mesh.grid import StructuredMesh
from ..time.quadrature import LagrangeBasis
from ..time.tables import get_time_basis, get_time_evaluation_matrix
from ..types import TimeStepType


def locate_in_distorted(mesh: StructuredMesh, p: np.ndarray):
    """(cell index tuple, reference coordinates) of a physical point on a
    mesh with explicit vertices: Newton inversion of each candidate cell's
    Q1 (multilinear) map, the nearest undistorted cell first, then all
    cells in order (stfem_tpu/utils/probes.py:19-57; the replacement for
    the reference's RemotePointEvaluation search, tp_01.cc:455-456)."""
    dim = mesh.dim
    verts = mesh.vertices
    corners_b = list(np.ndindex(*((2,) * dim)))
    guess = tuple(int(np.clip((p[d] - mesh.lower[d]) / mesh.h[d], 0,
                              mesh.cells[d] - 1)) for d in range(dim))
    cands = [guess] + [c for c in np.ndindex(*mesh.cells) if c != guess]
    for cidx in cands:
        V = np.stack([verts[tuple(np.add(cidx, b))] for b in corners_b])
        xi = np.full(dim, 0.5)
        ok = False
        for _ in range(30):
            w = np.ones(len(corners_b))
            dw = np.ones((dim, len(corners_b)))
            for d in range(dim):
                f = np.array([xi[d] if b[d] else 1.0 - xi[d]
                              for b in corners_b])
                g = np.array([1.0 if b[d] else -1.0 for b in corners_b])
                w = w * f
                for e in range(dim):
                    dw[e] = dw[e] * (g if e == d else f)
            J = dw @ V                      # (dim_xi, dim_x)
            try:
                dxi = np.linalg.solve(J.T, p - w @ V)
            except np.linalg.LinAlgError:
                break
            xi = xi + dxi
            if np.linalg.norm(dxi) < 1e-13:
                ok = True
                break
        if ok and np.all(xi > -1e-10) and np.all(xi < 1 + 1e-10):
            return cidx, np.clip(xi, 0.0, 1.0)
    raise ValueError(f"probe point {p} not found in the distorted mesh")


class PointEvaluator:
    """Evaluate a dof-grid field at fixed physical points (Cartesian
    meshes: arithmetic cell lookup; explicit vertices: Newton inversion of
    the Q1 cell map, consistent with dof_coordinates' Q1 node
    placement)."""

    def __init__(self, mesh: StructuredMesh, degree: int, points):
        self.mesh, self.degree = mesh, degree
        self.points = np.atleast_2d(np.asarray(points, dtype=np.float64))
        basis = LagrangeBasis(np.asarray(q_nodes_1d(degree)))
        self.cells_of_point, self.weights = [], []
        for p in self.points:
            if mesh.vertices is not None:
                ci, xi = locate_in_distorted(mesh, p)
                ci = list(ci)
            else:
                ci, xi = [], []
                for d in range(mesh.dim):
                    c = int(np.clip((p[d] - mesh.lower[d]) / mesh.h[d], 0,
                                    mesh.cells[d] - 1))
                    ci.append(c)
                    xi.append((p[d] - mesh.lower[d]) / mesh.h[d] - c)
            self.cells_of_point.append(ci)
            self.weights.append([basis.eval_matrix(np.array([xi[d]]))[0]
                                 for d in range(mesh.dim)])

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

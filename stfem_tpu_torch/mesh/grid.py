"""Structured hex meshes of a hyper-rectangle [lower, upper] (counterpart
of stfem_tpu/mesh/grid.py, uniform case only).

DoF indexing is pure arithmetic on a tensor grid; the mesh is {cell counts,
bounding box}.  Only the uniform axis-aligned hyper-rectangle is ported:
every cell has the same diagonal Jacobian, so the geometry is one constant
quadrature-weight tensor plus the per-axis inverse cell widths.  Distorted
vertices, cell masks, non-uniform axis steps and vertex maps are not
ported yet (see ROADMAP.md).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .fe import q_nodes_1d, shape_data_1d


@dataclass(frozen=True)
class Geometry:
    """Quadrature-point geometry of a uniform Cartesian mesh: jxw is
    (q1,..,qd) (the same in every cell), jinv_diag is (dim,)."""
    jxw: np.ndarray
    jinv_diag: np.ndarray


class StructuredMesh:
    """Uniform tensor-product mesh of a hyper-rectangle (reference
    GridGenerator::subdivided_hyper_rectangle + global refinement)."""

    def __init__(self, subdivisions, lower, upper, refinement: int = 0):
        self.dim = len(subdivisions)
        self.subdivisions = tuple(int(s) for s in subdivisions)
        self.lower = np.asarray(lower, dtype=np.float64)
        self.upper = np.asarray(upper, dtype=np.float64)
        self.refinement = int(refinement)
        self.cells = tuple(s * 2 ** refinement for s in self.subdivisions)
        self.h = (self.upper - self.lower) / np.array(self.cells)

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.cells))

    def n_dofs(self, degree: int) -> int:
        return int(np.prod(self.dof_shape(degree)))

    def dof_shape(self, degree: int) -> tuple[int, ...]:
        """Continuous Q_degree dof grid (lexicographic per axis)."""
        return tuple(c * degree + 1 for c in self.cells)

    def axis_vertices(self, d: int) -> np.ndarray:
        """1D vertex positions along axis d."""
        return self.lower[d] + self.h[d] * np.arange(self.cells[d] + 1)

    def geometry(self, n_q_per_axis: int) -> Geometry:
        """Geometry factors at the tensor Gauss rule with n_q_per_axis
        points per axis."""
        qw = shape_data_1d(1, n_q_per_axis).quad_w
        w_tensor = np.ones((n_q_per_axis,) * self.dim)
        for d in range(self.dim):
            shape = [1] * self.dim
            shape[d] = n_q_per_axis
            w_tensor = w_tensor * qw.reshape(shape)
        return Geometry(jxw=w_tensor * float(np.prod(self.h)),
                        jinv_diag=1.0 / self.h)

    @property
    def coarse_cell_diameter(self) -> float:
        """Diameter of one cell before refinement (the reference's
        minimal_cell_diameter of the unrefined grid, tp_01.cc:87)."""
        h0 = (self.upper - self.lower) / np.array(self.subdivisions)
        return float(np.linalg.norm(h0))

    def boundary_dof_mask(self, degree: int) -> np.ndarray:
        """1.0 for interior (free) dofs, 0.0 on the domain boundary
        (homogeneous Dirichlet elimination mask)."""
        mask = np.ones(self.dof_shape(degree))
        for d in range(self.dim):
            idx = [slice(None)] * self.dim
            idx[d] = 0
            mask[tuple(idx)] = 0.0
            idx[d] = -1
            mask[tuple(idx)] = 0.0
        return mask

    def dof_coordinates(self, degree: int) -> np.ndarray:
        """Coordinates of the Q_degree nodal points, (*dofshape, dim)."""
        nodes = np.array(q_nodes_1d(degree))
        axes = []
        for d in range(self.dim):
            v = self.axis_vertices(d)
            pos = v[:-1, None] + np.diff(v)[:, None] * nodes[None, :]
            axes.append(np.concatenate([pos[:, :-1].reshape(-1),
                                        [self.upper[d]]]))
        return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)

    def quad_coordinates(self, n_q: int) -> np.ndarray:
        """Physical coordinates of the tensor Gauss points, [*cells, *q,
        dim] (stfem_tpu/errors.py::quad_coordinates)."""
        qx = shape_data_1d(1, n_q).quad_x
        dim = self.dim
        out = np.zeros(self.cells + (n_q,) * dim + (dim,))
        for d in range(dim):
            pos = (self.lower[d] + self.h[d]
                   * (np.arange(self.cells[d])[:, None] + qx[None, :]))
            shape = [1] * (2 * dim)
            shape[d] = self.cells[d]
            shape[dim + d] = n_q
            out[..., d] = pos.reshape(shape)
        return out

"""Structured hex meshes of a hyper-rectangle (counterpart of
stfem_tpu/mesh/grid.py).

DoF indexing is pure arithmetic on a tensor grid; the mesh is {cell counts,
bounding box} and, optionally,
  * a cell mask (1 active, 0 removed: the dfgBenchmarkSquare channel with
    its obstacle cells taken out, reference grids.h:243-323),
  * per-axis step lists (a non-uniform tensor grid; refinement splits
    each step into 2^r equal parts),
  * an exact vertex map (a smooth torch function on [..., dim] points, the
    squircle morph that turns the square obstacle into the DFG cylinder):
    quadrature points and Jacobians come from the map itself, through
    torch.func, once, in float64,
  * explicit vertices: a random distortion of the interior vertices
    (deal.II's GridTools::distort_random, reference tp_01.cc:83-90, with
    stfem_tpu's NumPy stream) or a vertex map applied to the vertex grid
    alone (map_exact False); every cell is then the Q1 (multilinear) image
    of the unit cube under its corner vertices.
The uniform mesh keeps one constant quadrature-weight tensor and the
per-axis inverse cell widths (Geometry.jinv_diag); a non-uniform one has
per-cell inverse steps (jinv_axis) and a mapped or Q1 one full inverse
Jacobians per (cell, quadrature point) (jinv), as stfem_tpu's.
"""
from __future__ import annotations

from dataclasses import dataclass

import itertools

import numpy as np
import torch

from .fe import q_nodes_1d, shape_data_1d


@dataclass(frozen=True)
class Geometry:
    """Quadrature-point geometry for one tensor Gauss rule.

    uniform:     jxw (q1,..,qd) (the same in every cell), jinv_diag (dim,);
    cell mask:   jxw [*cells, *q] (zero on removed cells), jinv_diag;
    axis steps:  jxw [*cells, *q], jinv_axis[d] (cells[d],) = 1 / step;
    mapped:      jxw [*cells, *q], jinv [*cells, *q, dim, dim] with
                 jinv[..., e, d] = d xi_e / d x_d, points [*cells, *q, dim].
    """
    jxw: np.ndarray
    jinv_diag: np.ndarray | None = None
    jinv_axis: tuple | None = None
    jinv: np.ndarray | None = None
    points: np.ndarray | None = None


def map_points(fmap, x: np.ndarray) -> np.ndarray:
    """A vertex map applied to float64 NumPy points [..., dim]."""
    return fmap(torch.as_tensor(np.asarray(x, np.float64))).numpy()


def map_jacobians(fmap, x: np.ndarray) -> np.ndarray:
    """d fmap / d x at float64 points [N, dim] -> [N, dim_out, dim_in]
    (forward mode, as stfem_tpu's jax.vmap(jax.jacfwd(fmap)))."""
    pts = torch.as_tensor(np.asarray(x, np.float64))
    return torch.func.vmap(torch.func.jacfwd(fmap))(pts).numpy()


class StructuredMesh:
    """Tensor-product mesh of a hyper-rectangle (reference
    GridGenerator::subdivided_hyper_rectangle + global refinement), with
    an optional cell mask, per-axis steps, vertex map and random vertex
    distortion."""

    def __init__(self, subdivisions, lower, upper, refinement: int = 0,
                 distort: float = 0.0, distort_seed: int = 42,
                 cell_mask=None, axis_steps=None, vertex_map=None,
                 map_exact: bool = False):
        """axis_steps: per-axis lists of step widths (subdivisions and
        upper follow from them).  cell_mask: [*cells] of 1.0 (active) and
        0.0 (removed).  distort: shift every interior vertex by up to
        distort * min(h) per coordinate (seeded by distort_seed).
        vertex_map: a torch function on [..., dim] float64 points, used
        exactly (map_exact) or on the vertices only (Q1 cells)."""
        if axis_steps is not None:
            subdivisions = [len(st) for st in axis_steps]
            upper = [float(lo + np.sum(st))
                     for lo, st in zip(lower, axis_steps)]
        self.dim = len(subdivisions)
        self.subdivisions = tuple(int(s) for s in subdivisions)
        self.lower = np.asarray(lower, dtype=np.float64)
        self.upper = np.asarray(upper, dtype=np.float64)
        self.refinement = int(refinement)
        self.cells = tuple(s * 2 ** refinement for s in self.subdivisions)
        self.h = (self.upper - self.lower) / np.array(self.cells)
        self.axis_steps = None
        if axis_steps is not None:
            self.axis_steps = tuple(
                np.repeat(np.asarray(st, dtype=np.float64) / 2 ** refinement,
                          2 ** refinement)
                for st in axis_steps)
        self.cell_mask = None if cell_mask is None \
            else np.asarray(cell_mask, dtype=np.float64)
        if self.cell_mask is not None and self.cell_mask.shape != self.cells:
            raise ValueError(f"cell_mask {self.cell_mask.shape} on cells "
                             f"{self.cells}")
        self.distort = float(distort)
        # explicit vertex coordinates [*(cells + 1), dim] of a distorted or
        # Q1-mapped mesh (None: the tensor grid's, or the exact map's)
        self.vertices = None
        if distort != 0.0:
            self.vertices = self._distorted_vertices(distort, distort_seed)
        self.vertex_map = vertex_map
        self.map_exact = bool(map_exact)
        if vertex_map is not None and not map_exact:
            self.vertices = map_points(vertex_map, self.vertex_grid())
        self._geometry_cache = {}

    @property
    def uniform(self) -> bool:
        """No cell mask, axis steps, vertex map or distortion: every cell
        alike."""
        return (self.cell_mask is None and self.axis_steps is None
                and self.vertex_map is None and self.vertices is None)

    def base_axis_steps(self):
        """The unrefined per-axis step lists (None on an even grid)."""
        if self.axis_steps is None:
            return None
        r = 2 ** self.refinement
        return [np.asarray(st).reshape(-1, r)[:, 0] * r
                for st in self.axis_steps]

    def coarsened(self) -> "StructuredMesh":
        """One level coarser: a coarse cell is active iff all its children
        are (masks originate at the base level), the base steps and the
        map are kept; a distorted mesh's coarse vertices are its even-
        strided vertices (deal.II's coarsening sequence of a distorted
        fine triangulation)."""
        assert self.refinement > 0
        cm = self.cell_mask
        if cm is not None:
            for d in range(self.dim):
                cm = cm.reshape(cm.shape[:d] + (cm.shape[d] // 2, 2)
                                + cm.shape[d + 1:]).min(axis=d + 1)
        m = StructuredMesh(self.subdivisions, self.lower, self.upper,
                           refinement=self.refinement - 1, cell_mask=cm,
                           axis_steps=self.base_axis_steps(),
                           vertex_map=self.vertex_map,
                           map_exact=self.map_exact)
        if self.vertices is not None and self.vertex_map is None:
            m.vertices = self.vertices[(slice(None, None, 2),) * self.dim]
            m.distort = self.distort
        return m

    @property
    def n_cells(self) -> int:
        return int(np.prod(self.cells))

    def n_dofs(self, degree: int) -> int:
        return int(np.prod(self.dof_shape(degree)))

    def dof_shape(self, degree: int) -> tuple[int, ...]:
        """Continuous Q_degree dof grid (lexicographic per axis)."""
        return tuple(c * degree + 1 for c in self.cells)

    def steps(self, d: int) -> np.ndarray:
        """Per-cell step widths along axis d (cells[d],)."""
        if self.axis_steps is not None:
            return np.asarray(self.axis_steps[d])
        return np.full(self.cells[d], self.h[d])

    def axis_vertices(self, d: int) -> np.ndarray:
        """1D vertex positions along axis d (before the map)."""
        if self.axis_steps is not None:
            return np.concatenate(
                [[self.lower[d]],
                 self.lower[d] + np.cumsum(self.axis_steps[d])])
        return self.lower[d] + self.h[d] * np.arange(self.cells[d] + 1)

    def vertex_grid(self) -> np.ndarray:
        """Vertex coordinates [*(cells + 1), dim] (before an exact
        map)."""
        if self.vertices is not None:
            return self.vertices
        axes = [self.axis_vertices(d) for d in range(self.dim)]
        return np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)

    def _distorted_vertices(self, factor: float, seed: int) -> np.ndarray:
        """Randomly shift interior vertices by up to factor*h_min per
        coordinate (deal.II GridTools::distort_random semantics with
        stfem_tpu's deterministic NumPy stream, so the vertices are
        stfem_tpu's bit for bit)."""
        axes = [self.lower[d] + self.h[d] * np.arange(self.cells[d] + 1)
                for d in range(self.dim)]
        mesh = np.meshgrid(*axes, indexing="ij")
        verts = np.stack(mesh, axis=-1)
        rng = np.random.default_rng(seed)
        hmin = float(np.min(self.h))
        shift = rng.uniform(-factor * hmin, factor * hmin, size=verts.shape)
        # keep the boundary fixed
        for d in range(self.dim):
            idx = [slice(None)] * self.dim
            idx[d] = 0
            shift[tuple(idx)] = 0.0
            idx[d] = -1
            shift[tuple(idx)] = 0.0
        return verts + shift

    def geometry(self, n_q_per_axis: int) -> Geometry:
        """Geometry factors at the tensor Gauss rule with n_q_per_axis
        points per axis, memoized per rule (a mapped or Q1 mesh's
        Jacobians are the costly part of a level's setup)."""
        if n_q_per_axis not in self._geometry_cache:
            self._geometry_cache[n_q_per_axis] = self._geometry(n_q_per_axis)
        return self._geometry_cache[n_q_per_axis]

    def _geometry(self, n_q: int) -> Geometry:
        qw = shape_data_1d(1, n_q).quad_w
        dim = self.dim
        w_tensor = np.ones((n_q,) * dim)
        for d in range(dim):
            shape = [1] * dim
            shape[d] = n_q
            w_tensor = w_tensor * qw.reshape(shape)
        if self.vertex_map is not None and self.map_exact:
            return self._geometry_exact_map(n_q, w_tensor)
        if self.vertices is not None:
            return self._geometry_q1(n_q, w_tensor)
        if self.axis_steps is not None:
            # non-uniform tensor grid: separable per-cell diagonal Jacobian
            detj = np.ones(self.cells)
            for d in range(dim):
                shape = [1] * dim
                shape[d] = self.cells[d]
                detj = detj * self.axis_steps[d].reshape(shape)
            if self.cell_mask is not None:
                detj = detj * self.cell_mask
            jxw = detj.reshape(self.cells + (1,) * dim) * w_tensor
            return Geometry(jxw=jxw, jinv_axis=tuple(
                1.0 / st for st in self.axis_steps))
        detj = float(np.prod(self.h))
        if self.cell_mask is not None:
            jxw = (self.cell_mask.reshape(self.cells + (1,) * dim)
                   * (w_tensor * detj))
            return Geometry(jxw=jxw, jinv_diag=1.0 / self.h)
        return Geometry(jxw=w_tensor * detj, jinv_diag=1.0 / self.h)

    def _cell_corners(self) -> np.ndarray:
        """[*cells, 2^dim, dim]: each cell's corner vertices, corner index
        bits = per-axis 0/1 in lexicographic order."""
        verts = self.vertex_grid()
        corners = []
        for bits in itertools.product((0, 1), repeat=self.dim):
            corners.append(verts[tuple(slice(b, self.cells[d] + b)
                                       for d, b in enumerate(bits))])
        return np.stack(corners, axis=-2)

    def _geometry_q1(self, n_q: int, w_tensor) -> Geometry:
        """The general path (stfem_tpu/mesh/grid.py:238-286): per-cell Q1
        maps of the corner vertices, their Jacobians, measures and inverse
        Jacobians at every Gauss point; removed cells get an identity
        Jacobian and zero weight."""
        qx = shape_data_1d(1, n_q).quad_x
        dim = self.dim
        qshape = (n_q,) * dim
        corner_arr = self._cell_corners()
        n_corners = 2 ** dim
        N = np.ones((n_corners,) + qshape)
        dN = np.ones((n_corners,) + qshape + (dim,))
        for ci, bits in enumerate(itertools.product((0, 1), repeat=dim)):
            for d, b in enumerate(bits):
                shape = [1] * dim
                shape[d] = n_q
                f = qx if b else (1.0 - qx)
                df = np.ones_like(qx) if b else -np.ones_like(qx)
                N[ci] = N[ci] * f.reshape(shape)
                for e in range(dim):
                    dN[ci, ..., e] = dN[ci, ..., e] * (
                        (df if e == d else f).reshape(shape))
        # J[*cells, Q, dx, dxi] = sum_c corner[c, dx] dN[c, Q, dxi]
        J = np.einsum("...cx,cQe->...Qxe", corner_arr,
                      dN.reshape(n_corners, -1, dim))
        detJ = np.linalg.det(J)
        if self.cell_mask is not None:
            inactive = (self.cell_mask == 0.0).reshape(-1)
            flatJ = J.reshape(-1, J.shape[-3], dim, dim)
            flatJ[inactive] = np.eye(dim)
            J = flatJ.reshape(J.shape)
            detJ = np.linalg.det(J)
            detJ = (detJ.reshape(self.n_cells, -1)
                    * self.cell_mask.reshape(-1, 1)).reshape(J.shape[:-2])
        jinv = np.linalg.inv(J)               # [..., dxi, dx]
        jxw = (detJ * w_tensor.reshape(-1)).reshape(self.cells + qshape)
        pts = np.einsum("...cx,cQ->...Qx", corner_arr,
                        N.reshape(n_corners, -1))
        return Geometry(jxw=jxw,
                        jinv=jinv.reshape(self.cells + qshape + (dim, dim)),
                        points=pts.reshape(self.cells + qshape + (dim,)))

    def _base_quad_points(self, n_q: int) -> np.ndarray:
        """Pre-map (tensor-grid) Gauss point coordinates [*cells, *q,
        dim]."""
        qx = shape_data_1d(1, n_q).quad_x
        dim = self.dim
        out = np.zeros(self.cells + (n_q,) * dim + (dim,))
        for d in range(dim):
            starts = self.axis_vertices(d)[:-1]
            pos = starts[:, None] + self.steps(d)[:, None] * qx[None, :]
            shape = [1] * (2 * dim)
            shape[d] = self.cells[d]
            shape[dim + d] = n_q
            out[..., d] = pos.reshape(shape)
        return out

    def _geometry_exact_map(self, n_q: int, w_tensor) -> Geometry:
        """Quadrature points, Jacobians and measures of the map composed
        with the (possibly non-uniform) base grid; removed cells get an
        identity Jacobian and zero weight."""
        dim = self.dim
        qshape = (n_q,) * dim
        flat = self._base_quad_points(n_q).reshape(-1, dim)
        pts = map_points(self.vertex_map, flat)
        Jm = map_jacobians(self.vertex_map, flat)      # (N, dx, d_base)
        stepvec = np.ones(self.cells + (dim,))
        for d in range(dim):
            shape = [1] * dim
            shape[d] = self.cells[d]
            stepvec[..., d] = self.steps(d).reshape(shape)
        # chain rule with the diagonal base-grid Jacobian: dxi_d -> step_d
        J = (Jm.reshape(self.cells + qshape + (dim, dim))
             * stepvec.reshape(self.cells + (1,) * dim + (1, dim)))
        detJ = np.linalg.det(J)
        if self.cell_mask is not None:
            inactive = self.cell_mask == 0.0
            J[inactive] = np.eye(dim)
            detJ = np.linalg.det(J) * self.cell_mask.reshape(
                self.cells + (1,) * dim)
            active_min = detJ[~inactive].min() if (~inactive).any() else 1.0
        else:
            active_min = detJ.min()
        if not active_min > 0.0:
            raise ValueError(f"vertex_map folds cells (min detJ "
                             f"{active_min:.3e})")
        return Geometry(jxw=detJ * w_tensor, jinv=np.linalg.inv(J),
                        points=pts.reshape(self.cells + qshape + (dim,)))

    @property
    def coarse_cell_diameter(self) -> float:
        """Diameter of one cell before refinement (the reference's
        minimal_cell_diameter of the unrefined grid, tp_01.cc:87)."""
        h0 = (self.upper - self.lower) / np.array(self.subdivisions)
        return float(np.linalg.norm(h0))

    def boundary_dof_mask(self, degree: int) -> np.ndarray:
        """1.0 for interior (free) dofs, 0.0 on the domain boundary
        (homogeneous Dirichlet elimination mask) and, with a cell mask, on
        every dof of a removed cell."""
        mask = np.ones(self.dof_shape(degree))
        for d in range(self.dim):
            idx = [slice(None)] * self.dim
            idx[d] = 0
            mask[tuple(idx)] = 0.0
            idx[d] = -1
            mask[tuple(idx)] = 0.0
        if self.cell_mask is not None:
            k = degree
            for cidx in np.argwhere(self.cell_mask == 0.0):
                mask[tuple(slice(int(c) * k, int(c) * k + k + 1)
                           for c in cidx)] = 0.0
        return mask

    def dof_coordinates(self, degree: int) -> np.ndarray:
        """Coordinates of the Q_degree nodal points, (*dofshape, dim); on
        an exactly mapped mesh the base nodes go through the map, on a
        mesh with explicit vertices each node is its cell's Q1 image of
        the reference node (deal.II's MappingQ1 node placement; a node
        shared by cells takes the last cell's, as stfem_tpu's cell loop
        leaves it)."""
        nodes = np.array(q_nodes_1d(degree))
        if self.vertices is not None:
            return self._q1_nodes(degree, nodes)
        axes = []
        for d in range(self.dim):
            v = self.axis_vertices(d)
            pos = v[:-1, None] + np.diff(v)[:, None] * nodes[None, :]
            axes.append(np.concatenate([pos[:, :-1].reshape(-1),
                                        [self.upper[d]]]))
        base = np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)
        if self.vertex_map is not None:
            return map_points(self.vertex_map, base)
        return base

    def _q1_nodes(self, degree: int, nodes: np.ndarray) -> np.ndarray:
        """dof_coordinates on explicit vertices, vectorised over the dof
        grid: dof j of axis d lies in cell min(j // k, cells - 1) at local
        node j - c k; the corner weights multiply and the corner terms add
        in stfem_tpu's order (stfem_tpu/mesh/grid.py:396-419)."""
        k, dim = degree, self.dim
        verts = self.vertices
        cell, xi = [], []
        for d in range(dim):
            j = np.arange(self.cells[d] * k + 1)
            c = np.minimum(j // k, self.cells[d] - 1)
            cell.append(c)
            xi.append(nodes[j - c * k])
        out = np.zeros(self.dof_shape(degree) + (dim,))
        for bits in itertools.product((0, 1), repeat=dim):
            w = None
            idx = []
            for d, b in enumerate(bits):
                shape = [1] * dim
                shape[d] = -1
                f = (xi[d] if b else 1 - xi[d]).reshape(shape)
                w = f if w is None else w * f
                idx.append((cell[d] + b).reshape(shape))
            out = out + w[..., None] * verts[tuple(idx)]
        return out

    def quad_coordinates(self, n_q: int) -> np.ndarray:
        """Physical coordinates of the tensor Gauss points, [*cells, *q,
        dim] (stfem_tpu/errors.py::quad_coordinates)."""
        if self.vertex_map is not None or self.vertices is not None:
            return self.geometry(n_q).points
        return self.tensor_quad_coordinates(n_q)

    def tensor_quad_coordinates(self, n_q: int) -> np.ndarray:
        """The tensor Gauss points of the grid before any map or
        distortion, [*cells, *q, dim] (stfem_tpu/errors.py::
        quad_coordinates, which stfem_tpu's ForceAssembler evaluates the
        rhs at on every mesh)."""
        if self.axis_steps is not None:
            return self._base_quad_points(n_q)
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

"""Index maps for banded assembly and Vanka patches (the NumPy forms of
stfem_tpu/utils/native.py::band_indices and ::dof_valence; the port keeps
its own copy and binds no native library), and the tables of the
owner-computes sums that replace scatter-adds: each target gathers its
contributions through a padded index table in a fixed order and reduces
them, so no float atomics make a result vary from run to run."""
from __future__ import annotations

import numpy as np


def band_indices(cells, degree: int) -> np.ndarray:
    """(C, A, A) int64 flat indices into the banded storage
    band[*dofshape, (2k+1)^dim]: entry [c, a, b] addresses
    A_assembled[g(c, a), g(c, b)]."""
    dim = len(cells)
    k = degree
    A = (k + 1) ** dim
    C = int(np.prod(cells))
    dof_shape = tuple(c * k + 1 for c in cells)
    n_off = (2 * k + 1) ** dim
    loc = np.stack(np.meshgrid(*([np.arange(k + 1)] * dim), indexing="ij"),
                   -1).reshape(A, dim)
    cell_idx = np.stack(np.meshgrid(*[np.arange(c) for c in cells],
                                    indexing="ij"), -1).reshape(C, dim)
    dof_strides = np.cumprod([1] + list(dof_shape[::-1]))[::-1][1:]
    gidx = ((cell_idx[:, None, :] * k + loc[None, :, :])
            * dof_strides[None, None, :]).sum(-1)
    off = loc[None, :, :] - loc[:, None, :] + k
    off_strides = np.cumprod([1] + [2 * k + 1] * (dim - 1))[::-1]
    off_flat = (off * off_strides[None, None, :]).sum(-1)
    return (gidx[:, :, None] * n_off + off_flat[None, :, :]).astype(np.int64)


def band_columns(degree: int, dim: int) -> np.ndarray:
    """(A, (2k+1)^dim) int64: for local row a and band offset o, the local
    column b with band_indices' offset of (a, b) equal to o, or A where no
    column of the cell has it."""
    k = degree
    A = (k + 1) ** dim
    n_off = (2 * k + 1) ** dim
    loc = np.stack(np.meshgrid(*([np.arange(k + 1)] * dim), indexing="ij"),
                   -1).reshape(A, dim)
    off = loc[None, :, :] - loc[:, None, :] + k
    off_strides = np.cumprod([1] + [2 * k + 1] * (dim - 1))[::-1]
    off_flat = (off * off_strides[None, None, :]).sum(-1)     # (a, b)
    out = np.full((A, n_off), A, np.int64)
    rows = np.repeat(np.arange(A), A)
    out[rows, off_flat.reshape(-1)] = np.tile(np.arange(A), A)
    return out


def layer_sources(layers) -> tuple[np.ndarray, np.ndarray]:
    """Owner-computes table of a sum over cell layers (the Nitsche face
    layers: a corner cell lies in two).  layers: a list of int arrays of
    cell indices, each without repeats.  Returns (cells, table): the
    sorted cells that some layer holds, and for each its rows in the
    concatenation of the layers, in layer order, padded with the total row
    count (a zero row the caller appends)."""
    layers = [np.asarray(l, np.int64).reshape(-1) for l in layers]
    cat = np.concatenate(layers) if layers else np.zeros(0, np.int64)
    cells, counts = np.unique(cat, return_counts=True)
    n_max = int(counts.max()) if len(counts) else 0
    table = np.full((len(cells), n_max), len(cat), np.int64)
    fill = np.zeros(len(cells), np.int64)
    pos = np.searchsorted(cells, cat)
    for row, p in enumerate(pos):          # rows in layer order
        table[p, fill[p]] = row
        fill[p] += 1
    return cells, table


def dof_valence(cells, degree: int) -> np.ndarray:
    """Number of cells containing each dof of the Q_degree grid (the
    reference's valence vector, stmg.h:676-689)."""
    dim = len(cells)
    dof_shape = tuple(c * degree + 1 for c in cells)
    out = np.ones(dof_shape)
    for d in range(dim):
        ax = np.ones(dof_shape[d])
        if degree > 0:
            ax[degree::degree] = 2.0
            ax[0] = 1.0
            ax[-1] = 1.0
        shape = [1] * dim
        shape[d] = len(ax)
        out = out * ax.reshape(shape)
    return out


def cell_dof_indices(cells, degree: int) -> np.ndarray:
    """(C, A) int64 flat indices into the Q_degree dof grid of each cell's
    local dofs (lexicographic cells, lexicographic local nodes): the index
    form of ops/spatial.py::cell_gather."""
    dim = len(cells)
    k = degree
    A = (k + 1) ** dim
    dof_shape = tuple(c * k + 1 for c in cells)
    loc = np.stack(np.meshgrid(*([np.arange(k + 1)] * dim), indexing="ij"),
                   -1).reshape(A, dim)
    cell_idx = np.stack(np.meshgrid(*[np.arange(c) for c in cells],
                                    indexing="ij"), -1).reshape(-1, dim)
    strides = np.cumprod([1] + list(dof_shape[::-1]))[::-1][1:]
    return ((cell_idx[:, None, :] * k + loc[None, :, :])
            * strides).sum(-1).astype(np.int64)


def overlap_sources(cells, degree: int) -> np.ndarray:
    """(n_dofs, 2, .., 2) int64: for each dof of the Q_degree grid, the
    positions in a flat (C, A) cell-local array of its contributions, one
    axis per space direction (bit 0: the cell that ends at the dof, bit 1:
    the cell that starts or contains it), C * A where there is none.
    Summing the two-entry axes from the last to the first adds the
    contributions in the pairs and the order of ops/spatial.py::
    cell_scatter (a two-term sum is exact in any order, and a missing term
    adds zero), so the overlap-add it gives is bitwise cell_scatter's."""
    dim = len(cells)
    k = degree
    A = (k + 1) ** dim
    C = int(np.prod(cells))
    per_axis = []
    for nc in cells:
        n = nc * k + 1
        c_of = np.full((n, 2), -1)
        l_of = np.zeros((n, 2), np.int64)
        j = np.arange(n)
        c1 = np.minimum(j // k, nc - 1)            # the cell containing j
        c_of[:, 1], l_of[:, 1] = c1, j - c1 * k
        shared = (j % k == 0) & (j > 0) & (j < n - 1)
        c_of[shared, 0], l_of[shared, 0] = j[shared] // k - 1, k
        per_axis.append((c_of, l_of))
    dof_shape = tuple(nc * k + 1 for nc in cells)
    out = np.zeros(dof_shape + (2,) * dim, np.int64)
    cell_strides = np.cumprod([1] + list(cells[::-1]))[::-1][1:]
    loc_strides = np.cumprod([1] + [k + 1] * (dim - 1))[::-1]
    for bits in np.ndindex(*(2,) * dim):
        cidx = np.zeros(dof_shape, np.int64)
        lidx = np.zeros(dof_shape, np.int64)
        valid = np.ones(dof_shape, bool)
        for d in range(dim):
            c_of, l_of = per_axis[d]
            shape = [1] * dim
            shape[d] = dof_shape[d]
            cd = c_of[:, bits[d]].reshape(shape)
            valid = valid & (cd >= 0)
            cidx = cidx + np.maximum(cd, 0) * cell_strides[d]
            lidx = lidx + l_of[:, bits[d]].reshape(shape) * loc_strides[d]
        out[(Ellipsis,) + bits] = np.where(valid, cidx * A + lidx, C * A)
    return out.reshape((-1,) + (2,) * dim)

"""Index maps for banded assembly and Vanka patches (the NumPy forms of
stfem_tpu/utils/native.py::band_indices and ::dof_valence; the port keeps
its own copy and binds no native library)."""
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

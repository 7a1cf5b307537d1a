"""Binary legacy-VTK structured-grid output (counterpart of
stfem_tpu/utils/native.py::write_vtk; the analogue of the reference's
DataOut dumps, tp_01.cc:636-644).

The bytes are those of stfem_tpu's native writer (native/stfem_setup.cc
stfem_write_vtk): an ASCII header, the points as big-endian float64
triples (2D padded with z = 0), the scalar field as big-endian float64,
with VTK's x the grid's axis 0."""
from __future__ import annotations

import numpy as np


def write_vtk(path: str, points, values, name: str = "u") -> None:
    """Write `values` [*grid] at `points` [*grid, dim] (the dof grid)."""
    values = np.asarray(values, dtype=np.float64)
    grid_shape = values.shape
    dims3 = (list(grid_shape) + [1, 1])[:3]
    n = int(np.prod(grid_shape))
    # Fortran order makes axis 0 the fastest, VTK's x
    pts = np.asarray(points, dtype=np.float64).reshape(grid_shape + (-1,))
    pr = pts.reshape(n, pts.shape[-1], order="F")
    pts3 = np.zeros((n, 3))
    pts3[:, :pr.shape[1]] = pr
    vals = values.reshape(n, order="F")
    with open(path, "wb") as f:
        f.write(b"# vtk DataFile Version 3.0\nstfem_tpu solution\nBINARY\n")
        f.write(f"DATASET STRUCTURED_GRID\nDIMENSIONS {dims3[0]} {dims3[1]} "
                f"{dims3[2]}\nPOINTS {n} double\n".encode())
        f.write(pts3.astype(">f8").tobytes())
        f.write(f"\nPOINT_DATA {n}\nSCALARS {name} double 1\n"
                "LOOKUP_TABLE default\n".encode())
        f.write(vals.astype(">f8").tobytes())
        f.write(b"\n")

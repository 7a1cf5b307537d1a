"""The cell-local index forms the Stokes application's V-cycle runs on
(CPU, port only): utils/assembly.py's gather and overlap-add maps
against ops/spatial.py's cell_gather and cell_scatter (bitwise, in
float32 and float64, 1D to 3D), and StokesSystemMatrix's "element" route
against its "sumfac" route (float64, 1e-13 of the largest entry, 2D and
3D, strong and Nitsche faces, with batch axes between the time axis and
the flat dofs, as the direct coarse assembly calls it)."""
import numpy as np
import pytest
import torch

from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import (LaplaceMassOperator, cell_gather,
                                         cell_scatter, overlap_add)
from stfem_tpu_torch.ops.stokes import StokesOperator
from stfem_tpu_torch.system_stokes import StokesSystemMatrix
from stfem_tpu_torch.time.tables import get_fe_time_weights
from stfem_tpu_torch.types import TimeStepType
from stfem_tpu_torch.utils.assembly import cell_dof_indices, overlap_sources

torch.set_num_threads(1)


@pytest.mark.parametrize("cells,k", [((5,), 3), ((3, 4), 2), ((2, 2), 1),
                                     ((2, 3, 2), 2), ((2, 2, 2), 4)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_index_maps_are_cell_gather_and_scatter(cells, k, dtype):
    dim = len(cells)
    gen = torch.Generator().manual_seed(len(cells) * 10 + k)
    x = torch.randn((3,) + tuple(c * k + 1 for c in cells), generator=gen,
                    dtype=dtype)
    g = torch.as_tensor(cell_dof_indices(cells, k))
    assert torch.equal(x.reshape(3, -1)[:, g],
                       cell_gather(x, cells, k).reshape((3,) + g.shape))
    y = torch.randn((3,) + cells + (k + 1,) * dim, generator=gen,
                    dtype=dtype)
    src = torch.as_tensor(overlap_sources(cells, k).reshape(-1))
    assert torch.equal(overlap_add(y.reshape(3, -1), src, dim),
                       cell_scatter(y, cells, k).reshape(3, -1))


@pytest.mark.parametrize("dim,ref,faces", [
    (2, 2, ()), (2, 2, ((0, 1),)), (2, 3, ((0, 0), (0, 1), (1, 0), (1, 1))),
    (3, 1, ()), (3, 1, ((0, 1), (2, 0)))])
@pytest.mark.parametrize("kind", ["DG", "CGP"])
def test_element_route_matches_sumfac(dim, ref, faces, kind):
    mesh = StructuredMesh([1] * dim, [0.0] * dim, [1.0] * dim,
                          refinement=ref)
    S = StokesOperator(mesh, 2, 1, 3, 0.7, device="cpu", weak_faces=faces)
    M = LaplaceMassOperator(mesh, 2, 3, 1.0, 0.0, device="cpu",
                            mask=S.mask_u_np)
    a, b, _, _ = get_fe_time_weights(getattr(TimeStepType, kind), 1, 0.1, 2)
    plain = StokesSystemMatrix(S, M, a, b)
    elem = StokesSystemMatrix(S, M, a, b, route="element")
    gen = torch.Generator().manual_seed(dim * 100 + ref)
    for shape in ((a.shape[0],), (a.shape[0], 3)):
        x = torch.randn(shape + (S.n_u + S.n_p,), generator=gen,
                        dtype=torch.float64)
        want = plain.vmult(x)
        got = elem.vmult(x)
        assert float((got - want).abs().max()) <= 1e-13 * float(
            want.abs().max())

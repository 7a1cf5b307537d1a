"""The hand-written CUDA kernels of stfem_tpu_torch against their plain
torch versions, on the card.  Marked `cuda`: without an NVIDIA GPU every
test here skips (a CUDA kernel has no CPU mode); on the card run
    python -m pytest tests/test_torch_kernels_cuda.py -m cuda
This file imports neither jax nor stfem_tpu.

Tolerances, relative to the plain version's max norm: K1 float32 1e-5
(f32 sums, FMA contraction), K1 bf16 8e-3 (one bf16 rounding of the
output, 2^-8, either side); K2 float64 1e-14 (the same sums in the same
order up to FMA contraction)."""
import pytest
import torch

from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.kron_pair import kron_pair, kron_pair_reference
from stfem_tpu_torch.ops.kronfac import KronAssembled
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.ops.time_solve import time_solve, time_solve_reference

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA kernels have no CPU mode")
    return torch.device("cuda")


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("S,nt,N", [(32, 3, 80 ** 3), (5, 1, 1000),
                                    (7, 2, 257), (4, 4, 4097)])
def test_time_solve_kernel(dev, S, nt, N, dtype, tol):
    g = torch.Generator(device=dev).manual_seed(S * N)
    w = torch.randn((S * nt, N), generator=g, device=dev).to(dtype)
    G = 0.3 * torch.randn((nt, nt, N), generator=g, device=dev)
    c = torch.rand((nt, N), generator=g, device=dev) * 1.8 - 0.9
    before = time_solve.launches
    got = time_solve(w, G, c, S, nt, dtype)
    torch.cuda.synchronize()
    assert time_solve.launches == before + 1 and got.dtype == dtype
    assert _rel(got, time_solve_reference(w, G, c, S, nt, dtype)) <= tol


def test_time_solve_kernel_rejects(dev):
    w = torch.zeros((6, 10), device=dev, dtype=torch.float64)
    G, c = torch.zeros((3, 3, 10), device=dev), torch.zeros((3, 10),
                                                            device=dev)
    with pytest.raises(ValueError):
        time_solve(w, G, c, 2, 3, torch.float64)


@pytest.mark.parametrize("cells,k,B", [((16, 16, 16), 4, 8), ((2, 3, 4), 2, 3),
                                       ((3, 3, 3), 4, 1)])
def test_kron_pair_kernel(dev, cells, k, B):
    mesh = StructuredMesh(list(cells), [0.0] * 3, [1.0] * 3)
    ops = [LaplaceMassOperator(mesh, k, k + 1, m, l, dtype=torch.float64,
                               device=dev) for m, l in ((0.0, 1.0),
                                                        (1.0, 0.0))]
    kron = KronAssembled(*ops, torch.float64)
    g = torch.Generator(device=dev).manual_seed(B)
    x = torch.randn((B,) + mesh.dof_shape(k), generator=g, device=dev,
                    dtype=torch.float64)
    before = kron_pair.launches
    Kk, Mk = kron_pair(x, kron.Md, kron.Ad, k)
    torch.cuda.synchronize()
    assert kron_pair.launches == before + 1
    Kr, Mr = kron_pair_reference(x, kron.Md, kron.Ad, k)
    assert _rel(Kk, Kr) <= 1e-14 and _rel(Mk, Mr) <= 1e-14
    # the dense per-axis form of the same pair (stfem_tpu's CPU route)
    lead = x
    for d in range(3):
        lead = torch.movedim(torch.tensordot(kron.M1[d], lead,
                                             dims=([1], [1 + d])), 0, 1 + d)
    assert _rel(Mk, lead) <= 1e-13


def test_kron_pair_kernel_rejects(dev):
    D = [torch.zeros((3, 5), device=dev, dtype=torch.float64)] * 3
    with pytest.raises(ValueError):
        kron_pair(torch.zeros((1, 5, 5, 5), device=dev), D, D, 1)

"""K6's arithmetic, its wrapper's refusals and KronAssembled.pair's choice
of route, on the CPU.

`level_pair_reference` (float32 taps, axis 1, 2, then 0, one rounding to
the storage dtype) is held against the FP64 pair of the same rounded
factors: within 1e-6 of the max entry in float32, and within 4e-3 in
bf16 (one rounding, at most 2^-8 of an entry).  On the CPU, in 2D, at
k = 5 and for a single output the pair keeps the dense per-axis route and
its numbers, bit for bit; the card's side is tests/test_torch_kernels_cuda.py
and the kernel itself, emulated, tests/test_torch_kernels_emulated.py."""
import numpy as np
import pytest
import torch

from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops import level_pair as lp
from stfem_tpu_torch.ops.gridsumfac import axis_apply
from stfem_tpu_torch.ops.kron_pair import kron_pair_reference, tile_plan
from stfem_tpu_torch.ops.kronfac import KronAssembled
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator

torch.set_num_threads(1)


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def _kron(cells, k, dtype):
    dim = len(cells)
    mesh = StructuredMesh(list(cells), [0.0] * dim, [1.0] * dim)
    ops = [LaplaceMassOperator(mesh, k, k + 1, m, l, dtype=dtype,
                               device="cpu") for m, l in ((0.0, 1.0),
                                                          (1.0, 0.0))]
    return KronAssembled(*ops, dtype), mesh.dof_shape(k)


def _dense_pair(kron, x, need_K, need_M):
    """The dense per-axis route as KronAssembled.pair runs it for bf16 and
    float32 (the shared mass prefix over axis_apply)."""
    lead = x.ndim - kron.dim
    val, ks = x, None
    for d in range(kron.dim):
        ax = lead + d
        if need_K:
            a_term = axis_apply(kron.A1[d], val, ax)
            ks = (a_term if ks is None
                  else axis_apply(kron.M1[d], ks, ax) + a_term)
        if need_M or (need_K and d < kron.dim - 1):
            val = axis_apply(kron.M1[d], val, ax)
    return (ks if need_K else None), (val if need_M else None)


# odd grids (1 to 5 cells an axis), an extra batch axis, every degree the
# level operators take
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 4e-3)])
@pytest.mark.parametrize("cells,k,lead", [((2, 3, 4), 1, (3,)),
                                          ((3, 1, 2), 2, (2, 2)),
                                          ((1, 2, 1), 4, (2, 3)),
                                          ((5, 3, 2), 2, (1,)),
                                          ((2, 2, 3), 4, (4,))])
def test_reference_against_fp64_pair(cells, k, lead, dtype, tol):
    kron, shape = _kron(cells, k, dtype)
    dm, da = lp.tables(kron.Md, kron.Ad, dtype)
    rng = np.random.default_rng(k * 100 + sum(cells))
    x = torch.as_tensor(rng.standard_normal(lead + shape)).to(dtype)
    K, M = lp.level_pair_reference(x, dm, da, k)
    Kr, Mr = kron_pair_reference(x.double(), [D.double() for D in kron.Md],
                                 [D.double() for D in kron.Ad], k)
    assert K.dtype == M.dtype == dtype and K.shape == x.shape
    assert _rel(K, Kr) <= tol and _rel(M, Mr) <= tol
    # the CPU wrapper is the reference
    Kw, Mw = lp.level_pair(x, dm, da, k)
    assert torch.equal(Kw, K) and torch.equal(Mw, M)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_tables_hold_the_rounded_dense_factors(dtype):
    """Each table entry is the dense level matrix's entry (rounded to the
    level's dtype) in float32; zero beyond an axis' length."""
    kron, shape = _kron((2, 3, 1), 2, dtype)
    dm, da = lp.tables(kron.Md, kron.Ad, dtype)
    assert dm.dtype == da.dtype == torch.float32
    assert dm.shape == da.shape == (3, 5, max(shape))
    for d, n in enumerate(shape):
        for D, A in ((dm, kron.M1[d]), (da, kron.A1[d])):
            for o in range(5):
                for i in range(n):
                    j = i + o - 2
                    want = A[i, j].float() if 0 <= j < n else 0.0
                    assert D[d, o, i] == want
            assert not D[d, :, n:].any()


@pytest.mark.parametrize("cells,k,need", [((2, 3, 2), 4, (True, True)),
                                          ((2, 3, 2), 2, (True, True)),
                                          ((2, 3, 2), 1, (True, True)),
                                          ((2, 1, 2), 5, (True, True)),
                                          ((3, 2), 4, (True, True)),
                                          ((2, 3, 2), 4, (False, True)),
                                          ((2, 3, 2), 4, (True, False))])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_pair_keeps_the_dense_route(cells, k, need, dtype):
    """On the CPU (every case), in 2D, at k = 5 and for a single output the
    low-precision pair is the dense route, with its numbers; no K6 call."""
    kron, shape = _kron(cells, k, dtype)
    assert kron._level is None          # K6's tables are built on CUDA only
    rng = np.random.default_rng(k)
    x = torch.as_tensor(rng.standard_normal((3,) + shape)).to(dtype)
    before = lp.level_pair.launches
    got = kron.pair(x, *need)
    want = _dense_pair(kron, x, *need)
    assert lp.level_pair.launches == before
    for g, w in zip(got, want):
        assert (g is None and w is None) or torch.equal(g, w)


@pytest.mark.parametrize("shape,k,ok", [((129, 129, 129), 4, True),
                                        ((3, 3, 3), 1, True),
                                        ((9, 9, 512), 4, True),
                                        ((9, 9, 513), 4, False),
                                        ((129, 129, 129), 5, False),
                                        ((129, 129), 4, False)])
def test_supports(shape, k, ok):
    assert lp.supports(shape, k) is ok


def test_tile_plan():
    """K2's tile plan at K6's MAX_THREADS: one thread per (row, axis-2)
    position, rows spread evenly over the tiles, at most MAX_THREADS
    threads in multiples of 32."""
    plan = lambda n1, n2: tile_plan(n1, n2, lp.MAX_THREADS)
    for n1, n2 in ((129, 129), (65, 65), (33, 33), (3, 3), (9, 512)):
        t, tiles, threads = plan(n1, n2)
        assert t * n2 <= threads <= lp.MAX_THREADS and threads % 32 == 0
        assert (tiles - 1) * t < n1 <= tiles * t
    assert plan(129, 129) == (3, 43, 416)
    with pytest.raises(ValueError):
        plan(4, 513)


def _refused(x, k=1, tables=None):
    dm, da = tables or lp.tables([torch.zeros((2 * k + 1, 5))] * 3,
                                 [torch.zeros((2 * k + 1, 5))] * 3,
                                 torch.float32)
    with pytest.raises(ValueError):
        lp.kernel_args(x, dm, da, k)
    with pytest.raises(ValueError):
        lp.level_pair(x, dm, da, k)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float16])
def test_refuses_other_dtypes(dtype):
    _refused(torch.zeros((1, 5, 5, 5), dtype=dtype))


def test_refuses_k_beyond_the_kernel():
    _refused(torch.zeros((1, 5, 5, 5)), k=5)


def test_refuses_n2_beyond_the_threads():
    x = torch.zeros((1, 2, 2, 513))
    _refused(x, tables=lp.tables([torch.zeros((3, 2)), torch.zeros((3, 2)),
                                  torch.zeros((3, 513))],
                                 [torch.zeros((3, 2)), torch.zeros((3, 2)),
                                  torch.zeros((3, 513))], torch.float32))


def test_refuses_a_non_contiguous_x():
    _refused(torch.zeros((1, 5, 5, 5)).transpose(1, 3))


def test_refuses_tables_of_another_shape_or_dtype():
    x = torch.zeros((1, 5, 5, 5))
    dm, da = lp.tables([torch.zeros((3, 5))] * 3, [torch.zeros((3, 5))] * 3,
                       torch.float32)
    _refused(x, k=2, tables=(dm, da))                # tables of k = 1
    _refused(x, tables=(dm.double(), da.double()))
    _refused(x, tables=(dm[:, :, :4].contiguous(), da[:, :, :4].contiguous()))
    _refused(torch.zeros((5, 5)), tables=(dm, da))   # a 2D grid

"""The hand-written CUDA kernels of stfem_tpu_torch against their plain
torch versions, on the card.  Marked `cuda`: without an NVIDIA GPU every
test here skips (a CUDA kernel has no CPU mode); on the card run
    python -m pytest tests/test_torch_kernels_cuda.py -m cuda
This file imports neither jax nor stfem_tpu.

Tolerances, relative to the plain version's max norm: K1 float32 1e-5
(f32 sums, FMA contraction), K1 bf16 8e-3 (one bf16 rounding of the
output, 2^-8, either side); K2 float64 1e-14 (the same sums in the same
order up to FMA contraction); K3 float64 1e-14 (the same taps in the same
order, on every kernel form); K4 float32 1e-5 (f32 sums in another
order), bf16 8e-3 (one bf16 rounding of the f32 sums, either side),
float64 1e-13; K5 float64 1e-12 and float32 1e-5 (sums of 64-500
products in another order than the plain version's matmuls: FP64 on the
tensor cores, f32 on the CUDA cores, never TF32); K6 float32 1e-6 (the
same float32 taps in the same order up to FMA contraction), bf16 8e-3."""
import pytest
import torch

from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.banded_apply import (banded_apply,
                                              banded_apply_reference)
from stfem_tpu_torch.ops.grid_chain import (chain_down, chain_down_reference,
                                            chain_reference, chain_up,
                                            chain_up_reference)
from stfem_tpu_torch.ops.kron_pair import kron_pair, kron_pair_reference
from stfem_tpu_torch.ops.kronfac import KronAssembled
from stfem_tpu_torch.ops.level_pair import (level_pair,
                                            level_pair_reference)
from stfem_tpu_torch.ops.level_pair import tables as level_pair_tables
from stfem_tpu_torch.ops.quad_middle import quad_middle, quad_middle_reference
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
@pytest.mark.parametrize("S,nt,N", [(32, 3, 80 ** 3), (8, 3, 4096 * 64),
                                    (4, 2, 4096 * 64), (5, 1, 1000),
                                    (7, 2, 257), (4, 4, 4097), (2, 5, 4099),
                                    (4, 5, 729)])
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


# the bench shape, ragged and non-cubic grids, n < 2k+1 (one Q4 cell:
# n = 5), the Stokes velocity grid (n = 17, k = 2), B = 1, an axis-1
# tile plan with a short last tile (n1 = 33 in tiles of 11)
@pytest.mark.parametrize("cells,k,B", [((16, 16, 16), 4, 8), ((2, 3, 4), 2, 3),
                                       ((3, 3, 3), 4, 1), ((1, 1, 1), 4, 2),
                                       ((1, 2, 1), 3, 1), ((8, 8, 8), 2, 3),
                                       ((8, 8, 8), 2, 1), ((4, 2, 3), 4, 2),
                                       ((2, 8, 5), 4, 2), ((3, 4, 2), 1, 5),
                                       ((5, 3, 4), 1, 1)])
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
    D5 = [torch.zeros((11, 5), device=dev, dtype=torch.float64)] * 3
    with pytest.raises(ValueError):          # k beyond the compiled bands
        kron_pair(torch.zeros((1, 5, 5, 5), device=dev, dtype=torch.float64),
                  D5, D5, 5)
    wide = [torch.zeros((3, n), device=dev, dtype=torch.float64)
            for n in (2, 2, 400)]
    with pytest.raises(ValueError):          # axis 2 beyond the threads
        kron_pair(torch.zeros((1, 2, 2, 400), device=dev,
                              dtype=torch.float64), wide, wide, 1)


def _band_diags(k, n, g, dev):
    """Random (2k+1, n) diagonals, zero off-range as to_diags stores."""
    D = torch.randn((2 * k + 1, n), generator=g, device=dev,
                    dtype=torch.float64)
    for o in range(2 * k + 1):
        lo, hi = max(0, k - o), min(n, n + k - o)
        D[o, :lo] = 0.0
        D[o, hi:] = 0.0
    return D


# the main paths' shapes, then every half-bandwidth on shapes that reach
# both kernel forms' edges: n < 2k+1, odd n, outer = 1, inner = 2 (a warp
# spans many pencils), segmented pencils, slabs longer than a tile
_BANDS = ([((1, 65, 65, 65), 4), ((3, 17, 17, 17), 2), ((2, 9, 13, 11), 4),
           ((1, 5, 7, 9), 2)]
          + [(shape, k) for shape in ((1, 3, 2, 5), (2, 9, 5, 33),
                                      (1, 33, 65, 7), (3, 65, 2, 65))
             for k in range(6)])


@pytest.mark.parametrize("axis", [-3, -2, -1])
@pytest.mark.parametrize("shape,k", _BANDS)
def test_banded_apply_kernel(dev, shape, k, axis):
    g = torch.Generator(device=dev).manual_seed(sum(shape) + k)
    x = torch.randn(shape, generator=g, device=dev, dtype=torch.float64)
    D = _band_diags(k, shape[axis], g, dev)
    before = banded_apply.launches
    y = banded_apply(x, D, axis, k)
    torch.cuda.synchronize()
    assert banded_apply.launches == before + 1
    assert _rel(y, banded_apply_reference(x, D, axis, k)) <= 1e-14


@pytest.mark.parametrize("need_K,need_M", [(True, False), (False, True)])
def test_kron_single_output_runs_k3(dev, need_K, need_M):
    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=2)
    ops = [LaplaceMassOperator(mesh, 2, 3, m, l, dtype=torch.float64,
                               device=dev) for m, l in ((0.0, 1.0),
                                                        (1.0, 0.0))]
    kron = KronAssembled(*ops, torch.float64)
    g = torch.Generator(device=dev).manual_seed(3)
    x = torch.randn((3,) + mesh.dof_shape(2), generator=g, device=dev,
                    dtype=torch.float64)
    k3, k2 = banded_apply.launches, kron_pair.launches
    K, M = kron.pair(x, need_K, need_M)
    torch.cuda.synchronize()
    assert kron_pair.launches == k2
    assert banded_apply.launches == k3 + (7 if need_K else 3)
    Kr, Mr = kron_pair_reference(x, kron.Md, kron.Ad, kron.k)
    got, ref = (K, Kr) if need_K else (M, Mr)
    assert (M if need_K else K) is None
    assert _rel(got, ref) <= 1e-14


@pytest.mark.parametrize("cells,B", [((2, 2, 2), 3), ((3, 1, 2), 1)])
def test_kron_pair_degree5_runs_k3(dev, cells, B):
    """A 3D Q5 pair (k = 5, beyond K2's bands) goes to the K3 chain by
    shape: eight K3 launches (three per axis but the first's two), no K2
    launch."""
    mesh = StructuredMesh(list(cells), [0.0] * 3, [1.0] * 3)
    ops = [LaplaceMassOperator(mesh, 5, 6, m, l, dtype=torch.float64,
                               device=dev) for m, l in ((0.0, 1.0),
                                                        (1.0, 0.0))]
    kron = KronAssembled(*ops, torch.float64)
    g = torch.Generator(device=dev).manual_seed(B)
    x = torch.randn((B,) + mesh.dof_shape(5), generator=g, device=dev,
                    dtype=torch.float64)
    k3, k2 = banded_apply.launches, kron_pair.launches
    K, M = kron.pair(x)
    torch.cuda.synchronize()
    assert kron_pair.launches == k2 and banded_apply.launches == k3 + 8
    Kr, Mr = kron_pair_reference(x, kron.Md, kron.Ad, 5)
    assert _rel(K, Kr) <= 1e-14 and _rel(M, Mr) <= 1e-14


def test_banded_apply_kernel_rejects(dev):
    D = torch.zeros((3, 5), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        banded_apply(torch.zeros((2, 5, 5), device=dev), D, -1, 1)
    with pytest.raises(ValueError):
        banded_apply(torch.zeros((2, 5, 6), device=dev,
                                 dtype=torch.float64), D, -1, 1)
    with pytest.raises(ValueError):          # k beyond the compiled bands
        banded_apply(torch.zeros((2, 11, 11), device=dev,
                                 dtype=torch.float64),
                     torch.zeros((13, 11), device=dev, dtype=torch.float64),
                     -1, 6)


def _blocked(nc, k, r, g, dev, up=False):
    """A random matrix with the cell-blocked down (q x n) or up (n x q)
    pattern: row c r + a of the down matrix reads dofs c k .. c k + k."""
    n, q = nc * k + 1, nc * r
    m = torch.zeros((q, n), device=dev)
    for c in range(nc):
        m[c * r:(c + 1) * r, c * k:c * k + k + 1] = torch.randn(
            (r, k + 1), generator=g, device=dev)
    return m.T.contiguous() if up else m


# (nb, cells per axis, k) of the Vanka levels: heat fine 96 x 65^3 <->
# 80^3, wave fine 48 x 33^3 <-> 40^3, a coarse 3^3 level (Q2, one cell)
_LEVELS = [(96, 16, 4), (48, 8, 4), (12, 1, 2)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("nb,nc,k", _LEVELS)
def test_grid_chain_kernel_vanka_levels(dev, nb, nc, k, dtype, tol):
    g = torch.Generator(device=dev).manual_seed(nb + nc)
    dn = [_blocked(nc, k, k + 1, g, dev).to(dtype) for _ in range(3)]
    upm = [_blocked(nc, k, k + 1, g, dev, up=True).to(dtype)
           for _ in range(3)]
    n, cells = nc * k + 1, (nc,) * 3
    x = torch.randn((nb, n, n, n), generator=g, device=dev).to(dtype)
    before = (chain_down.launches, chain_up.launches)
    w = chain_down(x, dn, cells=cells, k=k)
    y = chain_up(w, upm, cells=cells, k=k)
    torch.cuda.synchronize()
    assert (chain_down.launches, chain_up.launches) == (before[0] + 1,
                                                        before[1] + 1)
    assert w.shape == (nb,) + (nc * (k + 1),) * 3 and w.dtype == dtype
    assert y.shape == x.shape and y.dtype == dtype
    assert _rel(w, chain_down_reference(x, dn)) <= tol
    assert _rel(y, chain_up_reference(w, upm)) <= tol


# (nb, cells per axis, k, r): odd per-axis cell counts, one cell, r other
# than k + 1 (fewer and more rows than dofs per cell), k = 1, dim 2
_BLOCKED = [(5, (3, 5, 7), 4, 5), (3, (2, 3, 4), 2, 2), (2, (2, 3, 4), 2, 6),
            (4, (1, 1, 1), 3, 4), (3, (5, 1, 2), 1, 2), (6, (4, 3), 4, 5),
            (2, (1, 7), 2, 3), (3, (9, 2), 3, 8)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3),
                                       (torch.float64, 1e-13)])
@pytest.mark.parametrize("nb,cells,k,r", _BLOCKED)
def test_grid_chain_kernel_blocked(dev, nb, cells, k, r, dtype, tol):
    """Cell-blocked matrices of every shape the contract allows, dims 3
    and 2, and f32 output from bf16 data (the sums rounded once)."""
    g = torch.Generator(device=dev).manual_seed(nb * 31 + k * 7 + r)
    dn = [_blocked(nc, k, r, g, dev).to(dtype) for nc in cells]
    upm = [_blocked(nc, k, r, g, dev, up=True).to(dtype) for nc in cells]
    x = torch.randn((nb,) + tuple(nc * k + 1 for nc in cells), generator=g,
                    device=dev, dtype=torch.float64).to(dtype)
    w = chain_down(x, dn, cells=cells, k=k)
    assert w.shape == (nb,) + tuple(nc * r for nc in cells)
    assert _rel(w, chain_down_reference(x, dn)) <= tol
    y = chain_up(w, upm, cells=cells, k=k)
    assert y.shape == x.shape
    assert _rel(y, chain_up_reference(w, upm)) <= tol
    if dtype == torch.bfloat16:
        for fn, a, m in ((chain_down, x, dn), (chain_up, w, upm)):
            wide = fn(a, m, torch.float32, cells=cells, k=k)
            assert wide.dtype == torch.float32
            assert _rel(wide, chain_reference(a, m, torch.float32)) <= 1e-5


def test_grid_chain_kernel_rejects(dev):
    g = torch.Generator(device=dev).manual_seed(0)
    x = torch.zeros((2, 5, 5, 5), device=dev, dtype=torch.float64)
    dn = [_blocked(1, 4, 5, g, dev) for _ in range(3)]
    with pytest.raises(ValueError):          # f64 data, f32 matrices
        chain_down(x, dn, cells=(1, 1, 1), k=4)
    with pytest.raises(ValueError):          # no cell structure given
        chain_down(x.float(), dn)
    with pytest.raises(ValueError):          # matrix/x shape mismatch
        chain_down(x.float(), [torch.zeros((6, 4), device=dev)] * 3,
                   cells=(1, 1, 1), k=3)
    nine = [_blocked(3, 2, 3, g, dev) for _ in range(3)]
    nine[1][0, 5] = 1.0                      # off the cell blocks
    with pytest.raises(ValueError):
        chain_down(torch.zeros((1, 7, 7, 7), device=dev), nine,
                   cells=(3, 3, 3), k=2)
    dense = [torch.randn((9, 7), generator=g, device=dev) for _ in range(3)]
    with pytest.raises(ValueError):          # an unstructured matrix
        chain_down(torch.zeros((1, 7, 7, 7), device=dev), dense,
                   cells=(3, 3, 3), k=2)
    ok = [_blocked(3, 2, 3, g, dev, up=True) for _ in range(3)]
    w = torch.zeros((1, 9, 9, 9), device=dev)
    chain_up(w, ok, cells=(3, 3, 3), k=2)
    ok[2][1, 8] = 2.0                        # changed after its check
    with pytest.raises(ValueError):
        chain_up(w, ok, cells=(3, 3, 3), k=2)
    big = [_blocked(1, 4, 5, g, dev) for _ in range(2)] + [
        _blocked(300, 4, 5, g, dev)]
    with pytest.raises(ValueError):          # a row beyond the thread slots
        chain_down(torch.zeros((1, 5, 5, 1201), device=dev), big,
                   cells=(1, 1, 300), k=4)


# the tp_01 shapes (outer operator T=24, rhs slice T=3), small and ragged
# ones, then the FP64 tile plan's edges: C = 101 is a multiple of no
# tile's cell count, T = 9 splits into 5 + 4 blocks, A = 16, 27 and 125
# pad PhiG's rows (and Q its column groups)
_QUADS = ([(24, 4096, 64, 64, 3), (3, 4096, 64, 64, 3), (3, 64, 64, 64, 3),
           (1, 27, 64, 64, 3), (17, 100, 27, 27, 3), (5, 33, 16, 16, 2)]
          + [(T, 101, A, A, dim) for T in (1, 3, 5, 8, 9, 24)
             for A, dim in ((16, 2), (27, 3), (64, 3), (125, 3))])


@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12),
                                       (torch.float32, 1e-5)])
@pytest.mark.parametrize("T,C,A,Q,dim", _QUADS)
def test_quad_middle_kernel(dev, T, C, A, Q, dim, dtype, tol):
    g = torch.Generator(device=dev).manual_seed(T * C + A)
    r = lambda *s: torch.randn(s, generator=g, device=dev, dtype=dtype)
    ub, ua = r(T, C, A), r(T, C, A)
    PhiG, W = r(A, (1 + dim) * Q), r(C, (1 + dim) * Q).abs()
    before = quad_middle.launches
    got = quad_middle(ub, ua, PhiG, W, Q)
    torch.cuda.synchronize()
    assert quad_middle.launches == before + 1 and got.dtype == dtype
    assert got.shape == (T, C, A)
    assert _rel(got, quad_middle_reference(ub, ua, PhiG, W, Q)) <= tol


def test_quad_route_on_card(dev):
    """The route-3 FP64 slab operator (gather, premix, K5, scatter) and
    its slice form on the card against the same operator on the CPU."""
    import numpy as np

    from stfem_tpu_torch.problems.coefficient import Coefficient
    from stfem_tpu_torch.system import SystemMatrix
    from stfem_tpu_torch.time.tables import get_fe_time_weights
    from stfem_tpu_torch.types import TimeStepType

    A, B, G, _ = get_fe_time_weights(TimeStepType.DG, 2, 1 / 32, 2)
    mesh = StructuredMesh([3, 3, 3], [0.0] * 3, [1.0] * 3)
    coef = Coefficient([3, 3, 3], [0.0] * 3, [1.0] * 3, 0.5)
    x = torch.as_tensor(np.random.default_rng(0).standard_normal(
        (A.shape[0],) + mesh.dof_shape(3)))
    for d in (dev, torch.device("cpu")):
        ops = [LaplaceMassOperator(mesh, 3, 4, ms, ls, device=d,
                                   coefficient=c)
               for ms, ls, c in ((0.0, 1.0, coef), (1.0, 0.0, None))]
        lhs, rhs = SystemMatrix(*ops, A, B), SystemMatrix(*ops, 0 * G, G)
        assert lhs.route == rhs.route == "quad"
        y = (lhs.vmult(x.to(d)).cpu(), rhs.vmult_slice(x[0].to(d)).cpu())
        if d == dev:
            got = y
    assert _rel(got[0], y[0]) <= 1e-12 and _rel(got[1], y[1]) <= 1e-12


def test_quad_middle_kernel_rejects(dev):
    u = torch.zeros((2, 8, 64), device=dev, dtype=torch.float64)
    P, W = torch.zeros((64, 256), device=dev, dtype=torch.float64), \
        torch.zeros((8, 256), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):
        quad_middle(u.half(), u.half(), P.half(), W.half(), 64)
    with pytest.raises(ValueError):
        quad_middle(u, u, P, W[:, :200], 64)
    with pytest.raises(ValueError):
        quad_middle(u, u.float(), P, W, 64)
    big = torch.zeros((2, 8, 136), device=dev, dtype=torch.float64)
    with pytest.raises(ValueError):          # A beyond the FP64 tile
        quad_middle(big, big, torch.zeros((136, 512), device=dev,
                                          dtype=torch.float64),
                    torch.zeros((8, 512), device=dev, dtype=torch.float64),
                    128)


@pytest.mark.parametrize("route,k,coefficient", [("kron", 4, False),
                                                 ("quad", 3, True)])
def test_tvmult_on_card(dev, route, k, coefficient):
    """SystemMatrix.Tvmult on the card, route "kron" through K2 and route
    "quad" through K5, against the same operator's Tvmult on the CPU (the
    plain versions) and against vmult of the transposed tables on the
    card, FP64, within 1e-12."""
    import numpy as np

    from stfem_tpu_torch.ops.quad_middle import quad_middle as k5
    from stfem_tpu_torch.problems.coefficient import Coefficient
    from stfem_tpu_torch.system import SystemMatrix
    from stfem_tpu_torch.time.tables import get_fe_time_weights
    from stfem_tpu_torch.types import TimeStepType

    A, B, _, _ = get_fe_time_weights(TimeStepType.DG, 2, 1 / 32, 2)
    mesh = StructuredMesh([3, 4, 3], [0.0] * 3, [1.0] * 3)
    coef = Coefficient([3, 3, 3], [0.0] * 3, [1.0] * 3, 0.5) \
        if coefficient else None
    y = torch.as_tensor(np.random.default_rng(k).standard_normal(
        (A.shape[0],) + mesh.dof_shape(k)))
    kernel = kron_pair if route == "kron" else k5
    out = {}
    for d in (dev, torch.device("cpu")):
        ops = [LaplaceMassOperator(mesh, k, k + 1, ms, ls, device=d,
                                   coefficient=c)
               for ms, ls, c in ((0.0, 1.0, coef), (1.0, 0.0, None))]
        S = SystemMatrix(*ops, A, B)
        assert S.route == route
        before = kernel.launches
        out[d.type] = (S.Tvmult(y.to(d)).cpu(),
                       SystemMatrix(*ops, A.T, B.T).vmult(y.to(d)).cpu())
        if d == dev:
            torch.cuda.synchronize()
            assert kernel.launches > before
    got, ref = out["cuda"], out["cpu"]
    assert _rel(got[0], ref[0]) <= 1e-12 and _rel(got[0], got[1]) <= 1e-12


# every level shape of the heat marches (blocks, n): 32 x 3^3 .. 96 x
# 129^3, at each degree k in {1, 2, 4} that the grid can hold
_LEVEL_PAIRS = [(B, n, k) for B, n in ((32, 3), (32, 5), (64, 5), (64, 9),
                                       (96, 9), (96, 17), (96, 33),
                                       (96, 65), (96, 129))
                for k in (1, 2, 4) if (n - 1) % k == 0]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("B,n,k", _LEVEL_PAIRS)
def test_level_pair_kernel(dev, B, n, k, dtype, tol):
    """K6 with a level's own factors against its plain version."""
    cells = (n - 1) // k
    mesh = StructuredMesh([cells] * 3, [0.0] * 3, [1.0] * 3)
    ops = [LaplaceMassOperator(mesh, k, k + 1, m, l, dtype=dtype,
                               device=dev) for m, l in ((0.0, 1.0),
                                                        (1.0, 0.0))]
    kron = KronAssembled(*ops, dtype)
    g = torch.Generator(device=dev).manual_seed(B * n + k)
    x = torch.randn((B, n, n, n), generator=g, device=dev).to(dtype)
    before = level_pair.launches
    Kk, Mk = level_pair(x, *kron._level, k)
    torch.cuda.synchronize()
    assert level_pair.launches == before + 1 and Kk.dtype == dtype
    Kr, Mr = level_pair_reference(x, *kron._level, k)
    assert _rel(Kk, Kr) <= tol and _rel(Mk, Mr) <= tol


def test_level_pair_kernel_rejects(dev):
    dm, da = level_pair_tables([torch.zeros((3, 5))] * 3,
                               [torch.zeros((3, 5))] * 3, torch.float32)
    dm, da = dm.to(dev), da.to(dev)
    for bad in (torch.zeros((1, 5, 5, 5), device=dev, dtype=torch.float64),
                torch.zeros((1, 5, 5, 5), device=dev, dtype=torch.float16),
                torch.zeros((1, 5, 5, 5), device=dev).transpose(1, 3)):
        with pytest.raises(ValueError):
            level_pair(bad, dm, da, 1)
    with pytest.raises(ValueError):          # tables of another k
        level_pair(torch.zeros((1, 5, 5, 5), device=dev), dm, da, 2)


@pytest.mark.parametrize("dim,k,need", [(3, 4, (True, True)),
                                        (3, 2, (True, True)),
                                        (3, 5, (True, True)),
                                        (2, 4, (True, True)),
                                        (3, 4, (False, True)),
                                        (3, 4, (True, False))])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_kron_pair_low_precision_route(dev, dim, k, need, dtype):
    """A bf16 / float32 pair on the card takes K6 (one launch) for both
    outputs of a 3D grid with k <= 4, the dense matmuls otherwise; each
    against the FP64 pair of the same rounded factors."""
    mesh = StructuredMesh([2, 3, 2][:dim], [0.0] * dim, [1.0] * dim)
    ops = [LaplaceMassOperator(mesh, k, k + 1, m, l, dtype=dtype,
                               device=dev) for m, l in ((0.0, 1.0),
                                                        (1.0, 0.0))]
    kron = KronAssembled(*ops, dtype)
    g = torch.Generator(device=dev).manual_seed(k)
    x = torch.randn((6,) + mesh.dof_shape(k), generator=g,
                    device=dev).to(dtype)
    before = level_pair.launches
    got = kron.pair(x, *need)
    torch.cuda.synchronize()
    k6 = dim == 3 and k <= 4 and all(need)
    assert level_pair.launches == before + int(k6)
    ref = kron_pair_reference(x.double(), [D.double() for D in kron.Md],
                              [D.double() for D in kron.Ad], k)
    # bf16: K6 rounds once (2^-8 of an entry at most), the dense route
    # after each of its matmuls
    tol = 1e-5 if dtype == torch.float32 else (4e-3 if k6 else 3e-2)
    for g_, r_, want in zip(got, ref, need):
        assert (g_ is None) == (not want)
        if want:
            assert g_.dtype == dtype and _rel(g_, r_) <= tol


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 1.2e-2)])
def test_level_vmult_on_card(dev, dtype, tol):
    """SystemMatrix.vmult of a bf16 / float32 level operator on route
    "kron" (K6) against the FP64 operator on the same input (its factors,
    tables and input rounded to the level's dtype: the dense route reads
    1.9e-7 and 9.2e-3 here on the CPU)."""
    import numpy as np

    from stfem_tpu_torch.system import SystemMatrix
    from stfem_tpu_torch.time.tables import get_fe_time_weights
    from stfem_tpu_torch.types import TimeStepType

    A, Bt, _, _ = get_fe_time_weights(TimeStepType.DG, 2, 1 / 32, 4)
    mesh = StructuredMesh([4, 3, 5], [0.0] * 3, [1.0] * 3)
    y = torch.as_tensor(np.random.default_rng(7).standard_normal(
        (A.shape[0],) + mesh.dof_shape(4)), device=dev)
    out = {}
    for dt in (dtype, torch.float64):
        ops = [LaplaceMassOperator(mesh, 4, 5, ms, ls, dtype=dt, device=dev)
               for ms, ls in ((0.0, 1.0), (1.0, 0.0))]
        S = SystemMatrix(*ops, A, Bt, precision=None)
        assert S.route == "kron"
        before = level_pair.launches
        out[dt] = S.vmult(y.to(dt))
        torch.cuda.synchronize()
        assert level_pair.launches == before + int(dt != torch.float64)
    assert _rel(out[dtype], out[torch.float64]) <= tol

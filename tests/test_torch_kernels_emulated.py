"""Kernels K4 (csrc/grid_chain.cu), K2 (csrc/kron_pair.cu), K3
(csrc/banded_apply.cu), K1 (csrc/time_solve.cu) and K6
(csrc/level_pair.cu) run on the CPU through
tests/cuda_emulator.py (g++, one std::thread per CUDA thread), called with
the arguments their wrappers prepare (the wrappers' kernel_args: the same
checks, tile plans and output buffers as on the card), against the plain
torch versions.

This holds the kernels' indexing, tiling and barriers on the CPU; the card
tests (tests/test_torch_kernels_cuda.py) hold what nvcc builds.  Shared
memory starts as NaN in the emulator, so a read of an unwritten element
fails the comparison.  Tolerances, relative to the plain version's max
norm, as on the card: K4 float64 1e-13, float32 1e-5, bf16 8e-3 (one bf16
rounding); K2 and K3 float64 1e-14; K1 float32 1e-5, bf16 8e-3; K6
float32 1e-6 (the same float32 taps up to FMA contraction and order),
bf16 8e-3."""
import numpy as np
import pytest
import torch

from stfem_tpu_torch.ops import (banded_apply, cuda_kernels, grid_chain,
                                 kron_pair, level_pair, time_solve)

from cuda_emulator import build

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def emulated(tmp_path_factory):
    lib = build(tmp_path_factory.mktemp("emulated_kernels"))
    if lib is None:
        pytest.skip("needs g++ with C++20 <barrier> to emulate the kernels")
    return cuda_kernels.bind(lib)


def _rel(a, b):
    return float((a.double() - b.double()).abs().max()
                 / b.double().abs().max())


def _blocked(rng, nc, k, r, up, dtype):
    m = rng.standard_normal((nc * r, nc * k + 1)) * grid_chain.cell_block_mask(
        nc, k, r).numpy()
    return torch.as_tensor(m.T.copy() if up else m).to(dtype)


def _chain(lib, x, mats, cells, k, up, out_dtype):
    args, (y, _x) = grid_chain.kernel_args(x, mats, out_dtype, cells, k, up)
    y.fill_(float("nan"))
    assert lib.stfem_grid_chain(*args, None) == 0
    return y[:, 0] if len(mats) == 2 else y


# (nb, cells per axis, k, r): the Vanka's r = k + 1 on odd and non-cubic
# grids with several axis-1 tiles and a short last one (5 cells in 2 + 2
# + 1 down, 3 + 2 up), one cell, r other than k + 1, dim 2
_CHAINS = [(2, (3, 5, 16), 4, 5), (1, (2, 3, 4), 2, 2), (1, (2, 3, 4), 2, 6),
           (2, (1, 1, 1), 3, 4), (2, (5, 1, 2), 1, 2), (2, (4, 3), 4, 5),
           (1, (9, 2), 3, 8)]
_KINDS = [(torch.float64, torch.float64, 1e-13),
          (torch.float32, torch.float32, 1e-5),
          (torch.bfloat16, torch.bfloat16, 8e-3),
          (torch.bfloat16, torch.float32, 1e-5)]


@pytest.mark.parametrize("dtype,out_dtype,tol", _KINDS)
@pytest.mark.parametrize("nb,cells,k,r", _CHAINS)
def test_grid_chain_emulated(emulated, nb, cells, k, r, dtype, out_dtype,
                             tol):
    rng = np.random.default_rng(nb * 100 + k * 10 + r)
    dn = [_blocked(rng, c, k, r, False, dtype) for c in cells]
    up = [_blocked(rng, c, k, r, True, dtype) for c in cells]
    x = torch.as_tensor(rng.standard_normal(
        (nb,) + tuple(c * k + 1 for c in cells))).to(dtype)
    w = _chain(emulated, x, dn, cells, k, False, out_dtype)
    ref = grid_chain.chain_reference(x, dn, out_dtype)
    assert w.shape == ref.shape and _rel(w, ref) <= tol
    wi = ref.to(dtype)
    y = _chain(emulated, wi, up, cells, k, True, out_dtype)
    ref = grid_chain.chain_reference(wi, up, out_dtype)
    assert y.shape == x.shape and _rel(y, ref) <= tol


def _diags(rng, k, n):
    """Random (2k+1, n) diagonals, zero off-range as to_diags stores."""
    D = rng.standard_normal((2 * k + 1, n))
    for o in range(2 * k + 1):
        D[o, :max(0, k - o)] = 0.0
        D[o, min(n, n + k - o):] = 0.0
    return torch.as_tensor(D)


# (cells per axis, k, B): n < 2k+1, odd and non-cubic grids, axis 1 in
# several tiles (n1 = 33 in 3 x 11; n1 = 11 in 6 + 5), k = 0-4
@pytest.mark.parametrize("cells,k,B", [((2, 3, 4), 2, 2), ((1, 1, 1), 4, 2),
                                       ((1, 2, 1), 3, 1), ((4, 2, 3), 4, 1),
                                       ((2, 8, 8), 4, 1), ((2, 2, 2), 0, 1),
                                       ((1, 5, 24), 2, 1)])
def test_kron_pair_emulated(emulated, cells, k, B):
    rng = np.random.default_rng(B * 10 + k)
    n = [c * k + 1 for c in cells]
    Dm = [_diags(rng, k, nd) for nd in n]
    Da = [_diags(rng, k, nd) for nd in n]
    x = torch.as_tensor(rng.standard_normal((B,) + tuple(n)))
    args, (kx, mx), _tables = kron_pair.kernel_args(x, Dm, Da, k)
    kx.fill_(float("nan"))
    mx.fill_(float("nan"))
    assert emulated.stfem_kron_pair(*args, None) == 0
    Kr, Mr = kron_pair.kron_pair_reference(x, Dm, Da, k)
    assert _rel(kx, Kr) <= 1e-14 and _rel(mx, Mr) <= 1e-14


# each of K3's three forms: whole rows (inner = 1, n <= 256), short slabs
# (n inner <= 4608) and register-window pencils (segmented here: too few
# pencils to fill the card), at every half-bandwidth the kernel is built
# for, Q5's k = 5 among them, n < 2k + 1 included
@pytest.mark.parametrize("k", range(banded_apply.MAX_K + 1))
@pytest.mark.parametrize("shape,axis", [((3, 4, 11), -1), ((2, 11, 6), -2),
                                        ((2, 7, 9, 3), -3),
                                        ((1, 41, 120), -2)])
def test_banded_apply_emulated(emulated, shape, axis, k):
    rng = np.random.default_rng(10 * k + len(shape))
    x = torch.as_tensor(rng.standard_normal(shape))
    D = _diags(rng, k, shape[axis])
    args, y = banded_apply.kernel_args(x, D, axis, k)
    y.fill_(float("nan"))
    assert emulated.stfem_banded_apply(*args, None) == 0
    ref = banded_apply.banded_apply_reference(x, D, axis, k)
    assert _rel(y, ref) <= 1e-14


# every nt the kernel is built for (dG(4)'s nt = 5 among them), a ragged
# last block of positions
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("nt", range(1, time_solve.MAX_NT + 1))
def test_time_solve_emulated(emulated, nt, dtype, tol):
    rng = np.random.default_rng(nt)
    S, N = 3, 300
    w = torch.as_tensor(rng.standard_normal((S * nt, N))).to(dtype)
    G = torch.as_tensor(0.3 * rng.standard_normal((nt, nt, N)),
                        dtype=torch.float32)
    c = torch.as_tensor(rng.uniform(-0.9, 0.9, (nt, N)), dtype=torch.float32)
    args, out = time_solve.kernel_args(w, G, c, S, nt, dtype)
    out.fill_(float("nan"))
    assert emulated.stfem_time_solve(*args, None) == 0
    ref = time_solve.time_solve_reference(w, G, c, S, nt, dtype)
    assert _rel(out, ref) <= tol


# (cells per axis, k, lead shape): odd n everywhere (bf16 plane tiles
# start mid-word), axis 1 in several tiles (n1 = 33 with n2 = 33: 15 + 15
# + 3 rows; n1 = 41 with n2 = 121: 4 rows a tile, the halo rows of inner
# tiles out of the grid only at the ends), n < 2k + 1, a batch of blocks
# and an extra batch axis, every k the kernel is built for
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-6),
                                       (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("cells,k,lead", [((2, 8, 8), 4, (2,)),
                                          ((1, 40, 120), 1, (1,)),
                                          ((2, 3, 4), 2, (2, 3)),
                                          ((1, 1, 1), 4, (3,)),
                                          ((3, 2, 1), 0, (2,)),
                                          ((4, 6, 5), 3, (1,)),
                                          ((2, 16, 16), 2, (1,))])
def test_level_pair_emulated(emulated, cells, k, lead, dtype, tol):
    rng = np.random.default_rng(sum(cells) * 10 + k)
    n = [c * max(k, 1) + 1 for c in cells]
    # diagonals nonzero off-range too: the rows and planes outside the
    # grid have to read as zero
    dm, da = (level_pair.tables([torch.as_tensor(rng.standard_normal(
        (2 * k + 1, nd))) for nd in n], [torch.as_tensor(
            rng.standard_normal((2 * k + 1, nd))) for nd in n], dtype))
    x = torch.as_tensor(rng.standard_normal(lead + tuple(n))).to(dtype)
    args, (kx, mx) = level_pair.kernel_args(x, dm, da, k)
    kx.fill_(float("nan"))
    mx.fill_(float("nan"))
    assert emulated.stfem_level_pair(*args, None) == 0
    Kr, Mr = level_pair.level_pair_reference(x, dm, da, k)
    assert _rel(kx, Kr) <= tol and _rel(mx, Mr) <= tol

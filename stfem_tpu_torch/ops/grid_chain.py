"""K4: the per-block grid chain of the grid-mode Vanka down/up
(counterpart of stfem_tpu/ops/pallas_grid.py::chain_down / chain_up).

For every leading block b,
    y[b] = (M_0 (x) M_1 (x) ... (x) M_{dim-1}) x[b],
with mats[d] of shape (out_d, in_d): (q_d, n_d) for the down chain (dof
grid -> eigen positions), (n_d, q_d) for the up chain.  The sums run in
float32 (float64 for float64 data) from bf16/f32 data and matrices, and
the result is rounded once to the output dtype, as the TPU kernel does.
Both chains keep the natural axis order (q_0, q_1, ...): the rotated order
of stfem_tpu's chain_down (pallas_grid.chain_down_order) is a Mosaic
artifact that the port does not carry.

The kernel (csrc/grid_chain.cu) takes cell-blocked matrices only: axis d
has cells[d] cells of degree k, n_d = cells[d] k + 1 dofs and q_d =
cells[d] r_d eigen rows (r_d = q_d / cells[d]; the Vanka's r = k + 1), and
row c r + a of the down matrix reads only dofs c k .. c k + k; the up
matrix is that pattern transposed.  `check_cell_blocks` verifies the
pattern once per matrix (PreconditionVanka at build, utils/carry.py's
load_vanka after it overwrites the matrices) and stamps the tensor; the
wrappers check the stamp, so a matrix that was never checked is checked
at its first launch and one that fails raises.

`chain_down` / `chain_up` launch the kernel on CUDA tensors (dim 3, and
dim 2 as a leading axis of one cell) and use the plain torch version,
`chain_reference`, only for tensors on the CPU.  There is no fallback: a
CUDA call without `cells` and `k`, with matrices off the pattern, or with
a shape the kernel does not take raises, as does a failed build or launch.
`chain_down_blocked` / `chain_up_blocked` are plain torch forms that
follow the kernel's indexing (cell-local down; owner-computes up with the
c-1 face rule); the tests hold them against `chain_reference`.
"""
from __future__ import annotations

import ctypes

import torch

from .cuda_kernels import check, library
from .gridsumfac import axis_apply

__all__ = ["chain_down", "chain_up", "chain_down_reference",
           "chain_up_reference", "chain_down_blocked", "chain_up_blocked",
           "check_cell_blocks", "cell_block_mask", "kernel_args", "tile_plan"]

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.float64: 2}
MAX_THREADS, MAX_R = 256, 8             # csrc/grid_chain.cu's limits
# the tile plan: at most TILE_CELLS axis-1 cells and MAX_POSITIONS outputs
# a CTA, THREADS threads (chosen on an H100 at the heat and wave fine
# levels, where they beat 128 and 256 threads and 1-3 cells)
TILE_CELLS, MAX_POSITIONS, THREADS = 4, 2048, 192


def _acc(dtype) -> torch.dtype:
    return torch.float64 if dtype == torch.float64 else torch.float32


def chain_reference(x: torch.Tensor, mats, out_dtype=None) -> torch.Tensor:
    """Plain torch version: the per-axis tensordot chain in the
    accumulation dtype, one cast at the end."""
    acc = _acc(x.dtype)
    t = x.to(acc)
    for d, m in enumerate(mats):
        t = axis_apply(m.to(acc), t, 1 + d)
    return t.to(out_dtype or x.dtype)


chain_down_reference = chain_up_reference = chain_reference


def _dof_cells(nc: int, k: int):
    """Per dof j: the cell that holds it (the last cell for the last dof)
    and whether it is a face shared with cell c - 1."""
    j = torch.arange(nc * k + 1)
    c = torch.zeros_like(j) if k == 0 else torch.clamp(j // k, max=nc - 1)
    return c, (j == c * k) & (c > 0)


def cell_block_mask(nc: int, k: int, r: int, up: bool = False):
    """Boolean (q, n) mask of the down pattern, (n, q) for up: row c r + a
    reads dofs c k .. c k + k (q = nc r, n = nc k + 1)."""
    mask = torch.zeros((nc * r, nc * k + 1), dtype=torch.bool)
    for c in range(nc):
        mask[c * r:(c + 1) * r, c * k:c * k + k + 1] = True
    return mask.T if up else mask


def _stamp(m, nc, k, up):
    return (bool(up), int(nc), int(k), m._version)


def check_cell_blocks(mats, cells, k: int, up: bool = False) -> None:
    """Raise ValueError unless every mats[d] is zero off the cell-blocked
    pattern of cells[d] cells of degree k (shape (nc r, nc k + 1) down,
    transposed up, 1 <= r <= 8, k <= 7); stamp the tensors that pass.  On
    a CUDA tensor this reads one flag back (once per matrix)."""
    if len(mats) != len(cells):
        raise ValueError(f"{len(mats)} matrices for {len(cells)} axes")
    for d, (m, nc) in enumerate(zip(mats, cells)):
        nc, n = int(nc), int(nc) * k + 1
        rows, cols = ((m.shape[-1], m.shape[0]) if up
                      else (m.shape[0], m.shape[-1]))
        r = rows // nc
        if (m.ndim != 2 or cols != n or rows != nc * r or not 1 <= r <= MAX_R
                or not 0 <= k < MAX_R):
            raise ValueError(f"axis {d}: matrix {tuple(m.shape)} is not "
                             f"cell-blocked for {nc} cells of degree {k}")
        mask = cell_block_mask(nc, k, r, up).to(m.device)
        if bool((m.masked_select(~mask) != 0).any()):
            raise ValueError(f"axis {d}: matrix {tuple(m.shape)} has "
                             "nonzeros off the cell blocks")
        m._stfem_cell_blocks = _stamp(m, nc, k, up)


def _require_blocks(mats, cells, k, up, name):
    if cells is None or k is None:
        raise ValueError(f"{name}: the kernel takes cell-blocked matrices: "
                         "pass cells= and k=")
    if len(cells) != len(mats):
        raise ValueError(f"{name}: {len(cells)} cells for {len(mats)} axes")
    for m, nc in zip(mats, cells):
        if getattr(m, "_stfem_cell_blocks", None) != (up, nc, k, m._version):
            check_cell_blocks([m], [nc], k, up)


def chain_down_blocked(x: torch.Tensor, mats, cells, k: int,
                       out_dtype=None) -> torch.Tensor:
    """Plain torch, the down kernel's indexing: each cell's (k+1)^dim dofs
    map to its r^dim eigen positions through the cells' (r, k+1) blocks."""
    acc = _acc(x.dtype)
    t = x.to(acc)
    for d, (m, nc) in enumerate(zip(mats, cells)):
        nc = int(nc)
        r = m.shape[0] // nc
        idx = torch.arange(nc)[:, None] * k + torch.arange(k + 1)
        rows = torch.arange(nc)[:, None, None] * r + torch.arange(r)[:, None]
        blocks = m.to(acc)[rows, idx[:, None, :]]          # (nc, r, k+1)
        win = t.movedim(1 + d, -1)[..., idx]                # (.., nc, k+1)
        t = torch.einsum("...cl,cal->...ca", win, blocks).flatten(-2)
        t = t.movedim(-1, 1 + d)
    return t.to(out_dtype or x.dtype)


def chain_up_blocked(w: torch.Tensor, mats, cells, k: int,
                     out_dtype=None) -> torch.Tensor:
    """Plain torch, the up kernel's indexing (owner computes): dof j of
    cell c collects c's r rows and, at a face (j = c k, c > 0), cell
    c-1's r rows."""
    acc = _acc(w.dtype)
    t = w.to(acc)
    for d, (m, nc) in enumerate(zip(mats, cells)):
        nc = int(nc)
        r = m.shape[1] // nc
        c, face = _dof_cells(nc, k)
        own = c[:, None] * r + torch.arange(r)                # (n, r)
        prev = torch.where(face[:, None], own - r, 0)
        j = torch.arange(nc * k + 1)[:, None]
        mm = m.to(acc)
        c_own, c_prev = mm[j, own], mm[j, prev] * face[:, None].to(acc)
        tt = t.movedim(1 + d, -1)
        t = (torch.einsum("...ja,ja->...j", tt[..., own], c_own)
             + torch.einsum("...ja,ja->...j", tt[..., prev], c_prev))
        t = t.movedim(-1, 1 + d)
    return t.to(out_dtype or w.dtype)


def tile_plan(up: bool, nc1: int, k1: int, r1: int, width: int):
    """(axis-1 cells per CTA, tiles, threads per CTA) of the kernel: up to
    TILE_CELLS cells whose outputs fit MAX_POSITIONS, spread evenly over
    the tiles.  A CTA writes (cells k1 [+ 1 on the last tile]) dof rows
    (up) or cells r1 eigen rows (down) of `width` = n2 (up) or q2 (down)
    each."""
    rows = (lambda t: t * k1 + 1) if up else (lambda t: t * r1)
    if rows(1) * width > MAX_POSITIONS:
        raise ValueError(f"grid chain: a row of {rows(1)} x {width} "
                         f"positions exceeds the kernel's {MAX_POSITIONS}")
    t = min(TILE_CELLS, nc1)
    while rows(t) * width > MAX_POSITIONS:
        t -= 1
    n_tiles = -(-nc1 // t)
    t = -(-nc1 // n_tiles)
    return t, n_tiles, min(THREADS, 32 * -(-rows(t) * width // 32))


def kernel_args(x: torch.Tensor, mats, out_dtype, cells, k, up: bool,
                name: str = "grid chain"):
    """Check what the kernel takes and prepare its call: (the arguments of
    stfem_grid_chain but the stream, the output y).  Raises ValueError."""
    dim = len(mats)
    if dim not in (2, 3) or x.ndim != dim + 1:
        raise ValueError(f"{name}: the kernel takes x of shape (nb, n_0.."
                         f"n_{{dim-1}}) with dim 2 or 3, got {tuple(x.shape)}"
                         f" and {dim} matrices")
    mdt = mats[0].dtype
    if any(m.dtype != mdt or m.device != x.device or m.ndim != 2
           for m in mats):
        raise ValueError(f"{name}: the matrices must be 2D, of one dtype, "
                         "on x's device")
    wide = x.dtype == torch.float64
    if (x.dtype not in _DTYPE_CODE or out_dtype not in _DTYPE_CODE
            or mdt not in _DTYPE_CODE
            or wide != (mdt == torch.float64)
            or wide != (out_dtype == torch.float64)):
        raise ValueError(f"{name}: dtypes x {x.dtype}, matrices {mdt}, out "
                         f"{out_dtype} (bf16/f32 data and matrices, or all "
                         "f64)")
    if any(m.shape[1] != n for m, n in zip(mats, x.shape[1:])):
        shapes = [tuple(m.shape) for m in mats]
        raise ValueError(f"{name}: matrix shapes {shapes} do not match x "
                         f"{tuple(x.shape)}")
    if not all(m.is_contiguous() for m in mats):
        raise ValueError(f"{name}: the matrices must be contiguous")
    _require_blocks(mats, cells, k, up, name)
    nc = [int(c) for c in cells]
    r = [(m.shape[1] if up else m.shape[0]) // c for m, c in zip(mats, nc)]
    ks = [k] * dim
    m0 = mats[0].data_ptr() if dim == 3 else None
    if dim == 2:          # a leading axis of one cell, k = 0: the identity
        x = x.unsqueeze(1)
        nc, ks, r, mats = [1] + nc, [0] + ks, [1] + r, [None] + list(mats)
    x = x.contiguous()
    tile1, _, threads = tile_plan(up, nc[1], ks[1], r[1], mats[2].shape[0])
    out = tuple(m.shape[0] for m in mats[1:])
    y = torch.empty((x.shape[0], 1 if dim == 2 else mats[0].shape[0])
                    + out, dtype=out_dtype, device=x.device)
    i3 = ctypes.c_int * 3
    args = (int(up), x.data_ptr(), m0, mats[1].data_ptr(),
            mats[2].data_ptr(), y.data_ptr(), x.shape[0], i3(*nc), i3(*ks),
            i3(*r), tile1, threads, _DTYPE_CODE[x.dtype], _DTYPE_CODE[mdt],
            _DTYPE_CODE[out_dtype])
    # x may be a new contiguous copy: the caller keeps it alive with y
    return args, (y, x)


def _launch(x: torch.Tensor, mats, out_dtype, cells, k, up: bool,
            name: str) -> torch.Tensor:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: unsupported device {x.device}")
    args, (y, _x) = kernel_args(x, mats, out_dtype, cells, k, up, name)
    code = library().stfem_grid_chain(
        *args, torch.cuda.current_stream(x.device).cuda_stream)
    check(code, name)
    return y[:, 0] if len(mats) == 2 else y


def chain_down(x: torch.Tensor, mats, out_dtype=None, *, cells=None,
               k=None) -> torch.Tensor:
    """x: (nb, n_0, .., n_{dim-1}); mats[d]: (q_d, n_d) ->
    (nb, q_0, .., q_{dim-1}) in out_dtype (default x.dtype).  On the card
    cells (per axis) and k give the cell blocks."""
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return chain_reference(x, mats, out_dtype)
    y = _launch(x, mats, out_dtype, cells, k, False, "chain_down")
    chain_down.launches += 1
    return y


def chain_up(w: torch.Tensor, mats, out_dtype=None, *, cells=None,
             k=None) -> torch.Tensor:
    """w: (nb, q_0, .., q_{dim-1}); mats[d]: (n_d, q_d) ->
    (nb, n_0, .., n_{dim-1}) in out_dtype (default w.dtype).  On the card
    cells (per axis) and k give the cell blocks."""
    out_dtype = out_dtype or w.dtype
    if w.device.type == "cpu":
        return chain_reference(w, mats, out_dtype)
    y = _launch(w, mats, out_dtype, cells, k, True, "chain_up")
    chain_up.launches += 1
    return y


chain_down.launches = 0
chain_up.launches = 0

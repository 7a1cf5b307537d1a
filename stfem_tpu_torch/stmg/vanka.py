"""Cell-wise Vanka patch smoother by fast diagonalisation (counterpart of
stfem_tpu/stmg/vanka.py::PreconditionVanka, mode "fastdiag"): the grid
mode for separable levels (STFEM_GRID_VANKA on, stfem_tpu's default) and
the cell-local mode for levels with a coefficient field, a cell mask or a
distorted, mapped or Q1 geometry.

The space-time patch matrix B_c = Alpha (x) K_loc_c + Beta (x) M_loc_c,
row-scaled by dof valence (reference include/stmg.h:619-907), is inverted
by fast diagonalisation: on a tensor mesh (uniform or stepped) every patch
inherits the per-axis generalized eigenbases V_d of the 1D patch
matrices, so
    B_c^{-1} = (I (x) V) [per eigenvalue (lam Alpha + Beta)^{-1}] (I (x) V^T).
The apply is "grid" form: the gather, the valence scaling and V_d^T fold
into one banded matrix per axis (Wdn), the per-position time solve runs on
the flat eigen-position axis (kernel K1, ops/time_solve.py, for
multi-step slabs with rank-1 step coupling; a dense per-position T x T
solve otherwise, e.g. for the wave tables), and the transposed matrices
(Wup) apply V_d and the overlap-add scatter.  Both chains of per-axis
matrices run as kernel K4 (ops/grid_chain.py), always: stfem_tpu's
STFEM_PALLAS_GRID=1 path, whose rotated factor order (factor_perm) is not
carried over.

When the geometry or a coefficient field breaks the separability
(separable() below), each cell's patch gets its own eigenbasis: the
assembled patch matrices (band assembly -> patch extraction) are whitened
by the Cholesky factor of M_loc and diagonalised by one batched eigh,
giving a dense V (C, A, A)
with V^T M_loc V = I, V^T K_loc V = diag(lam).  The apply is gather ->
valence scaling -> V^T -> the per-position time solve on the flat N = C A
axis (kernel K1 for multi-step slabs, as in grid mode) -> V -> scatter.
The factors are built in float64 on the host and stored in the level
dtype.  The dense reference-style patch inverse (mode "dense") is not
ported.

On a level split over ranks (stmg/gmg.py::distribute_gmg) a rank's grid
Vanka is the global one's slice (PreconditionVanka.shard): its cells'
rows of Wdn and Wup and its cells' eigen-positions of the time factors.
So the 1D valence is the global grid's (2 on a plane shared with a
neighbour rank, where a sub-mesh of its own would count 1), the masks
are the global ones (a shared plane is interior), and each cell's patch
eigenbasis is the global assembled matrices' (a cell at a rank's edge
sees its neighbour's half of the shared node).  The up chain leaves
partial sums on the shared planes: the caller accumulates them.
"""
from __future__ import annotations

import copy

import numpy as np
import torch

from ..ops.grid_chain import chain_down, chain_up, check_cell_blocks
from ..ops.gridsumfac import promote
from ..ops.kronfac import assemble_1d_dense, axis_mesh
from ..ops.spatial import LaplaceMassOperator, cell_gather, overlap_add
from ..ops.time_solve import time_solve
from ..utils.assembly import (band_indices, cell_dof_indices, dof_valence,
                              overlap_sources)
from .stokes_level import _band_flat


def separable(K_op: LaplaceMassOperator, M_op: LaplaceMassOperator) -> bool:
    """True when the patch eigenbasis factorizes per axis: diagonal
    Jacobians, no coefficient field, cell mask or explicit (distorted or
    Q1-mapped) vertices, and the default Dirichlet masks (stfem_tpu's
    separable_eigenbasis returns None otherwise, stfem_tpu/stmg/
    vanka.py:119-128)."""
    mesh = K_op.mesh
    if (K_op.jinv is not None or K_op.coeff is not None
            or M_op.coeff is not None or mesh.cell_mask is not None
            or mesh.vertices is not None):
        return False
    default = mesh.boundary_dof_mask(K_op.degree)
    return (np.array_equal(K_op.mask_np, default)
            and np.array_equal(M_op.mask_np, default))


def cell_eigenbasis(K_op: LaplaceMassOperator, M_op: LaplaceMassOperator):
    """Per-cell generalized eigenpairs of the assembled patch matrices
    (K_loc, M_loc), float64 on the host: (lam [C, A], V [C, A, A]) with
    V^T M_loc V = I and V^T K_loc V = diag(lam) (stfem_tpu's _eigenbasis:
    Cholesky whitening, then a batched symmetric eigh)."""
    f64 = torch.float64
    twins = [LaplaceMassOperator(op.mesh, op.degree, op.n_q,
                                 op.mass_scaling, op.laplace_scaling,
                                 dtype=f64, device="cpu", mask=op.mask_np,
                                 coefficient=op.coefficient)
             for op in (K_op, M_op)]
    fidx = torch.as_tensor(band_indices(K_op.cells, K_op.degree))
    Kp, Mp = (_band_flat(op)[fidx] for op in twins)          # (C, A, A)
    L = torch.linalg.cholesky(Mp)
    eye = torch.eye(Mp.shape[-1], dtype=f64).expand_as(Mp)
    Linv = torch.linalg.solve_triangular(L, eye, upper=False)
    Cm = torch.einsum("cab,cbd,ced->cae", Linv, Kp, Linv)
    lam, Qm = torch.linalg.eigh(0.5 * (Cm + Cm.transpose(1, 2)))
    return lam, torch.einsum("cba,cbq->caq", Linv, Qm)


def separable_eigenbasis(K_op: LaplaceMassOperator,
                         M_op: LaplaceMassOperator):
    """Per-axis Kronecker factorization of the patch generalized
    eigenbasis (Lynch-Rice-Thomas fast diagonalisation).

    Per axis and cell, the free (unconstrained) 1D patch dofs get the
    generalized eigenpairs of (K1_patch, M1_patch) -- V^T M V = I,
    V^T K V = diag(lam); constrained dofs get unit vectors with the
    placeholder eigenvalue 1/dim (they only ever see a zero residual).

    Each axis' 1D mesh carries its steps (ops/kronfac.py::axis_mesh).
    Returns (lam [C, A] float64, V_axes list of [cells_d, k+1, k+1])."""
    import scipy.linalg

    mesh = K_op.mesh
    k, dim = K_op.degree, K_op.dim
    lam_axes, v_axes = [], []
    for d in range(dim):
        nc = int(mesh.cells[d])
        mesh1 = axis_mesh(mesh, d)
        mask1 = mesh1.boundary_dof_mask(k)
        patches = []
        for ms, ls in ((0.0, 1.0), (1.0, 0.0)):
            op = LaplaceMassOperator(mesh1, k, K_op.n_q, ms, ls,
                                     dtype=torch.float64, device="cpu")
            # assembled 1D matrix, unit diagonal on constrained dofs
            patches.append(assemble_1d_dense(op) + np.diag(1.0 - mask1))
        Kd, Md = patches
        lam_d = np.full((nc, k + 1), 1.0 / dim)
        V_d = np.zeros((nc, k + 1, k + 1))
        for c in range(nc):
            sl = slice(c * k, c * k + k + 1)
            free = mask1[sl] > 0.0
            idx, cidx = np.where(free)[0], np.where(~free)[0]
            if len(idx):
                w, v = scipy.linalg.eigh(Kd[sl, sl][np.ix_(idx, idx)],
                                         Md[sl, sl][np.ix_(idx, idx)])
                lam_d[c, idx] = w
                V_d[c][np.ix_(idx, idx)] = v
            V_d[c][cidx, cidx] = 1.0
        lam_axes.append(lam_d)
        v_axes.append(V_d)
    lam = np.zeros(tuple(int(c) for c in mesh.cells) + (k + 1,) * dim)
    for d in range(dim):
        s = [1] * (2 * dim)
        s[d] = mesh.cells[d]
        s[dim + d] = k + 1
        lam = lam + lam_axes[d].reshape(s)
    return lam.reshape(mesh.n_cells, (k + 1) ** dim), v_axes


class PreconditionVanka:
    """Additive-Schwarz cell-patch preconditioner over the space-time slab,
    fast-diagonalisation apply: "grid" mode for separable levels, "cell"
    mode (per-cell dense eigenbasis) otherwise (self.mode).

    storage_dtype (e.g. torch.bfloat16) stores the down/up matrices at
    reduced precision; the per-step time-solve factors stay float32 for
    bf16 levels (bf16 per-step recurrences are not accurate enough).

    Multi-step slabs (n_steps > 1) with the block-bidiagonal rank-1 step
    coupling solve per position  x_s = G^{-1} r_s + x_{s-1}[last] c  with
    G = lam a + b (nt x nt) and c = G^{-1}(lam g + z): kernel K1."""

    def __init__(self, K_op: LaplaceMassOperator, M_op: LaplaceMassOperator,
                 Alpha, Beta, dtype=None, storage_dtype=None,
                 n_steps: int = 1, eigenbasis=None):
        """eigenbasis: cell_eigenbasis(K_op, M_op), when the caller holds
        it already (levels that share a mesh share it)."""
        self.K_op = K_op
        self.cells = K_op.cells
        self.k = K_op.degree
        self.dim = K_op.dim
        self.dtype = dtype or K_op.dtype
        self.device = K_op.device
        Alpha, Beta = np.asarray(Alpha), np.asarray(Beta)
        self.n_blocks = Alpha.shape[0]
        cells, k, dim = self.cells, self.k, self.dim

        # detect the block-bidiagonal rank-1 multi-step structure
        self.n_steps = 1
        if n_steps > 1 and self.n_blocks % n_steps == 0:
            nt = self.n_blocks // n_steps
            a_nt, b_nt = Alpha[:nt, :nt], Beta[:nt, :nt]
            g_nt = -Alpha[nt:2 * nt, nt - 1]
            z_nt = -Beta[nt:2 * nt, nt - 1]
            A_rec, B_rec = np.zeros_like(Alpha), np.zeros_like(Beta)
            for s in range(n_steps):
                sl = slice(s * nt, (s + 1) * nt)
                A_rec[sl, sl], B_rec[sl, sl] = a_nt, b_nt
                if s + 1 < n_steps:
                    nsl = slice((s + 1) * nt, (s + 2) * nt)
                    A_rec[nsl, s * nt + nt - 1] = -g_nt
                    B_rec[nsl, s * nt + nt - 1] = -z_nt
            if np.array_equal(A_rec, Alpha) and np.array_equal(B_rec, Beta):
                self.n_steps = n_steps

        self.mode = "grid" if separable(K_op, M_op) else "cell"
        self._idx = self._src = None    # the cell mode's index maps
        if self.mode == "cell":
            self._build_cell(eigenbasis or cell_eigenbasis(K_op, M_op),
                             Alpha, Beta, storage_dtype)
            return
        lam_np, v_axes = separable_eigenbasis(K_op, M_op)
        sdt = storage_dtype if storage_dtype is not None else self.dtype
        fdt = torch.float32 if self.dtype == torch.bfloat16 else self.dtype
        as_t = lambda a, dt: torch.as_tensor(a, dtype=dt, device=self.device)
        self.Wdn, self.Wup = [], []
        for d in range(dim):
            nc = int(cells[d])
            nd = nc * k + 1
            v1 = np.ones(nd)
            v1[k:nd - 1:k] = 2.0            # 1D dof valence
            Vd = np.asarray(v_axes[d])
            dn = np.zeros((nc * (k + 1), nd))
            up = np.zeros((nd, nc * (k + 1)))
            for c in range(nc):
                rows = slice(c * (k + 1), (c + 1) * (k + 1))
                colsg = slice(c * k, c * k + k + 1)
                dn[rows, colsg] = Vd[c].T / v1[colsg][None, :]
                up[colsg, rows] += Vd[c]
            self.Wdn.append(as_t(dn, sdt))
            self.Wup.append(as_t(up, sdt))
        self.check_blocks()
        # eigenvalues in the flat interleaved (c1,a1,c2,a2,...) order of
        # the down-applied grid
        perm = []
        for d in range(dim):
            perm += [d, dim + d]
        lam_grid = lam_np.reshape(tuple(int(c) for c in cells)
                                  + (k + 1,) * dim)
        lam = as_t(np.transpose(lam_grid, perm).reshape(-1), fdt)
        self.GinvT = self.cvecT = self.TTg = None
        if self.n_steps > 1:
            a_, b_ = as_t(a_nt, fdt), as_t(b_nt, fdt)
            g_, z_ = as_t(g_nt, fdt), as_t(z_nt, fdt)
            Ginv = torch.linalg.inv(lam[:, None, None] * a_ + b_)
            gz = lam[:, None] * g_ + z_
            cvec = torch.einsum("nij,nj->ni", Ginv, gz)
            self.GinvT = Ginv.permute(1, 2, 0).contiguous()  # (nt, nt, N)
            self.cvecT = cvec.T.contiguous()                  # (nt, N)
        else:
            A_ = as_t(Alpha, self.dtype).to(fdt)
            B_ = as_t(Beta, self.dtype).to(fdt)
            self.TTg = torch.linalg.inv(lam[:, None, None] * A_ + B_
                                        ).permute(1, 2, 0).contiguous()

    def shard(self, cell_ranges) -> "PreconditionVanka":
        """This Vanka restricted to the cells [lo, hi) of each axis
        (cell_ranges, one pair per axis): a grid-mode copy whose matrices
        and time factors are the global ones' slices (module docstring);
        its vmult leaves partial sums on the slab's end planes.  Raises
        ValueError in cell mode, whose valence and masks are the level's
        own."""
        if self.mode != "grid":
            raise ValueError("a sharded level needs the grid-mode Vanka; "
                             "cell mode (a coefficient, cell mask or "
                             "distorted geometry) is not split")
        k, dim = self.k, self.dim
        out = copy.copy(self)
        out.cells = tuple(hi - lo for lo, hi in cell_ranges)
        out.Wdn = [self.Wdn[d][lo * (k + 1):hi * (k + 1),
                               lo * k:hi * k + 1].contiguous()
                   for d, (lo, hi) in enumerate(cell_ranges)]
        out.Wup = [self.Wup[d][lo * k:hi * k + 1,
                               lo * (k + 1):hi * (k + 1)].contiguous()
                   for d, (lo, hi) in enumerate(cell_ranges)]
        out.check_blocks()
        # the eigen-positions in the interleaved (c1, a1, c2, a2, ..) order
        grid = []
        for d in range(dim):
            grid += [int(self.cells[d]), k + 1]
        index = tuple(slice(lo, hi) for lo, hi in cell_ranges)
        sel = sum(((sl, slice(None)) for sl in index), ())

        def positions(t):
            if t is None:
                return None
            lead = t.shape[:-1]
            return t.reshape(lead + tuple(grid))[(Ellipsis,) + sel] \
                .reshape(lead + (-1,)).contiguous()

        out.GinvT, out.cvecT, out.TTg = (positions(t) for t in
                                         (self.GinvT, self.cvecT, self.TTg))
        return out

    def check_blocks(self) -> None:
        """The cell-blocked pattern of Wdn / Wup that K4 relies on (cell c
        of axis d maps dofs c k .. c k + k to rows c (k+1) ..), checked once
        per matrix; raises ValueError."""
        check_cell_blocks(self.Wdn, self.cells, self.k)
        check_cell_blocks(self.Wup, self.cells, self.k, up=True)

    def _build_cell(self, eigenbasis, Alpha, Beta, storage_dtype):
        """The cell-local factors: V (C, A, A), the valence scaling dinv
        (n_blocks, C, A) in t-major order, and the per-position time
        factors on the flat N = C A axis -- GinvT (nt, nt, N) and cvecT
        (nt, N) for multi-step slabs (K1's layout), else the dense
        per-position inverse TTg (T, T, N)."""
        cells, k = self.cells, self.k
        f64, nb = torch.float64, self.n_blocks
        lam, V = eigenbasis
        C, A = V.shape[0], V.shape[1]
        val = torch.as_tensor(dof_valence(cells, k), dtype=f64)
        vloc = cell_gather(val, cells, k).reshape(C, A)
        sdt = storage_dtype if storage_dtype is not None else self.dtype
        fdt = torch.float32 if self.dtype == torch.bfloat16 else self.dtype
        dev = self.device
        self.V = V.to(device=dev, dtype=sdt).contiguous()
        self.dinv = (1.0 / vloc)[None].expand(nb, C, A).to(
            device=dev, dtype=sdt).contiguous()
        as_64 = lambda a: torch.as_tensor(np.asarray(a), dtype=f64)
        lam_f = lam.reshape(-1)                                # (N,)
        self.GinvT = self.cvecT = self.TTg = None
        if self.n_steps > 1:
            nt = nb // self.n_steps
            a_, b_ = as_64(Alpha[:nt, :nt]), as_64(Beta[:nt, :nt])
            g_, z_ = -as_64(Alpha[nt:2 * nt, nt - 1]), \
                -as_64(Beta[nt:2 * nt, nt - 1])
            Ginv = torch.linalg.inv(lam_f[:, None, None] * a_ + b_)
            cvec = torch.einsum("nij,nj->ni", Ginv,
                                lam_f[:, None] * g_ + z_)
            self.GinvT = Ginv.permute(1, 2, 0).to(device=dev, dtype=fdt
                                                  ).contiguous()
            self.cvecT = cvec.T.to(device=dev, dtype=fdt).contiguous()
        else:
            TT = torch.linalg.inv(lam_f[:, None, None] * as_64(Alpha)
                                  + as_64(Beta))
            self.TTg = TT.permute(1, 2, 0).to(device=dev, dtype=fdt
                                              ).contiguous()

    def _vmult_cell(self, src: torch.Tensor) -> torch.Tensor:
        nb = src.shape[0]
        C, A = self.V.shape[0], self.V.shape[1]
        if self._idx is None:           # one index_select each way
            ix = lambda a: torch.as_tensor(a.reshape(-1), device=self.device)
            self._idx = ix(cell_dof_indices(self.cells, self.k))
            self._src = ix(overlap_sources(self.cells, self.k))
        r = src.to(self.dtype).reshape(nb, -1).index_select(
            -1, self._idx).reshape(nb, C, A)
        V, r = promote(self.V, r * self.dinv)
        w = torch.einsum("caq,tca->tcq", V, r).reshape(nb, C * A)
        if self.n_steps > 1:
            S = self.n_steps
            w = time_solve(w.contiguous(), self.GinvT, self.cvecT, S,
                           nb // S, w.dtype)
        else:
            TTg, w = promote(self.TTg, w)
            w = torch.einsum("tsn,sn->tn", TTg, w)
        V, w = promote(self.V, w.reshape(nb, C, A))
        y = torch.einsum("caq,tcq->tca", V, w).to(self.dtype)
        return overlap_add(y.reshape(nb, C * A), self._src,
                           self.dim).reshape(src.shape)

    def vmult(self, src: torch.Tensor) -> torch.Tensor:
        """src: [n_blocks, *dofshape] residual -> additive patch updates."""
        if self.mode == "cell":
            return self._vmult_cell(src)
        nb = src.shape[0]
        w = chain_down(src.to(self.dtype), self.Wdn, cells=self.cells,
                       k=self.k)
        gshape = w.shape[1:]
        N = int(np.prod(gshape))
        wf = w.reshape(nb, N)
        if self.n_steps > 1:
            S = self.n_steps
            w = time_solve(wf, self.GinvT, self.cvecT, S, nb // S, wf.dtype)
        else:
            TTg, wf = promote(self.TTg, wf)
            w = torch.einsum("tsn,sn->tn", TTg, wf)
        # back to the working dtype before the up chain
        w = w.reshape((nb,) + tuple(gshape)).to(self.dtype)
        return chain_up(w, self.Wup, cells=self.cells, k=self.k)

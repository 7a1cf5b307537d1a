"""Stokes-specific STMG level components (counterpart of
stfem_tpu/stmg/stokes_level.py): block Vanka over (u, p) cell patches and
the flat-layout space transfer.

Reference: the block PreconditionVanka (stmg.h:649-743) with M_mask =
velocity-only, and MGTwoLevelBlockTransfer applied per variable
(stmg.h:38-247); everything acts on the flat [T, n_u + n_p] Stokes
vectors.  The time transfer needs no Stokes form: transfers.TimeTransfer
mixes the leading time axis of the flat vector as it is.  The DGP-pressure
case with strong, Nitsche or free faces is ported, on uniform, masked,
non-uniform and mapped meshes (per-cell element matrices there; a removed
cell's pressure modes have zero rows, which the patch inverse regularizes
to the identity), with the strong or the weak obstacle; FE_Q pressure is
not.
"""
from __future__ import annotations

import numpy as np
import torch

from ..blocks import BlockSlice
from ..mesh.fe_dgp import dgp_child_embedding, dgp_p_embedding
from ..ops.spatial import (LaplaceMassOperator, cell_gather, layer_sum,
                           overlap_add)
from ..ops.stokes import StokesOperator
from ..utils.assembly import (band_columns, band_indices, dof_valence,
                              layer_sources, overlap_sources)
from .transfers import SpaceTransfer


def _band_flat(op: LaplaceMassOperator,
               extra_E: torch.Tensor | None = None):
    """Flattened banded assembled matrix band[*dofshape, (2k+1)^dim] =
    A[g, g + offset], unit diagonal on constrained dofs
    (stfem_tpu/stmg/vanka.py::_band_flat; index it with band_indices to
    extract patches).  extra_E: per-cell additions (C, A, A), the Nitsche
    face terms of the boundary-layer cells.  Owner-computes: each offset's
    column gathers every cell's entry of that offset into a cell-local
    array, and each dof adds its (at most 2^dim) cells' entries one after
    the other in cell order, as a sequential scatter-add would, a chunk of
    offsets at a time."""
    k, dim, cells = op.degree, op.dim, op.cells
    E = op.element_matrices()        # (C, A, A), constrained rows/cols 0
    if extra_E is not None:
        E = E + extra_E
    C, A = E.shape[0], E.shape[1]
    n_off = (2 * k + 1) ** dim
    dev = op.device
    sel = torch.as_tensor(band_columns(k, dim), device=dev)   # (A, n_off)
    src = torch.as_tensor(overlap_sources(cells, k).reshape(-1), device=dev)
    Epad = torch.nn.functional.pad(E, (0, 1))                 # b = A: zero
    rows = torch.arange(A, device=dev)[:, None]
    band = torch.empty((int(np.prod(op.dof_shape)), n_off), dtype=op.dtype,
                       device=dev)
    step = max(1, 2 ** 25 // (C * A))
    for o in range(0, n_off, step):
        loc = Epad[:, rows, sel[:, o:o + step]]          # (C, A, chunk)
        loc = torch.nn.functional.pad(
            loc.permute(2, 0, 1).reshape(-1, C * A), (0, 1))
        g = loc.index_select(-1, src).reshape(loc.shape[0], -1, 2 ** dim)
        acc = g[..., 0]
        for i in range(1, 2 ** dim):       # the sources in cell order
            acc = acc + g[..., i]
        band[:, o:o + step] = acc.T
    band = band.reshape(op.dof_shape + (n_off,))
    band[..., (n_off - 1) // 2] += 1.0 - op.mask
    return band.reshape(-1)


def patch_face_terms(S: StokesOperator, dtype):
    """The Nitsche face and weak-obstacle terms of the Vanka patches
    (stfem_tpu stokes_level.py:100-150), on each face cell's element
    matrices: (face_uu, E_up, E_pu, off).  face_uu: per component the
    [C, A, A] u-u terms (the normal component has the extra gamma2
    penalty), or None without faces, for the banded assembly, so that every
    patch that shares a face dof sees the same rows; E_up [C, dim A, m]
    and E_pu [C, m, dim A]: the element couplings plus the faces'; off:
    (cells, [n, dim, A, dim, A]) the obstacle's cross-component gamma2
    n_c n_e blocks, cell-local, or None.  A cell's terms are summed over
    the layers and obstacle faces it lies in by an owner-computes sum
    (utils/assembly.py::layer_sources), not by a scatter-add."""
    dim, C, dev = S.dim, int(np.prod(S.cells)), S.device
    A = (S.u_degree + 1) ** dim
    _, E_up, E_pu = S.element_matrices()
    E_up, E_pu = E_up.to(dtype), E_pu.to(dtype)
    faces = S.face_element_matrices()
    obstacle = S.obstacle_cell_terms()
    if not faces and obstacle is None:
        return None, E_up, E_pu, None
    cell_grid = np.arange(C).reshape(S.cells)
    layers = [cell_grid[S._plane(d0, side)] for d0, side, *_ in faces]
    parts_uu = [[f[2][c] for f in faces] for c in range(dim)]
    parts_up = [f[3] for f in faces]
    parts_pu = [f[4] for f in faces]
    off = None
    if obstacle is not None:
        oc, Ob_uu, Ob_up = obstacle
        layers.append(oc.cpu().numpy())
        for c in range(dim):
            parts_uu[c].append(Ob_uu[:, c, c])
        Ob_up = Ob_up.reshape(len(oc), dim * A, -1)
        parts_up.append(Ob_up)
        parts_pu.append(-Ob_up.transpose(1, 2))
        eye = torch.eye(dim, dtype=torch.bool, device=dev)[:, :, None, None]
        off = (oc, torch.where(eye, 0.0, Ob_uu).permute(0, 1, 3, 2, 4).to(
            dtype))
    fc, table = layer_sources(layers)
    fc = torch.as_tensor(fc, device=dev)
    table = torch.as_tensor(table, device=dev)

    def on_layers(base, parts):
        """base plus the per-layer parts summed over the layers."""
        out = base.clone()
        out[fc] = out[fc] + layer_sum([p.to(dtype) for p in parts], table)
        return out

    zero = torch.zeros((C, A, A), dtype=dtype, device=dev)
    return ([on_layers(zero, parts_uu[c]) for c in range(dim)],
            on_layers(E_up, parts_up), on_layers(E_pu, parts_pu), off)


class StokesVanka:
    """Cell-patch Vanka for the space-time Stokes slab.

    Patch rows ordered by block index (variable-major BlockSlice: timestep,
    [u, p], timedof) with per-block spatial dofs = all cell u-dofs
    (component-major) or all cell p-modes.  B = Alpha_st (x) K_blocks +
    Beta_st (x) M_uu, valence-row-scaled, inverted batched at setup.

    When the slab tables are block-bidiagonal with identical per-step
    blocks (the DG/CGP multi-step assembly, fe_time.h:381-402) the patch
    solve factorizes into per-step inverses Binv [C, P1, P1] and the
    sequential recurrence y_s = Binv r_s - Kappa y_{s-1},
    Kappa = Binv Bcoup; otherwise one dense inverse per patch.  The patch
    gather and scatter are one precomputed index gather each way."""

    def __init__(self, stokes_op: StokesOperator,
                 mass_op: LaplaceMassOperator, Alpha_st, Beta_st,
                 blk: BlockSlice, dtype=None):
        S = stokes_op
        self.S, self.blk = S, blk
        self.dtype = dtype = dtype or S.dtype
        dev = S.device
        dim, k, cells = S.dim, S.u_degree, S.cells
        C = int(np.prod(cells))
        A_s = (k + 1) ** dim
        A_u = dim * A_s
        n_pl = S.n_ploc_cell
        n_blocks = blk.n_blocks
        Alpha_st, Beta_st = np.asarray(Alpha_st), np.asarray(Beta_st)

        lap = LaplaceMassOperator(S.mesh, k, S.n_q, 0.0, S.viscosity,
                                  dtype=dtype, device=dev, mask=S.mask_u_np)
        mass = LaplaceMassOperator(S.mesh, k, S.n_q, 1.0, 0.0, dtype=dtype,
                                   device=dev, mask=S.mask_u_np)
        fidx = torch.as_tensor(band_indices(cells, k), device=dev)

        sizes = [A_u if blk.decompose(i)[1] == 0 else n_pl
                 for i in range(n_blocks)]
        offs = np.concatenate([[0], np.cumsum(sizes)]).astype(int)

        # multi-step structure: identical diagonal step blocks, one-step
        # coupling, nothing else
        self.n_steps = 1
        nb_step = blk.n_variables * blk.n_timedofs
        n_steps = blk.n_timesteps_at_once
        s0, s1 = slice(0, nb_step), slice(nb_step, 2 * nb_step)
        if n_steps > 1 and n_blocks == n_steps * nb_step:
            A0s, B0s = Alpha_st[s0, s0], Beta_st[s0, s0]
            Acs, Bcs = Alpha_st[s1, s0], Beta_st[s1, s0]
            ok = True
            for s in range(n_steps):
                ss = slice(s * nb_step, (s + 1) * nb_step)
                ok &= np.array_equal(Alpha_st[ss, ss], A0s)
                ok &= np.array_equal(Beta_st[ss, ss], B0s)
                if s:
                    sp = slice((s - 1) * nb_step, s * nb_step)
                    ok &= np.array_equal(Alpha_st[ss, sp], Acs)
                    ok &= np.array_equal(Beta_st[ss, sp], Bcs)
                for t in range(n_steps):
                    if abs(s - t) > 1 or t > s:
                        tt = slice(t * nb_step, (t + 1) * nb_step)
                        ok &= not (np.any(Alpha_st[ss, tt])
                                   or np.any(Beta_st[ss, tt]))
                if not ok:
                    break
            if ok:
                self.n_steps = n_steps

        face_uu, E_up, E_pu, Kuu_off = patch_face_terms(S, dtype)
        Muu_s = _band_flat(mass)[fidx]
        # block-diagonal over the components, rows/cols component-major
        Kuu = torch.zeros((C, dim, A_s, dim, A_s), dtype=dtype, device=dev)
        Muu = torch.zeros_like(Kuu)
        Kuu_s = None if face_uu is not None else _band_flat(lap)[fidx]
        for c in range(dim):
            Kuu[:, c, :, c, :] = (Kuu_s if Kuu_s is not None else
                                  _band_flat(lap, face_uu[c])[fidx])
            Muu[:, c, :, c, :] = Muu_s
        if Kuu_off is not None:
            oc, off = Kuu_off              # each obstacle cell once
            Kuu[oc] = Kuu[oc] + off
        Kuu, Muu = Kuu.reshape(C, A_u, A_u), Muu.reshape(C, A_u, A_u)

        def assemble(A_tab, B_tab, nb):
            """B_sub [C, P, P] over the first nb blocks (tables indexed
            locally)."""
            P = int(offs[nb])
            Bm = torch.zeros((C, P, P), dtype=dtype, device=dev)
            for i in range(nb):
                iv = blk.decompose(i)[1]
                for j in range(nb):
                    jv = blk.decompose(j)[1]
                    a, b = float(A_tab[i, j]), float(B_tab[i, j])
                    if a == 0.0 and b == 0.0:
                        continue
                    if iv == 0 and jv == 0:
                        sub = a * Kuu + b * Muu
                    elif iv == 0 and jv == 1:
                        sub = a * E_up
                    elif iv == 1 and jv == 0:
                        sub = a * E_pu
                    else:
                        continue              # p-p: no coupling
                    Bm[:, offs[i]:offs[i + 1], offs[j]:offs[j + 1]] += sub
            return Bm

        # valence row scaling (u rows: spatial multiplicity; p rows: 1 for
        # the cell-local DGP modes)
        val = torch.as_tensor(dof_valence(cells, k), dtype=dtype, device=dev)
        vl = cell_gather(val, cells, k).reshape(C, A_s)
        vl_u = torch.cat([vl] * dim, dim=1)
        vl_p = torch.ones((C, n_pl), dtype=dtype, device=dev)

        def vrows(nb):
            return torch.cat([vl_u if blk.decompose(i)[1] == 0 else vl_p
                              for i in range(nb)], dim=1)[:, :, None]

        def invert(B):
            # regularize fully decoupled rows (degenerate coarse levels)
            zero_rows = (torch.amax(torch.abs(B), dim=2) == 0.0).to(dtype)
            return torch.linalg.inv(B + torch.diag_embed(zero_rows))

        if self.n_steps > 1:
            B1 = assemble(A0s, B0s, nb_step) * vrows(nb_step)
            Bc = assemble(Acs, Bcs, nb_step) * vrows(nb_step)
            self.Binv = invert(B1)
            Kappa = self.Binv @ Bc
            # rows regularized to identity in B1 keep no step coupling
            zrows = torch.amax(torch.abs(B1), dim=2) == 0.0
            self.Kappa = torch.where(zrows[:, :, None],
                                     torch.zeros((), dtype=dtype,
                                                 device=dev), Kappa)
        else:
            B = assemble(Alpha_st, Beta_st, n_blocks) * vrows(n_blocks)
            self.Binv, self.Kappa = invert(B), None
        if S.weak_obstacle:
            # the removed cells' patches must not update the (free)
            # obstacle-boundary dofs: their rows are degenerate (zero
            # volume) and the regularized inverses would inject noise
            act = torch.as_tensor(S.mesh.cell_mask.reshape(-1), dtype=dtype,
                                  device=dev)[:, None, None]
            self.Binv = self.Binv * act
            if self.Kappa is not None:
                self.Kappa = self.Kappa * act

        # patch order <-> the per-cell [time position, (u comps, p)] layout
        nt = blk.n_timedofs
        W = A_u + n_pl
        idx = []
        for i in range(n_blocks):
            it, iv, idof = blk.decompose(i)
            base = (it * nt + idof) * W
            idx.append(base + (np.arange(A_u) if iv == 0
                               else A_u + np.arange(n_pl)))
        gather = np.concatenate(idx)
        T = n_steps * nt
        assert np.array_equal(np.sort(gather), np.arange(T * W)), \
            "the patch blocks must cover every (time position, variable)"
        # one gather from the flat [T, n_u + n_p] residual straight into
        # the patch order, and the overlap-add back as a gather of each
        # entry's contributions (bitwise cell_scatter's sums)
        n = S.n_u + S.n_p
        lidx, src = S.local_maps()
        t_of, w_of = np.divmod(gather, W)
        self._pidx = torch.as_tensor(
            (t_of[None, :] * n + lidx[:, w_of]).reshape(-1), device=dev)
        pos = np.argsort(gather)                # (t, w) -> patch position
        cell, w = np.divmod(src, W)
        none = src == C * W
        self._src = torch.as_tensor(np.stack([
            np.where(none, C * T * W, cell * T * W + pos[t * W + w])
            for t in range(T)]).reshape(-1), device=dev)
        self._T, self._n = T, n

    def vmult(self, x: torch.Tensor) -> torch.Tensor:
        """x: flat [T, n_u + n_p] residual -> additive patch updates."""
        C = self.Binv.shape[0]
        r = x.to(self.dtype).reshape(-1).index_select(0, self._pidx).reshape(
            C, -1)
        if self.n_steps > 1:
            n_s = self.n_steps
            y0 = torch.matmul(r.reshape(C, n_s, -1),
                              self.Binv.transpose(1, 2))    # [C, S, P1]
            ys = [y0[:, 0]]
            for s in range(1, n_s):
                ys.append(torch.baddbmm(y0[:, s, :, None], self.Kappa,
                                        ys[-1][:, :, None], alpha=-1.0)[..., 0])
            y = torch.stack(ys, dim=1).reshape(-1)
        else:
            y = torch.bmm(self.Binv, r[:, :, None]).reshape(-1)
        return overlap_add(y, self._src, self.S.dim).reshape(self._T,
                                                              self._n)


class StokesSpaceTransfer:
    """h- or p-transfer on the flat Stokes layout: separable 1D transfer on
    each velocity component + exact DGP embedding for the pressure."""

    def __init__(self, S_fine: StokesOperator, S_coarse: StokesOperator,
                 u_transfer: SpaceTransfer, mg_type: str, dtype):
        self.Sf, self.Sc = S_fine, S_coarse
        self.u_transfer = u_transfer
        self.mg_type = mg_type            # 'h' or 'p'
        dim, dev = S_fine.dim, S_fine.device
        if mg_type == "h":
            assert S_fine.p_degree == S_coarse.p_degree
            self.Ech = torch.as_tensor(dgp_child_embedding(
                dim, S_fine.p_degree), dtype=dtype, device=dev)
        else:
            self.Pp = torch.as_tensor(dgp_p_embedding(
                dim, S_coarse.p_degree, S_fine.p_degree), dtype=dtype,
                device=dev)

    def _children(self, x):
        """[T, *fine cells, m] <-> [T, *coarse cells, 2, .., 2, m] views:
        fine cell 2 c + b is child b of coarse cell c."""
        dim = self.Sf.dim
        T, m = x.shape[0], x.shape[-1]
        shape = [T]
        for c in self.Sc.cells:
            shape += [c, 2]
        x = x.reshape(shape + [m])
        perm = ([0] + [1 + 2 * d for d in range(dim)]
                + [2 + 2 * d for d in range(dim)] + [1 + 2 * dim])
        return x.permute(perm)           # [T, *ccells, *bits, m]

    def _bits(self):
        """Ech as E[b_0, .., b_dim-1, f, m] and the einsum letters of the
        child bits."""
        dim = self.Sf.dim
        return (self.Ech.reshape((2,) * dim + self.Ech.shape[1:]),
                "abcdefg"[:dim])

    def _p_prolongate(self, pc):
        if self.mg_type == "p":
            return torch.einsum("fm,...m->...f", self.Pp, pc)
        dim = self.Sf.dim
        E, b = self._bits()
        vals = torch.einsum(f"{b}FM,T...M->T...{b}F", E, pc)
        T, m = pc.shape[0], vals.shape[-1]
        perm = [0]
        for d in range(dim):
            perm += [1 + d, 1 + dim + d]
        perm.append(1 + 2 * dim)
        return vals.permute(perm).reshape((T,) + self.Sf.cells + (m,))

    def _p_restrict(self, pf):
        if self.mg_type == "p":
            return torch.einsum("fm,...f->...m", self.Pp, pf)
        E, b = self._bits()
        return torch.einsum(f"{b}FM,T...{b}F->T...M", E, self._children(pf))

    def prolongate(self, xc: torch.Tensor) -> torch.Tensor:
        uc, pc = self.Sc.unpack(xc)
        return self.Sf.pack(self.u_transfer.prolongate(uc),
                            self._p_prolongate(pc))

    def restrict(self, xf: torch.Tensor) -> torch.Tensor:
        uf, pf = self.Sf.unpack(xf)
        return self.Sc.pack(self.u_transfer.restrict(uf),
                            self._p_restrict(pf))


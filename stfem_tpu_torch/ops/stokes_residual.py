"""FP64 residual engine for the Stokes saddle operator (counterpart of
stfem_tpu/ops/ff_stokes.py: KronStokesFF and build_ff_stokes_residual,
which compute the same in float-float because the TPU has no FP64).

On a uniform axis-aligned mesh the whole saddle operator factorizes into
Kronecker products of small banded 1D matrices:
  * velocity vector Laplacian / mass: the scalar per-axis assembled
    factors (ops/kronfac.py::KronAssembled), batched over the component
    axis -- K x and M x together through kernel K2, M x alone through
    kernel K3;
  * B (divergence) and B^T (pressure gradient): each modal DGP pressure
    mode P_{m1}(x)P_{m2}(y)P_{m3}(z) is itself a tensor product, so the
    (q, div u) pairing factorizes per mode into rectangular banded 1D
    factors between the u dof grid (nc k + 1) and the cell grid (nc):
        V[d][i, m, a] = h_i sum_q w_q P_m(x_q) phi_a(x_q)
        G[d][i, m, a] =     sum_q w_q P_m(x_q) phi_a'(x_q)
    assembled with the same 1D quadrature as the volume operator.  They
    run as plain torch FP64 on strided views (stfem_tpu runs them as XLA
    elementwise code, outside any Pallas kernel).

KronStokes64 plugs into SlabResidual64 (kron/mask injection): the "K path"
is the full saddle apply [nu K u - B^T p; B u], the "M path" is [M u; 0],
and the scalar DG/CGP time tables mix them as
SystemMatrixStokes::tensorproduct_eval does (operators.h:819-867).
"""
from __future__ import annotations

import numpy as np
import torch

from ..mesh.fe import shape_data_1d
from ..mesh.fe_dgp import dgp_exponents, shifted_legendre_value
from .kronfac import KronAssembled
from .slab_residual import SlabResidual64
from .spatial import LaplaceMassOperator

__all__ = ["KronStokes64", "build_stokes_residual64"]


def _axis_slice(ndim: int, axis: int, sl: slice):
    idx = [slice(None)] * ndim
    idx[axis] = sl
    return tuple(idx)


class KronStokes64:
    """FP64 saddle-operator pair on the flat [..., n_u + n_p] layout:
    pair(x) -> (S x, Mtilde x) with S x = [nu K u - B^T p; B u] and
    Mtilde x = [M u; 0]."""

    def __init__(self, S64):
        mesh = S64.mesh
        self.dim, self.k = S64.dim, S64.u_degree
        self.p_degree, self.device = S64.p_degree, S64.device
        self.dof_shape_u = tuple(S64.dof_shape_u)
        self.cells = tuple(int(c) for c in S64.cells)
        self.n_ploc, self.n_u, self.n_p = S64.n_ploc, S64.n_u, S64.n_p
        self.exps = dgp_exponents(self.dim, self.p_degree)
        f64 = torch.float64
        K64 = LaplaceMassOperator(mesh, self.k, S64.n_q, 0.0, 1.0,
                                  dtype=f64, device=self.device)
        M64 = LaplaceMassOperator(mesh, self.k, S64.n_q, 1.0, 0.0,
                                  dtype=f64, device=self.device)
        self.base = KronAssembled(K64, M64, f64)
        if S64.viscosity != 1.0:        # fold nu into the stiffness factors
            nu = S64.viscosity
            self.base.A1 = [nu * A for A in self.base.A1]
            self.base.Ad = [nu * A for A in self.base.Ad]
        # B factors per axis: V (value pairing, carries h) and G
        # (derivative pairing, h cancels), [nc, kp+1, k+1]
        sd = shape_data_1d(self.k, S64.n_q)
        qx, qw = np.asarray(sd.quad_x), np.asarray(sd.quad_w)
        Pm = np.stack([shifted_legendre_value(m, qx)
                       for m in range(self.p_degree + 1)])
        Vq = np.einsum("q,mq,qa->ma", qw, Pm, np.asarray(sd.S))
        Gq = np.einsum("q,mq,qa->ma", qw, Pm, np.asarray(sd.D))
        as_t = lambda a: torch.as_tensor(a, dtype=f64, device=self.device)
        self.Vf, self.Gf = [], []
        for d in range(self.dim):
            h = np.diff(np.asarray(mesh.axis_vertices(d), np.float64))
            self.Vf.append(as_t(h[:, None, None] * Vq[None]))
            self.Gf.append(as_t(np.broadcast_to(Gq[None], (len(h),)
                                                + Gq.shape).copy()))

    def _b_axis(self, F, x, axis):
        """u grid -> cell grid along `axis`: y_i = sum_a F[i, a] x_{ik+a}
        (F: [nc, k+1], one mode's factor)."""
        k, nc = self.k, F.shape[0]
        shape = [1] * x.ndim
        shape[axis] = nc
        out = None
        for a in range(k + 1):
            t = F[:, a].reshape(shape) * x[_axis_slice(
                x.ndim, axis, slice(a, a + (nc - 1) * k + 1, k))]
            out = t if out is None else out + t
        return out

    def _bt_axis(self, F, x, axis, nd):
        """cell grid -> u grid along `axis`: y_{ik+a} += F[i, a] x_i, added
        in place into strided views of one output."""
        k, nc = self.k, F.shape[0]
        shape = [1] * x.ndim
        shape[axis] = nc
        tshape = list(x.shape)
        tshape[axis] = nd
        out = torch.zeros(tshape, dtype=x.dtype, device=x.device)
        for a in range(k + 1):
            out[_axis_slice(x.ndim, axis, slice(
                a, a + (nc - 1) * k + 1, k))] += F[:, a].reshape(shape) * x
        return out

    def pair(self, x: torch.Tensor, need_K: bool = True,
             need_M: bool = True):
        dim, grid = self.dim, self.dof_shape_u
        lead = x.shape[:-1]
        nlead = len(lead)
        u = x[..., :self.n_u].reshape(lead + (dim,) + grid)
        Ku, Mu = self.base.pair(u, need_K=need_K, need_M=need_M)
        Mout = None
        if need_M:
            Mout = torch.cat([Mu.reshape(lead + (self.n_u,)),
                              torch.zeros(lead + (self.n_p,), dtype=x.dtype,
                                          device=x.device)], dim=-1)
        if not need_K:
            return None, Mout
        p = x[..., self.n_u:].reshape(lead + self.cells + (self.n_ploc,))
        # B u (p rows) and B^T p (u rows), mode by mode
        rp_modes, bt = [], [None] * dim
        for m, e in enumerate(self.exps):
            pm = p[..., m]
            acc = None
            for c in range(dim):
                val, tval = u.select(nlead, c), pm
                for d in range(dim):
                    F = (self.Gf[d] if d == c else self.Vf[d])[:, e[d], :]
                    val = self._b_axis(F, val, nlead + d)
                    tval = self._bt_axis(F, tval, nlead + d, grid[d])
                acc = val if acc is None else acc + val
                bt[c] = tval if bt[c] is None else bt[c] + tval
            rp_modes.append(acc)
        rp = torch.stack(rp_modes, dim=-1)
        ru = Ku - torch.stack(bt, dim=nlead)
        Kout = torch.cat([ru.reshape(lead + (self.n_u,)),
                          rp.reshape(lead + (self.n_p,))], dim=-1)
        return Kout, Mout


def build_stokes_residual64(S64, a, b, zeta=None, gamma=None):
    """SlabResidual64 over the Stokes saddle operator
    (stfem_tpu/ops/ff_stokes.py::build_ff_stokes_residual).  a/b: the
    scalar multi-step time tables (the arrays StokesSystemMatrix mixes
    with); zeta: the previous-step M-coupling column (DG jump / CGP Zeta);
    gamma: the previous-step saddle coupling column (CGP only)."""
    kron = KronStokes64(S64)
    mask_u = np.broadcast_to(np.asarray(S64.mask_u_np)[None],
                             (S64.dim,) + tuple(S64.dof_shape_u)).reshape(-1)
    mask = np.concatenate([mask_u, np.ones(S64.n_p)])
    zcol = (np.zeros((np.asarray(a).shape[0], 1)) if zeta is None
            else np.asarray(zeta, np.float64))
    return SlabResidual64(kron, mask, a, b, zcol, Gamma_K=gamma)

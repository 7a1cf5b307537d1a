"""Per-axis dense contraction and the gather-free grid sum-factorization
operator route (counterpart of stfem_tpu/ops/gridsumfac.py).

`axis_apply` serves the level operators' Kronecker pair, the transfers
and the plain version of kernel K4.  `GridSumFac` is the slab operator's
route for diagonal-geometry meshes whose Kronecker factorization a
coefficient field breaks: on a tensor grid the cell-local Gauss points are
disjoint, so dof -> quadrature interpolation along one axis is a global
banded (nc q x nc k + 1) matrix, and its transpose performs the
overlap-add.  The quadrature weights (jxw, coefficient, inverse-Jacobian
squares) live on the full interleaved quadrature grid.  These are plain
large matrix products, left to torch as stfem_tpu leaves them to XLA.
stfem_tpu's fused K4 branch of GridSumFac needs rank-1 separable weight
grids, which a coefficient breaks, and is not ported.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["GridSumFac", "axis_apply", "promote"]


def promote(*ts):
    """Cast tensors to their common dtype (jnp's implicit promotion:
    e.g. bf16 factors against an f32 vector compute in f32)."""
    dt = ts[0].dtype
    for t in ts[1:]:
        dt = torch.promote_types(dt, t.dtype)
    return tuple(t if t.dtype == dt else t.to(dt) for t in ts)


def axis_apply(M: torch.Tensor, x: torch.Tensor, axis: int):
    """Contract M (out, in) against x's `axis`, result axis in place."""
    M, x = promote(M, x)
    return torch.movedim(torch.tensordot(M, x, dims=([1], [axis])), 0, axis)


def _interleave(full: np.ndarray, cells, nq: int) -> np.ndarray:
    """[*cells, *q] -> quad-grid layout [(nc1*q), (nc2*q), ...]."""
    dim = len(cells)
    perm = []
    for d in range(dim):
        perm += [d, dim + d]
    a = np.transpose(full, perm)
    return a.reshape(tuple(int(cells[d]) * nq for d in range(dim)))


class GridSumFac:
    """Per-axis global quadrature matmuls + full quad-grid weights for
    (w_M u, v) + (w_K grad u, grad v) with the block mixing injected at
    the quadrature level (mix_a on the gradients, mix_b on the values)."""

    def __init__(self, K_op, M_op, dtype):
        dim, k, nq = K_op.dim, K_op.degree, K_op.n_q
        cells = tuple(int(c) for c in K_op.cells)
        S1, D1 = K_op._sd.S, K_op._sd.D          # (q, k+1) float64
        self.dim, self.k, self.nq, self.cells = dim, k, nq, cells
        dev = K_op.device
        as_t = lambda a: torch.as_tensor(np.ascontiguousarray(a),
                                         dtype=dtype, device=dev)
        self.Sg, self.Dg = [], []
        for d in range(dim):
            nc = cells[d]
            Sgd = np.zeros((nc * nq, nc * k + 1))
            Dgd = np.zeros((nc * nq, nc * k + 1))
            for c in range(nc):
                Sgd[c * nq:(c + 1) * nq, c * k:c * k + k + 1] = S1
                Dgd[c * nq:(c + 1) * nq, c * k:c * k + k + 1] = D1
            self.Sg.append(as_t(Sgd))
            self.Dg.append(as_t(Dgd))
        self.Wb = as_t(_interleave(M_op.weights_np(), cells, nq))
        wK = K_op.weights_np()
        jinv = 1.0 / K_op.mesh.h
        self.Wa = [as_t(_interleave(wK * jinv[e] ** 2, cells, nq))
                   for e in range(dim)]

    def apply(self, x, mix_a, mix_b, alpha_zero: bool, beta_zero: bool):
        """x: [..., *dofshape] -> same shape (None when both parts are
        zero); mix_a/mix_b map the leading block axis."""
        dim = self.dim
        lead = x.ndim - dim
        # forward with shared prefixes: after axis d, `val` holds
        # S_0..S_d u and grads[e <= d] the D_e variants
        val, grads = x, []
        for d in range(dim):
            axis = lead + d
            new_grads = [axis_apply(self.Sg[d], g, axis) for g in grads]
            if not alpha_zero:
                new_grads.append(axis_apply(self.Dg[d], val, axis))
            grads = new_grads
            if not beta_zero or d < dim - 1:
                val = axis_apply(self.Sg[d], val, axis)
        acc = None
        if not alpha_zero:
            for e in range(dim):
                t = mix_a(grads[e]) * self.Wa[e]
                for d in range(dim):
                    m = self.Dg[d] if d == e else self.Sg[d]
                    t = axis_apply(m.T, t, lead + d)
                acc = t if acc is None else acc + t
        if not beta_zero:
            v = mix_b(val) * self.Wb
            for d in range(dim):
                v = axis_apply(self.Sg[d].T, v, lead + d)
            acc = v if acc is None else acc + v
        return acc

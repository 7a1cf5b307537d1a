"""1D-assembled Kronecker-sum operator apply for tensor-product geometry
(counterpart of stfem_tpu/ops/kronfac.py::KronAssembled).

On an axis-aligned tensor mesh (uniform or with per-axis steps) without a
coefficient field, cell mask, map or distortion the global assembled
operators factorize exactly:
    M_glob = M_1 (x) ... (x) M_dim
    K_glob = sum_e  M_1 (x) ... (x) A_e (x) ... (x) M_dim
with 1D assembled mass/stiffness matrices M_d, A_d (bandwidth 2k+1) built
from the same 1D quadrature as the volume operator.  One (Kx, Mx) pair
costs 3*dim-1 per-axis applies with a shared mass prefix.

The float64 pair (the IR residual, the outer operator of the tp_01
cycle) uses the banded diagonal form, dispatched by shape: both outputs
of a 3D grid of degree k <= kron_pair.MAX_K (Q1-Q4) through kernel K2
(ops/kron_pair.py); everything else -- any single output (the rhs
couplings ask for M x alone), every 2D pair, and the 3D pairs of degree 5
(Q5, the top space degree of the reference's CGP sweeps) -- as a chain of
single-axis applies through kernel K3 (ops/banded_apply.py), the
structure of stfem_tpu's KronPallas9._pair_pallas.  The bfloat16/float32
pair (the level operators, the float32 outer operator) on CUDA takes
kernel K6 (ops/level_pair.py) for both outputs of a 3D grid of degree
k <= level_pair.MAX_K that the kernel takes (level_pair.supports); every
other low-precision pair, and every one on the CPU, uses the dense
per-axis matmuls.  This is a choice by shape, not a fallback: a failed
build or launch of any kernel raises.  The 1D factors are unconstrained:
Dirichlet masking stays external (y = mask * A (mask * x)).
"""
from __future__ import annotations

import numpy as np
import torch

from .banded_apply import banded_apply
from .gridsumfac import axis_apply
from .kron_pair import MAX_K as KRON_PAIR_MAX_K
from .kron_pair import kron_pair
from .level_pair import level_pair, supports as level_pair_supports
from .level_pair import tables as level_pair_tables

__all__ = ["KronAssembled", "to_diags"]


def to_diags(A: np.ndarray, k: int) -> np.ndarray:
    """(2k+1, nd) diagonal storage: D[o, i] = A[i, i+o-k] (0 off-range)."""
    nd = A.shape[0]
    D = np.zeros((2 * k + 1, nd))
    for o in range(-k, k + 1):
        lo, hi = max(0, -o), min(nd, nd - o)
        D[o + k, lo:hi] = A[np.arange(lo, hi), np.arange(lo, hi) + o]
    return D


def assemble_1d_dense(op1) -> np.ndarray:
    """Dense (nd, nd) assembled matrix of a 1D LaplaceMassOperator."""
    E = op1.element_matrices().cpu().numpy().astype(np.float64)
    k = op1.degree
    nc = E.shape[0]
    A = np.zeros((nc * k + 1, nc * k + 1))
    for c in range(nc):
        A[c * k:c * k + k + 1, c * k:c * k + k + 1] += E[c]
    return A


def axis_mesh(mesh, d: int):
    """The 1D mesh of axis d: uniform when the steps are equal, else with
    the axis' steps (stfem_tpu/ops/kronfac.py:130-138)."""
    from ..mesh.grid import StructuredMesh

    verts = mesh.axis_vertices(d)
    steps = np.diff(verts)
    if np.allclose(steps, steps[0]):
        return StructuredMesh([int(mesh.cells[d])], [float(verts[0])],
                              [float(verts[-1])], refinement=0)
    return StructuredMesh([len(steps)], [float(verts[0])], None,
                          refinement=0, axis_steps=[steps])


def one_d_operators(mesh, d: int, k: int, n_q: int):
    """The unconstrained f64 1D mass and stiffness operators of axis d."""
    from .spatial import LaplaceMassOperator

    mesh1 = axis_mesh(mesh, d)
    free = np.ones(int(mesh.cells[d]) * k + 1)
    M1 = LaplaceMassOperator(mesh1, k, n_q, 1.0, 0.0, dtype=torch.float64,
                             device="cpu", mask=free)
    A1 = LaplaceMassOperator(mesh1, k, n_q, 0.0, 1.0, dtype=torch.float64,
                             device="cpu", mask=free)
    return M1, A1


class KronAssembled:
    """Per-axis assembled factors + the shared-prefix pair apply."""

    @staticmethod
    def supports(K_op, M_op) -> bool:
        """True when the geometry separates (stfem_tpu/ops/kronfac.py:
        100-107): diagonal Jacobians, no coefficient field, no cell mask,
        no explicit (distorted or Q1-mapped) vertices."""
        mesh = K_op.mesh
        return (K_op.jinv is None and K_op.coeff is None
                and M_op.coeff is None and mesh.cell_mask is None
                and mesh.vertices is None)

    def __init__(self, K_op, M_op, dtype):
        assert self.supports(K_op, M_op)
        device = K_op.device
        k, dim, n_q = K_op.degree, K_op.dim, K_op.n_q
        self.dim, self.k = dim, k
        self.dtype, self.device = dtype, device
        self.M1, self.A1, self.Md, self.Ad = [], [], [], []
        for d in range(dim):
            M1op, A1op = one_d_operators(K_op.mesh, d, k, n_q)
            M1np, A1np = assemble_1d_dense(M1op), assemble_1d_dense(A1op)
            as_t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
            self.M1.append(as_t(M1np))
            self.A1.append(as_t(A1np))
            self.Md.append(as_t(to_diags(M1np, k)))
            self.Ad.append(as_t(to_diags(A1np, k)))
        # K6's stacked float32 tables, once (CUDA, 3D, bf16 / float32)
        self._level = None
        if (device.type == "cuda" and dtype in (torch.bfloat16, torch.float32)
                and level_pair_supports([m.shape[0] for m in self.M1], k)):
            self._level = level_pair_tables(self.Md, self.Ad, dtype)

    def pair(self, x: torch.Tensor, need_K: bool = True,
             need_M: bool = True):
        """x: [..., *dofshape] -> (K_glob x, M_glob x); a result that is not
        requested is None."""
        if self.dtype == torch.float64:
            x = x.contiguous()
            if (need_K and need_M and self.dim == 3
                    and self.k <= KRON_PAIR_MAX_K):
                return kron_pair(x, self.Md, self.Ad, self.k)
            apply = lambda D, v, ax: banded_apply(v, D, ax, self.k)
            Mf, Af = self.Md, self.Ad
        else:
            dt = torch.promote_types(self.dtype, x.dtype)
            if (need_K and need_M and self._level is not None and x.is_cuda
                    and dt in (torch.bfloat16, torch.float32)):
                return level_pair(x.to(dt).contiguous(), *self._level,
                                  self.k)
            apply = lambda D, v, ax: axis_apply(D, v, ax)
            Mf, Af = self.M1, self.A1
        lead = x.ndim - self.dim
        val, ks = x, None
        for d in range(self.dim):
            ax = lead + d
            if need_K:
                a_term = apply(Af[d], val, ax)
                ks = (a_term if ks is None
                      else apply(Mf[d], ks, ax) + a_term)
            if need_M or (need_K and d < self.dim - 1):
                val = apply(Mf[d], val, ax)
        return (ks if need_K else None), (val if need_M else None)

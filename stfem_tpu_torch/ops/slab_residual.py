"""Whole-slab TRUE residual of the iterative refinement, in native FP64
(counterpart of stfem_tpu/ops/floatfloat.py::FFSlabResidual, which runs
the same semantics in float-float because the TPU has no FP64).

Built from the f64 operators and the full multi-step tables, it holds
  * the rectangular per-step tables (rows = one step's nt blocks, columns
    = [previous step's last dof, the step's blocks]: the fused form of the
    block-bidiagonal structure, floatfloat.py:277-297);
  * the Gamma previous-slab coupling (mass path, first step's rows only).
residual() runs the whole slab at once: every step's nt+1 input blocks go
through ONE Kronecker pair (kernel K2, ops/kron_pair.py) over a batch of
(nt+1) * n_steps blocks, then the per-step tables mix them.
"""
from __future__ import annotations

import numpy as np
import torch

from ..system import SystemMatrix
from ..utils.precision import full_precision
from .kronfac import KronAssembled


class SlabResidual64:
    """r = rhs - (Alpha (x) K + Beta (x) M) x with
    rhs = Gamma (x) M prev + force, all in float64."""

    def __init__(self, K64, M64, Alpha, Beta, Gamma):
        A_np = np.asarray(Alpha, np.float64)
        B_np = np.asarray(Beta, np.float64)
        G_np = np.asarray(Gamma, np.float64)
        struct = SystemMatrix._detect_step_structure(A_np, B_np)
        assert struct is not None, "the residual needs the step structure"
        nt, A0, A1, B0, B1 = struct
        assert not (np.any(A1[:, :-1]) or np.any(B1[:, :-1])), \
            "the step coupling must read only the previous last dof"
        self.nt = int(nt)
        self.n_blocks = int(A_np.shape[0])
        assert G_np.shape == (self.n_blocks, 1)
        assert not np.any(G_np[nt:]), "Gamma feeds only the first step"
        dev = K64.device
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
        self.A = as_t(np.concatenate([A1[:, -1:], A0], axis=1))  # nt x nt+1
        self.B = as_t(np.concatenate([B1[:, -1:], B0], axis=1))
        self.G = as_t(G_np[:nt])                                  # nt x 1
        self.kron = KronAssembled(K64, M64, torch.float64)
        self.mask = as_t(K64.mask_np)

    def rhs(self, prev: torch.Tensor, fslab: torch.Tensor):
        """rhs = Gamma (x) M prev + force; prev: one dof grid, fslab:
        [n_blocks, *dofgrid]."""
        _, Mp = self.kron.pair(prev * self.mask, need_K=False)
        coup = self.G.reshape((-1,) + (1,) * Mp.ndim) * Mp[None]
        out = fslab.clone()
        out[:self.nt] += coup * self.mask
        return out

    def residual(self, prev: torch.Tensor, x: torch.Tensor,
                 fslab: torch.Tensor):
        """Returns (r, ||r||, ||rhs||); r has x's shape (float64)."""
        with full_precision():
            rhs = self.rhs(prev, fslab)
            nt = self.nt
            S = self.n_blocks // nt
            xs = x.reshape((S, nt) + x.shape[1:])
            prev_last = torch.cat([torch.zeros_like(xs[:1, -1:]),
                                   xs[:-1, -1:]], dim=0)
            # [nt+1, S, *dof]: block axis first, steps as the batch
            xin = torch.cat([prev_last, xs], dim=1).transpose(0, 1)
            Kx, Mx = self.kron.pair((xin * self.mask).contiguous())
            y = (torch.einsum("ji,i...->j...", self.A, Kx)
                 + torch.einsum("ji,i...->j...", self.B, Mx)) * self.mask
            r = rhs - y.transpose(0, 1).reshape(x.shape)
            return (r, torch.linalg.vector_norm(r.reshape(-1)),
                    torch.linalg.vector_norm(rhs.reshape(-1)))

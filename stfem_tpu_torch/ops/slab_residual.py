"""Whole-slab TRUE residual of the iterative refinement, in native FP64
(counterpart of stfem_tpu/ops/floatfloat.py::FFSlabResidual, which runs
the same semantics in float-float because the TPU has no FP64).

Built from the f64 operators and the full multi-step tables, it holds
  * the rectangular per-step tables (rows = one step's nt blocks, columns
    = [coupling columns, the step's blocks]: the fused form of the
    block-bidiagonal structure, floatfloat.py:277-297).  The coupling
    columns are the previous step's last dof for the first-order tables,
    or the whole previous step for the Schur-reduced wave tables, whose
    coupling reads several of its dofs;
  * the previous-slab couplings, first step's rows only: Gamma (mass path,
    previous u), and for wave Gamma_K (stiffness path, previous u) and
    Gamma_v (mass path, previous v).
residual() runs the whole slab at once: every step's input blocks go
through ONE Kronecker pair (kernel K2, ops/kron_pair.py) over a batch of
(n_coupling + nt) * n_steps blocks, then the per-step tables mix them; the
rhs couplings ask for M x alone (kernel K3, ops/banded_apply.py).

The Kronecker engine is injected with its constraint mask, as stfem_tpu's
FFSlabResidual takes kron_ff/mask: the scalar KronAssembled of the f64
operators (heat, wave) or the Stokes saddle engine (ops/stokes_residual.py).
"""
from __future__ import annotations

import numpy as np
import torch

from ..system import SystemMatrix
from ..utils.precision import full_precision
from ..utils.timer import span


class SlabResidual64:
    """r = rhs - (Alpha (x) K + Beta (x) M) x with
    rhs = [Gamma_K (x) K prev +] Gamma (x) M prev [+ Gamma_v (x) M prev_v]
    + force, all in float64."""

    def __init__(self, kron, mask, Alpha, Beta, Gamma, Gamma_K=None,
                 Gamma_v=None):
        """kron: an f64 engine with pair(x, need_K, need_M) and .device;
        mask: its constraint mask (numpy), broadcast against the engine's
        dofs."""
        A_np = np.asarray(Alpha, np.float64)
        B_np = np.asarray(Beta, np.float64)
        struct = SystemMatrix._detect_step_structure(A_np, B_np)
        assert struct is not None, "the residual needs the step structure"
        nt, A0, A1, B0, B1 = struct
        self.nt = int(nt)
        self.n_blocks = int(A_np.shape[0])
        self.full_coupling = bool(np.any(A1[:, :-1]) or np.any(B1[:, :-1]))
        self.n_coupling = self.nt if self.full_coupling else 1
        dev = kron.device
        as_t = lambda a: torch.as_tensor(a, dtype=torch.float64, device=dev)
        c = slice(nt - self.n_coupling, nt)
        self.A = as_t(np.concatenate([A1[:, c], A0], axis=1))
        self.B = as_t(np.concatenate([B1[:, c], B0], axis=1))

        def first_step(G):
            if G is None:
                return None
            G = np.asarray(G, np.float64)
            assert G.shape == (self.n_blocks, 1)
            assert not np.any(G[nt:]), "Gamma feeds only the first step"
            return as_t(G[:nt])

        self.G = first_step(Gamma)
        self.Gk = first_step(Gamma_K)
        self.Gv = first_step(Gamma_v)
        self.kron = kron
        self.mask = as_t(mask)

    def rhs(self, prev: torch.Tensor, fslab: torch.Tensor,
            prev_v: torch.Tensor | None = None):
        """rhs = [Gk (x) K prev +] Gamma (x) M prev [+ Gv (x) M prev_v]
        + force; prev, prev_v: one dof grid, fslab: [n_blocks, *dofgrid]."""
        Kp, Mp = self.kron.pair(prev * self.mask,
                                need_K=self.Gk is not None)
        lead = (-1,) + (1,) * Mp.ndim
        coup = self.G.reshape(lead) * Mp[None]
        if self.Gk is not None:
            coup = coup + self.Gk.reshape(lead) * Kp[None]
        if self.Gv is not None:
            _, Mv = self.kron.pair(prev_v * self.mask, need_K=False)
            coup = coup + self.Gv.reshape(lead) * Mv[None]
        out = fslab.clone()
        out[:self.nt] += coup * self.mask
        return out

    def residual(self, prev: torch.Tensor, x: torch.Tensor,
                 fslab: torch.Tensor, prev_v: torch.Tensor | None = None,
                 accumulate=None, norm=None):
        """Returns (r, ||r||, ||rhs||); r has x's shape (float64).

        On a rank's slab (the engine and mask of its sub-mesh, fslab its
        local assembly, prev and x consistent) r and rhs hold partial sums
        on the shared planes: accumulate (a RankLayout's) completes both,
        and norm (the interface-weighted global one) takes their norms.
        The tracer's span residual64."""
        with full_precision(), span("residual64"):
            rhs = self.rhs(prev, fslab, prev_v)
            nt, nc = self.nt, self.n_coupling
            S = self.n_blocks // nt
            xs = x.reshape((S, nt) + x.shape[1:])
            coupled = torch.cat([torch.zeros_like(xs[:1, nt - nc:]),
                                 xs[:-1, nt - nc:]], dim=0)
            # [nc+nt, S, *dof]: block axis first, steps as the batch
            xin = torch.cat([coupled, xs], dim=1).transpose(0, 1)
            Kx, Mx = self.kron.pair((xin * self.mask).contiguous())
            y = (torch.einsum("ji,i...->j...", self.A, Kx)
                 + torch.einsum("ji,i...->j...", self.B, Mx)) * self.mask
            r = rhs - y.transpose(0, 1).reshape(x.shape)
            if accumulate is not None:
                r, rhs = accumulate(r), accumulate(rhs)
            norm = norm or (lambda a: torch.linalg.vector_norm(a.reshape(-1)))
            return r, norm(r), norm(rhs)

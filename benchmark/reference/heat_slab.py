"""The reference judgement of one heat slab, in plain FP64 PyTorch.

The deployment: u_t - c Laplace(u) = f on a box, continuous Q_k in space
(Gauss-Lobatto nodes, homogeneous Dirichlet on every face), dG(r) in time
(right Radau nodes), S steps of length tau in one slab.  For a slab that
starts at t0 from the previous slab's end value u_prev, the system is, per
step s and time dof i (the space operators of the free dofs only),

    sum_j [tau mass_ij c K + der_jump_ij M] x_sj
        - start_i M x_(s-1)(end) = F_si          (s > 0)
    ... = F_0i + start_i M u_prev                (s = 0)

with K, M the Kronecker sums and products of the 1D matrices, x_(s)(end)
= sum_j end_j x_sj, and the load F_si = tau w_i (f(t0 + tau (s + z_i)),
phi) by the time rule on the nodes z_i and n_q-point Gauss per cell and
axis in space.  `HeatSlabReference.residual` builds all of it from the
deployment's numbers and the data's mode parameters alone, and returns the
TRUE relative residual ||rhs - A x|| / ||rhs|| of a solution x that the
program produced.  It runs in chunks of steps, so a slab of 2 x 10^8
unknowns needs a few GB."""
from __future__ import annotations

import numpy as np
import torch

from . import fe


class HeatSlabReference:
    """cells: per-axis cell counts; lower/upper: the box; k: space degree;
    n_q: Gauss points per cell and axis of the load; r: time degree; tau:
    the step; n_steps: steps a slab; coefficient: c."""

    def __init__(self, cells, lower, upper, k: int, n_q: int, r: int,
                 tau: float, n_steps: int, coefficient: float = 1.0,
                 device="cpu", chunk_bytes: float = 2.5e8):
        self.cells = [int(c) for c in cells]
        self.lower = [float(a) for a in lower]
        self.length = [float(b) - float(a) for a, b in zip(lower, upper)]
        self.k, self.n_q, self.r = int(k), int(n_q), int(r)
        self.tau, self.n_steps = float(tau), int(n_steps)
        self.coefficient = float(coefficient)
        self.device = torch.device(device)
        self.time = fe.DGTime(self.r)
        as_t = lambda a: torch.as_tensor(np.asarray(a), dtype=torch.float64,
                                         device=self.device)
        self.M1, self.K1, masks = [], [], []
        for c, ln in zip(self.cells, self.length):
            M, K = fe.fe_matrices_1d(c, self.k, ln)
            self.M1.append(as_t(M))
            self.K1.append(as_t(K))
            m = np.ones(c * self.k + 1)
            m[0] = m[-1] = 0.0
            masks.append(m)
        mask = masks[0]
        for m in masks[1:]:
            mask = np.multiply.outer(mask, m)
        self.mask = as_t(mask)
        self.space_shape = tuple(c * self.k + 1 for c in self.cells)
        nt = self.r + 1
        per_step = nt * float(np.prod(self.space_shape)) * 8.0
        self.chunk = max(1, int(chunk_bytes // per_step))
        self.t_mass = as_t(self.tau * self.coefficient * self.time.mass)
        self.t_der = as_t(self.time.der_jump)
        self.t_start = as_t(self.time.start)
        self.t_end = as_t(self.time.end)

    # ---- space ----------------------------------------------------------
    @staticmethod
    def _axis(A: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
        return torch.movedim(torch.tensordot(x, A, dims=([axis], [1])), -1,
                             axis)

    def space_pair(self, x: torch.Tensor):
        """(K x, M x) over the trailing three axes of x (dense 1D
        matrices, one axis at a time)."""
        a0, a1, a2 = (x.ndim - 3, x.ndim - 2, x.ndim - 1)
        M, K = self.M1, self.K1
        u1 = self._axis(M[2], x, a2)
        u2 = self._axis(M[1], u1, a1)
        Mx = self._axis(M[0], u2, a0)
        Kx = self._axis(K[0], u2, a0)
        Kx += self._axis(M[0], self._axis(K[1], u1, a1), a0)
        Kx += self._axis(M[0], self._axis(M[1], self._axis(K[2], x, a2),
                                          a1), a0)
        return Kx, Mx

    def end_value(self, tail: torch.Tensor) -> torch.Tensor:
        """The value at the end of a step from its r + 1 time blocks."""
        return torch.tensordot(self.t_end, tail.to(torch.float64), dims=1)

    # ---- load -------------------------------------------------------------
    def _space_loads(self, forcing) -> torch.Tensor:
        """(m, *space): the tensor-product load vector of each mode."""
        out = []
        for m in range(forcing.amplitude.size):
            v = None
            for d in range(3):
                b = fe.load_vector_1d(
                    lambda x: forcing.space_1d(m, d, x), self.cells[d],
                    self.k, self.n_q, self.lower[d], self.length[d])
                b = torch.as_tensor(b, dtype=torch.float64,
                                    device=self.device)
                v = b if v is None else v[..., None] * b
            out.append(v)
        return torch.stack(out)

    def load_coefficients(self, forcing, t0: float) -> torch.Tensor:
        """(n_steps, r + 1, m): tau w_i a_m g_m(t0 + tau (s + z_i))."""
        nt = self.r + 1
        s = np.arange(self.n_steps)[:, None]
        t = t0 + self.tau * (s + self.time.nodes[None, :])
        g = forcing.time_factors(t.reshape(-1)).reshape(self.n_steps, nt, -1)
        coef = self.tau * self.time.weights[None, :, None] * g
        return torch.as_tensor(coef, dtype=torch.float64, device=self.device)

    # ---- the judgement ----------------------------------------------------
    def residual(self, x: torch.Tensor, u_prev: torch.Tensor, forcing,
                 t0: float, keep: bool = False) -> dict:
        """TRUE residual of the slab solution x [n_steps (r + 1), *space]
        that starts at t0 from the end value u_prev [*space]: returns
        {"rel", "r_norm", "rhs_norm"} (float64 2-norms over the free
        dofs), and with keep the residual and rhs themselves ("r",
        "rhs", shaped as x; for small sizes)."""
        nt, S = self.r + 1, self.n_steps
        if tuple(x.shape) != (S * nt,) + self.space_shape:
            raise ValueError(f"slab solution of shape {tuple(x.shape)}, "
                             f"expected {(S * nt,) + self.space_shape}")
        loads = self._space_loads(forcing)
        coef = self.load_coefficients(forcing, t0)
        with torch.no_grad():
            _, carry = self.space_pair((u_prev.to(torch.float64)
                                        * self.mask)[None])
            carry = carry[0] * self.mask
            r_sq = rhs_sq = 0.0
            kept = []
            for s0 in range(0, S, self.chunk):
                s1 = min(S, s0 + self.chunk)
                xc = (x[s0 * nt:s1 * nt].to(torch.float64)
                      * self.mask).reshape((s1 - s0, nt) + self.space_shape)
                Kx, Mx = self.space_pair(xc)
                y = (torch.einsum("ij,sj...->si...", self.t_mass, Kx)
                     + torch.einsum("ij,sj...->si...", self.t_der, Mx))
                del Kx
                m_end = torch.einsum("j,sj...->s...", self.t_end, Mx)
                del Mx
                # M x at the previous step's end: the slab's start for s = 0
                prev = torch.cat([carry[None], m_end[:-1]])
                carry = m_end[-1]
                F = torch.einsum("sim,m...->si...", coef[s0:s1], loads)
                coupling = self.t_start[None, :, None, None, None] * prev[:, None]
                r = (F + coupling - y) * self.mask
                r_sq += float(torch.sum(r * r))
                rhs = F.clone()
                if s0 == 0:
                    rhs[0] += coupling[0]
                rhs = rhs * self.mask
                rhs_sq += float(torch.sum(rhs * rhs))
                if keep:
                    kept.append((r.reshape((-1,) + self.space_shape),
                                 rhs.reshape((-1,) + self.space_shape)))
                del r, rhs, F, y, prev, coupling
        r_n, b_n = float(np.sqrt(r_sq)), float(np.sqrt(rhs_sq))
        out = {"rel": r_n / b_n if b_n > 0 else float("inf"),
               "r_norm": r_n, "rhs_norm": b_n}
        if keep:
            out["r"] = torch.cat([a for a, _ in kept])
            out["rhs"] = torch.cat([b for _, b in kept])
        return out

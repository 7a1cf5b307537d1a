"""The seeded data family of a heat march: the initial state and the
forcing, made from `--seed` and a traffic mix's parameters.

    u0(x)   = sum_m b_m prod_d sin(pi k_md x_d)
    f(x, t) = sum_m a_m (c_m + sin(2 pi t / P_m + phi_m)) prod_d sin(pi l_md x_d)

on the unit cube [0, 1]^3 (every mode vanishes on its boundary).  The
mix fixes each mode's wave numbers, amplitude, offset, period and phase;
the seed draws the signs and the order of each mode's wave numbers over
the axes.  a_m is scaled by pi^2 |l_m|^2, so the quasi-static
response, and with it the solution, stays of order one over any number of
slabs.

Both sides get the same data: the program receives u0 as nodal values on
its dof grid and f as a callable it evaluates at its own quadrature
points (`ForcingField`); the reference reads the mode parameters and
integrates them by itself."""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .reference import fe


@dataclass(frozen=True)
class Modes:
    """m separable sine modes: amplitude (m,), wave numbers (m, dim);
    for a forcing also the offset, period and phase of each mode's time
    factor c + sin(2 pi t / P + phi)."""
    amplitude: np.ndarray
    waves: np.ndarray
    offset: np.ndarray | None = None
    period: np.ndarray | None = None
    phase: np.ndarray | None = None

    def space_1d(self, m: int, d: int, x: np.ndarray) -> np.ndarray:
        return np.sin(np.pi * self.waves[m, d] * x)

    def time_factors(self, t: np.ndarray) -> np.ndarray:
        """(len(t), m): a_m (c_m + sin(2 pi t / P_m + phi_m))."""
        t = np.asarray(t, np.float64)[:, None]
        return self.amplitude * (self.offset + np.sin(
            2.0 * np.pi * t / self.period + self.phase))


@dataclass(frozen=True)
class SlabData:
    seed: int
    initial: Modes
    forcing: Modes


def _rng(seed: int) -> np.random.Generator:
    """Any whole number, also negative or past 64 bits, names one
    stream."""
    return np.random.default_rng(np.random.SeedSequence(int(seed) % 2 ** 64))


def _modes(rng, spec: list[dict], dim: int):
    """The mix's modes with a seeded sign and a seeded order of each
    mode's wave numbers over the axes: (amplitude, waves)."""
    amp = np.array([float(m["amplitude"]) for m in spec])
    amp = amp * rng.choice([-1.0, 1.0], amp.size)
    waves = np.array([rng.permutation(np.asarray(m["waves"], int))
                      for m in spec]).reshape(len(spec), dim)
    return amp, waves


def make(seed: int, traffic: dict, slab_duration: float,
         dim: int = 3) -> SlabData:
    """The data of one run.  traffic["initial"]["modes"] and
    traffic["forcing"]["modes"] fix each mode's wave numbers, amplitude
    and, for the forcing, its offset, period in slabs (slab_duration =
    steps a slab x tau) and phase; the seed draws only each mode's sign
    and the order of its wave numbers over the axes.  The cube is
    symmetric under a change of axes and the modes are orthogonal, so
    every seed poses the same problem up to those symmetries, and the
    same work: a seed that drew phases or periods would change how far
    each slab's start lies from its solution, and with it the V-cycles
    a slab."""
    rng = _rng(seed)
    amp0, waves0 = _modes(rng, traffic["initial"]["modes"], dim)
    spec = traffic["forcing"]["modes"]
    amp, waves = _modes(rng, spec, dim)
    amp = amp * np.pi ** 2 * np.sum(waves ** 2, axis=1)
    offset = np.array([float(m["offset"]) for m in spec])
    period = np.array([float(m["period_slabs"]) for m in spec]) * slab_duration
    phase = np.array([float(m["phase"]) for m in spec])
    return SlabData(seed=int(seed), initial=Modes(amp0, waves0),
                    forcing=Modes(amp, waves, offset, period, phase))


def nodal(modes: Modes, axes: list[np.ndarray], device,
          dtype=torch.float64) -> torch.Tensor:
    """sum_m amplitude_m prod_d sin(pi k_md x_d) at the tensor grid of
    the 1D node coordinates `axes` (one outer product per mode, on the
    device)."""
    out = None
    for m in range(modes.amplitude.size):
        term = torch.tensor(float(modes.amplitude[m]), dtype=dtype,
                            device=device)
        for d, x in enumerate(axes):
            v = torch.as_tensor(modes.space_1d(m, d, x), dtype=dtype,
                                device=device)
            term = term[..., None] * v
        out = term if out is None else out + term
    return out


def initial_state(data: SlabData, cells: list[int], degree: int,
                  device) -> torch.Tensor:
    """u0 as nodal values of continuous Q_degree on cells[d] equal cells
    of [0, 1] per axis (Gauss-Lobatto nodes), float64."""
    axes = [fe.node_coordinates_1d(c, degree) for c in cells]
    return nodal(data.initial, axes, device)


class ForcingField:
    """f(pts, t) for the program: pts [..., dim], t a number or a tensor
    that broadcasts against pts[..., 0].  The space factors of the modes
    at a given point set are computed once and kept; a time tensor of
    shape (B, 1, .., 1) is contracted with them in one matrix product."""

    def __init__(self, modes: Modes):
        self.modes = modes
        self._space = {}

    def _space_factors(self, pts: torch.Tensor) -> torch.Tensor:
        key = (pts.data_ptr(), tuple(pts.shape), pts.dtype, pts.device)
        s = self._space.get(key)
        if s is None:
            w = torch.as_tensor(np.pi * self.modes.waves, dtype=pts.dtype,
                                device=pts.device)
            s = torch.stack([
                torch.prod(torch.sin(w[m] * pts), dim=-1)
                for m in range(w.shape[0])])
            self._space = {key: s}
        return s

    def __call__(self, pts: torch.Tensor, t) -> torch.Tensor:
        s = self._space_factors(pts)
        md = self.modes
        as_t = lambda a: torch.as_tensor(a, dtype=pts.dtype,
                                         device=pts.device)
        t = as_t(t)
        g = as_t(md.amplitude) * (as_t(md.offset) + torch.sin(
            (2.0 * np.pi) * t[..., None] / as_t(md.period) + as_t(md.phase)))
        if t.ndim == s.ndim and t.numel() == t.shape[0]:
            flat = g.reshape(t.shape[0], -1) @ s.reshape(s.shape[0], -1)
            return flat.reshape((t.shape[0],) + s.shape[1:])
        m, P = s.shape[0], tuple(s.shape[1:])
        n = max(len(P), t.ndim)
        gm = torch.movedim(g, -1, 0).reshape((m,) + (1,) * (n - t.ndim)
                                             + tuple(t.shape))
        sm = s.reshape((m,) + (1,) * (n - len(P)) + P)
        return torch.sum(gm * sm, dim=0)

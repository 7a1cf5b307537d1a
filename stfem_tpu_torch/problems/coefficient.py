"""Heterogeneous diffusion coefficient of the robustness configs
(counterpart of stfem_tpu/problems/coefficient.py; reference
include/operators.h:870-965): a piecewise-constant 3-region field (c1
below y=0.2; c2/c3 left/right of x=0.2 above) optionally multiplied by a
per-subdivision-cell random distortion in [1-d, 1+d].

NumPy only: the field is evaluated once per (cell, quadrature point) at
operator setup.  The random stream is NumPy's default_rng with the same
seed as stfem_tpu's, so both packages draw the same factors (the
reference's boost::mt19937 draw order is not reproduced)."""
from __future__ import annotations

import numpy as np


class Coefficient:
    def __init__(self, subdivisions, lower, upper, distort_coeff: float = 0.0,
                 c1: float = 1.0, c2: float = 9.0, c3: float = 16.0,
                 seed: int = 5489):  # 5489 = mt19937 default seed
        self.c1, self.c2, self.c3 = c1, c2, c3
        self.lower = np.asarray(lower, dtype=np.float64)
        self.upper = np.asarray(upper, dtype=np.float64)
        self.subdivisions = tuple(int(s) for s in subdivisions)
        self.distorted = distort_coeff != 0.0
        if self.distorted:
            rng = np.random.default_rng(seed)
            self.distortion = rng.uniform(1 - distort_coeff,
                                          1 + distort_coeff,
                                          size=self.subdivisions)
            self.step = (self.upper - self.lower) / np.array(
                self.subdivisions)

    def __call__(self, pts: np.ndarray) -> np.ndarray:
        """pts: [..., dim] -> coefficient values [...]."""
        pts = np.asarray(pts)
        px, py = pts[..., 0], pts[..., 1]
        v = np.where(py >= 0.2, np.where(px < 0.2, self.c2, self.c3), self.c1)
        if self.distorted:
            idx = tuple(
                np.clip(((pts[..., d] - self.lower[d]) / self.step[d])
                        .astype(np.int64), 0, self.subdivisions[d] - 1)
                for d in range(pts.shape[-1]))
            v = v * self.distortion[idx]
        return v

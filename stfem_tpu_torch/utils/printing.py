"""Text formatting of the reference's golden files (counterpart of
stfem_tpu/utils/printing.py)."""
from __future__ import annotations

import numpy as np


def print_formatted(matrix: np.ndarray, threshold: float = 0.01) -> str:
    """Reference tests/tp_02.cc:12-30: %7.2f per entry, blank where
    |x| < threshold, one blank line after the matrix."""
    m = np.atleast_2d(np.asarray(matrix))
    lines = ["".join("       " if abs(m[i, j]) < threshold
                     else "%7.2f" % m[i, j] for j in range(m.shape[1]))
             for i in range(m.shape[0])]
    return "\n".join(lines) + "\n\n"

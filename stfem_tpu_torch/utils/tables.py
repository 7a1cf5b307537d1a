"""Convergence / iteration tables with the reference's output shape
(counterpart of stfem_tpu/utils/tables.py: deal.II
ConvergenceTable::write_text + reduction_rate_log2 columns; reference
tests/tp_01.cc:735-768)."""
from __future__ import annotations

import math


class ConvergenceTable:
    def __init__(self):
        self.rows: list[dict] = []
        self.rate_cols: list[str] = []

    def add_row(self, **kv):
        self.rows.append(kv)

    def evaluate_convergence_rates(self, col: str):
        if col not in self.rate_cols:
            self.rate_cols.append(col)

    def clear(self):
        self.rows = []
        self.rate_cols = []

    def _fmt(self, col, v):
        if isinstance(v, float) and col not in ("rate",):
            return f"{v:.5e}"
        return str(v)

    def text(self) -> str:
        if not self.rows:
            return ""
        cols = list(self.rows[0].keys())
        cells = {c: [self._fmt(c, r[c]) for r in self.rows] for c in cols}
        rates = {}
        for c in self.rate_cols:
            vals = [r[c] for r in self.rows]
            rr = ["-"]
            for a, b in zip(vals, vals[1:]):
                rr.append(f"{math.log2(a / b):.2f}" if b > 0 and a > 0
                          else "-")
            rates[c] = rr
        widths = {c: max(len(c), *(len(x) for x in cells[c])) for c in cols}
        lines = []
        hdr = []
        for c in cols:
            hdr.append(c.ljust(widths[c]))
            if c in rates:
                hdr.append("    ")
        lines.append(" ".join(hdr))
        for i in range(len(self.rows)):
            row = []
            for c in cols:
                row.append(cells[c][i].rjust(widths[c]))
                if c in rates:
                    row.append(rates[c][i].rjust(4))
            lines.append(" ".join(row))
        return "\n".join(lines)

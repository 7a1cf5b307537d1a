"""The yardstick of the kernels: the card's peaks and the least time a
kernel call could take, from the shapes and dtypes it was given.

A call's bound is the larger of (every input read once + every output
written once) / HBM bandwidth and its operations / the peak rate of their
type.  The operations are the algorithm's, not an implementation's: the
nonzeros of the banded or cell-blocked 1D factors times what they are
applied to.  `KernelCalls` records the bound of every call of the
kernels that the cell's roofline metrics name, while it is active, by
wrapping the module-level helper that each launch goes through; each
metric file (`metrics/<kernel>_roofline.py`) names the helper, the
fragment of its kernels' names and the bound of a call."""
from __future__ import annotations

import importlib
import math

# NVIDIA H100 SXM data sheet (dense, no sparsity), at the 700 W limit:
# HBM3 3.35 TB/s; FP64 67 TFLOP/s on the tensor cores (34 outside them);
# FP32 67 TFLOP/s outside the tensor cores; TF32 495, BF16 989 on them.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"f64": 67e12, "f32": 67e12, "tf32": 495e12, "bf16": 989e12}
ITEMSIZE = {"torch.float64": 8, "torch.float32": 4, "torch.bfloat16": 2,
            "torch.float16": 2}


def bound_s(n_bytes: float, flops: float, kind: str) -> float:
    """The least time of the work on the card, in seconds."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind])


def grid_chain_work(x_shape, x_itemsize: int, mat_shapes, mat_itemsize: int,
                    out_itemsize: int, k: int, up: bool):
    """(bytes, flops) of one K4 call: y[b] = (M_0 (x) .. (x) M_{d-1}) x[b]
    applied axis after axis, each M_d cell-blocked with k + 1 taps per
    row of the down pattern (q_d (k + 1) nonzeros, q_d the eigen rows)."""
    nb, n_in = int(x_shape[0]), [int(n) for n in x_shape[1:]]
    n_out = [int(s[0]) for s in mat_shapes]
    q = [int(s[1] if up else s[0]) for s in mat_shapes]
    flops = 0.0
    for d in range(len(n_in)):
        other = math.prod(n_out[:d]) * math.prod(n_in[d + 1:])
        flops += 2.0 * q[d] * (k + 1) * other
    flops *= nb
    n_bytes = (nb * math.prod(n_in) * x_itemsize
               + nb * math.prod(n_out) * out_itemsize
               + sum(int(a) * int(b) for a, b in mat_shapes) * mat_itemsize)
    return float(n_bytes), flops


def kron_pair_work(x_shape, k: int):
    """(bytes, flops) of one K2 call: (K x, M x) in FP64 over the last
    three axes by banded (2k + 1)-tap factors with the shared mass prefix:
    two tap sets on the first axis, three on each later one, 2 (2k + 1)
    operations a tap set and element; read x, write K x and M x, read the
    two factors' diagonals."""
    numel = math.prod(int(n) for n in x_shape)
    n = [int(v) for v in x_shape[-3:]]
    tables = 2 * (2 * k + 1) * sum(n) * 8
    return float(3 * numel * 8 + tables), numel * 16.0 * (2 * k + 1)


def share(summary: dict, name: str):
    """A kernel's share of its roofline over the traced stretch, in
    percent: the sum of its calls' bounds over its kernels' device time.
    None without a trace, or where the calls and the kernels do not pair
    up one to one."""
    t = summary["trace"]
    if not t:
        return None
    g, b = t["groups"].get(name), t["kernel_bounds"].get(name)
    if (not g or not b or not g["count"] or g["count"] != b["calls"]
            or g["device_s"] <= 0):
        return None
    return 100.0 * b["bound_s"] / g["device_s"]


class KernelCalls:
    """Context manager: while active, every call of each probe's wrapped
    function appends its bound (seconds) to calls[name].  probes:
    [(name, (module, attribute), bound)], bound taking the wrapped
    function's arguments; each wrapper passes every argument on
    unchanged and returns what the function returns."""

    def __init__(self, probes=()):
        self.probes = list(probes)
        self.calls = {name: [] for name, _, _ in self.probes}
        self._saved = []

    def __enter__(self):
        for name, (module, attr), bound in self.probes:
            mod = importlib.import_module(module)
            fn = getattr(mod, attr)
            setattr(mod, attr, _recording(fn, bound, self.calls[name]))
            self._saved.append((mod, attr, fn))
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in reversed(self._saved):
            setattr(mod, attr, fn)
        self._saved = []
        return False

    def totals(self) -> dict:
        return {g: {"calls": len(v), "bound_s": float(sum(v))}
                for g, v in self.calls.items()}


def _recording(fn, bound, sink):
    def wrapped(*args, **kwargs):
        sink.append(bound(*args, **kwargs))
        return fn(*args, **kwargs)
    return wrapped

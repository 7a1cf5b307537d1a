"""K6 (the level operators' bf16 / float32 Kronecker pair) against its
roofline: the sum of each call's bound over the sum of its kernels'
device time, in percent, over the traced stretch.  Nothing when calls and
kernels do not pair up, and nothing from a program without the kernel
(no WRAP then: no call is recorded and no kernel is grouped).

A call's bytes: read x, write K x and M x, in x's dtype, and read the two
float32 tables of the three axes; its operations: 16 (2k + 1) an element
(two tap sets on axis 0, three on axes 1 and 2, 2 (2k + 1) operations a
tap set), FP32 FMAs on the CUDA cores in both dtypes.

KERNEL, WRAP and bound() as in k4_roofline.py."""
import importlib.util
import math

from benchmark.roofline import bound_s, share

KERNEL = ("level_pair",)
if importlib.util.find_spec("stfem_tpu_torch.ops.level_pair") is not None:
    WRAP = ("stfem_tpu_torch.ops.level_pair", "_launch")


def bound(x, dm, da, k):
    numel = math.prod(int(n) for n in x.shape)
    tables = 2 * (2 * int(k) + 1) * sum(int(n) for n in x.shape[-3:]) * 4
    nbytes = 3 * numel * x.element_size() + tables
    return bound_s(float(nbytes), 16.0 * (2 * int(k) + 1) * numel, "f32")


def read(summary):
    return share(summary, "level_pair_roofline")

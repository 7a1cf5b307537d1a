"""K2 (FP64 Kronecker pair) against its roofline: the sum of each call's
bound over the sum of its kernels' device time, in percent, over the
traced stretch.  Nothing when calls and kernels do not pair up.

KERNEL, WRAP and bound() as in k4_roofline.py."""
from benchmark.roofline import bound_s, kron_pair_work, share

KERNEL = ("kron_pair",)
WRAP = ("stfem_tpu_torch.ops.kron_pair", "kernel_args")


def bound(x, Dm, Da, k):
    nbytes, flops = kron_pair_work(tuple(x.shape), int(k))
    return bound_s(nbytes, flops, "f64")


def read(summary):
    return share(summary, "k2_roofline")

"""K4 (grid chain) against its roofline: the sum of each call's bound
(from the shapes it was given) over the sum of its kernels' device time,
in percent, over the traced stretch.  Nothing when the calls and the
kernels do not pair up one to one.

KERNEL: fragments of the kernels' names in the trace; WRAP: the helper
that every launch goes through, wrapped while the stretch is traced;
bound(): the least time of one call, from that helper's arguments."""
from benchmark.roofline import ITEMSIZE, bound_s, grid_chain_work, share

KERNEL = ("grid_chain_",)
WRAP = ("stfem_tpu_torch.ops.grid_chain", "_launch")


def bound(x, mats, out_dtype, cells, k, up, name):
    nbytes, flops = grid_chain_work(
        tuple(x.shape), x.element_size(), [tuple(m.shape) for m in mats],
        mats[0].element_size(), ITEMSIZE[str(out_dtype)], int(k), bool(up))
    return bound_s(nbytes, flops,
                   "f64" if str(x.dtype) == "torch.float64" else "f32")


def read(summary):
    return share(summary, "k4_roofline")

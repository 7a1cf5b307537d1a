"""The multi-rank dry run (counterpart of __graft_entry__.py:59-105):
spawn n ranks, run the sharded whole solve (minibench.py) at stfem_tpu's
dry-run size -- 8^3 cells, 8 steps a slab, Q4 x dG(2), a 3-axis mesh
with z split -- and require TRUE <= 1e-8, iteration parity with the
single-device run and the gathered solution within
minibench.SOLUTION_RTOL of the single-device one.

The ranks' backend follows the devices:
  * NCCL, one rank per GPU, when there are as many GPUs as ranks;
  * gloo ranks sharing the one GPU when there are fewer: every rank
    computes on cuda:0, and only the halo planes and the scalar
    reductions pass through gloo, staged through the host.  Eight
    processes time-share the card, so its walls are no scaling figure;
  * gloo on the CPU when the caller asks for device "cpu".
A failure of the 3D solve is the result: there is no other problem to
fall back to (stfem_tpu's 2D fallback, __graft_entry__.py:106-173, is
not ported).

    python -m stfem_tpu_torch.parallel.dryrun --devices 8 [--device cpu]
        [--cells 8] [--ntao 8]
"""
from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from datetime import timedelta

import torch
import torch.distributed as dist

JOIN_S = 1800.0
TIMEOUT_S = 600.0       # of each collective


def choose_backend(n_ranks: int, device: str) -> tuple[str, str]:
    """(backend, device of every rank's compute): see the module
    docstring."""
    if device == "cpu":
        return "gloo", "cpu"
    if not torch.cuda.is_available():
        raise RuntimeError("dryrun: no CUDA device (pass device='cpu' for "
                           "gloo ranks on the CPU)")
    if torch.cuda.device_count() >= n_ranks:
        return "nccl", "cuda"
    return "gloo", "cuda"


def run_rank(cells: int = 8, ntao: int = 8, device="cuda", **kwargs) -> dict:
    """One rank's part of the dry run, inside a process group (raises
    without one): run_sharded_minibench with z split and the single-device
    comparison, its result checked."""
    from .minibench import SOLUTION_RTOL, run_sharded_minibench
    out = run_sharded_minibench(cells=cells, ntao=ntao, shard_z=True,
                                compare_single=True, device=device,
                                verbose=False, **kwargs)
    if not out["converged"]:
        raise AssertionError(f"sharded solve: TRUE rel "
                             f"{out['sharded_true_rel']:.2e} > 1e-8")
    if not out["iter_parity"]:
        raise AssertionError(f"sharded V-cycle steps {out['sharded_iters']}"
                             f" != single-device {out['single_iters']}")
    if not out["solution_match"]:
        raise AssertionError(f"sharded solution {out['solution_rel_diff']:.2e}"
                             f" off the single-device one (tol "
                             f"{SOLUTION_RTOL:g})")
    return out


def _rank_main(rank: int, n: int, init_file: str, out_dir: str,
               backend: str, device: str, kwargs: dict) -> None:
    torch.set_num_threads(1)
    if device == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
    dist.init_process_group(backend, init_method=f"file://{init_file}",
                            rank=rank, world_size=n,
                            timeout=timedelta(seconds=TIMEOUT_S))
    try:
        out = run_rank(device=device, **kwargs)
        out["backend"], out["rank"] = backend, rank
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
            json.dump(out, f)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int = 8, device: str | None = None,
                     cells: int = 8, ntao: int = 8, verbose: bool = True,
                     **kwargs) -> list[dict]:
    """Spawn n_devices ranks (choose_backend), run run_rank on each and
    return their results in rank order.  A rank that fails or does not
    finish within JOIN_S seconds fails the run (RuntimeError, or the
    rank's own exception); each collective waits at most TIMEOUT_S."""
    import torch.multiprocessing as tmp

    n = int(n_devices)
    backend, dev = choose_backend(n, device or "cuda")
    if dev == "cuda":
        from ..ops import cuda_kernels
        cuda_kernels.build()        # once, before the ranks load it
    kwargs = dict(kwargs, cells=cells, ntao=ntao)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmpd:
        ctx = tmp.start_processes(
            _rank_main, args=(n, os.path.join(tmpd, "init"), tmpd, backend,
                              dev, kwargs),
            nprocs=n, join=False, start_method="spawn")
        deadline = time.time() + JOIN_S
        try:
            while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
                if time.time() > deadline:
                    raise RuntimeError(f"dryrun: the {n} ranks did not "
                                       f"finish in {JOIN_S:.0f} s")
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.kill()
        outs = []
        for r in range(n):
            with open(os.path.join(tmpd, f"rank{r}.json")) as f:
                outs.append(json.load(f))
    out = outs[0]
    if verbose:
        where = (f"{n} gloo ranks sharing one GPU" if backend == "gloo"
                 and dev == "cuda" else f"{n} {backend} ranks on {dev}")
        q, r = kwargs.get("space_degree", 4), kwargs.get("fe_degree", 2)
        print(f"dryrun_multichip: {where}, 3D mesh {out['mesh']} (z "
              f"sharded), Q{q} x dG({r}) {out['cells']}^3 "
              f"ntao={out['ntao']} ({out['n_blocks']} blocks x "
              f"{out['space_dofs']} dofs), "
              f"{out['sharded_iters']} V-cycle steps, TRUE rel "
              f"{out['sharded_true_rel']:.2e} (FP64 IR, iteration parity "
              f"with single-device, solution within "
              f"{out['solution_rel_diff']:.2e} of it), collectives "
              f"{out['collectives']}, "
              f"{time.time() - t0:.1f} s", flush=True)
    return outs


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--cells", type=int, default=8)
    ap.add_argument("--ntao", type=int, default=8)
    args = ap.parse_args(argv)
    dryrun_multichip(args.devices, args.device, cells=args.cells,
                     ntao=args.ntao)


if __name__ == "__main__":
    main()

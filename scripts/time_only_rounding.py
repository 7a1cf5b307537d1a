"""How float32 rounding sets the FGMRES count of the time-only cycle.

tests/test_aux.py's time-only configuration (2D, refinement 2, DG(1), 4
steps at once, space_or_time to 1 step) on stfem_tpu_torch, on the CPU:
the per-slab FGMRES iterations with float32 and with float64 V-cycles,
then the first slab's FGMRES again with the float32 V-cycle's output
perturbed by relative noise of a given size, one run per seed.

    python scripts/time_only_rounding.py [--noise 6e-8] [--seeds 6]
"""
import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from stfem_tpu_torch import integrators  # noqa: E402
from stfem_tpu_torch.drivers.heat import (run_heat_cycle,  # noqa: E402
                                          stmg_preconditioner_factory)
from stfem_tpu_torch.krylov import fgmres  # noqa: E402
from stfem_tpu_torch.types import CoarseningType, TimeStepType  # noqa: E402


def cycle(dtype, on_solve=None):
    """The test_aux cycle's result with `dtype` V-cycles; on_solve(A, b,
    x0, P, kw) sees each slab's FGMRES call."""
    orig = integrators.fgmres

    def traced(A, b, x0, P, **kw):
        if on_solve is not None:
            on_solve(A, b, x0, P, kw)
        return orig(A, b, x0, P, **kw)

    integrators.fgmres = traced
    try:
        return run_heat_cycle(
            refinement=2, fe_degree=1, type_=TimeStepType.DG,
            n_timesteps_at_once=4, gmres_maxiter=60, device="cpu",
            preconditioner_factory=stmg_preconditioner_factory(
                dtype=dtype, fe_degree_min=1, time_only=True,
                n_timesteps_at_once_min=1,
                coarsening_type=CoarseningType.space_or_time))
    finally:
        integrators.fgmres = orig


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--noise", type=float, default=6e-8)
    ap.add_argument("--seeds", type=int, default=6)
    args = ap.parse_args()
    os.environ["STFEM_EIG_CACHE"] = "0"
    torch.set_num_threads(1)
    first = []
    for dtype in (torch.float32, torch.float64):
        res = cycle(dtype, lambda *a: first.append(a) if not first else None)
        print(f"{str(dtype)[6:]} V-cycles: FGMRES iterations a slab "
              f"{res.slab_iterations}, L2-L2 {res.l2_l2:.12e}")
    A, b, x0, P, kw = first[0]
    for seed in range(args.seeds):
        gen = torch.Generator().manual_seed(seed)

        def noisy(v):
            y = P(v)
            return y * (1 + args.noise * torch.randn(
                y.shape, generator=gen, dtype=y.dtype))

        r = fgmres(A, b, x0, noisy, **kw)
        print(f"first slab, float32 V-cycle x (1 + {args.noise:g} N(0, 1)), "
              f"seed {seed}: {r.iterations} iterations, residual "
              f"{r.residual:.3e}")


if __name__ == "__main__":
    main()

"""The tp_01 application (counterpart of stfem_tpu/drivers/tp01.py;
reference tests/tp_01.cc): heat cycles from reference-format JSON configs.

    python -m stfem_tpu_torch.drivers.tp01 [--file cfg.json] [--dim 3]
        [--precondition_float 1] [--device cuda]

Practical mode (spaceTimeConvergenceTest false) is ported: the
unit-integral C-infinity bump at sourcePoint as the initial value, zero
rhs, the heterogeneous coefficient on K, point probes written to the
functionals file.  Convergence mode needs the error norms (errors.py),
which are not ported, and raises.  Without --file the driver runs the
committed 3D practical configuration, configs/tp01_practical_3d.json
(16^3 cells, Q3 x dG(2), 8 steps per slab, 4 slabs); stfem_tpu's default
runs the reference's tf01..tf08 convergence configs instead.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import torch

from ..config import Parameters
from ..utils.tables import ConvergenceTable
from .heat import run_heat_cycle, stmg_preconditioner_factory

PRACTICAL_3D = Path(__file__).resolve().parents[1] / "configs" \
    / "tp01_practical_3d.json"

# reference probe points (tp_01.cc:449-453)
PROBES = {2: [(0.75, 0.0)],
          3: [(0.75, 0.0, 0.0), (0.0, 0.0, 0.75), (0.75, 0.1, 0.75)]}


def run_single(p: Parameters, k: int, ref: int,
               precondition_float: bool = True, timer=None, device="cuda",
               on_slab=None):
    """One (degree, refinement) cell of the tp_01 sweep (reference
    tests/tp_01.cc:735-742 convergence-cycle body); on_slab is
    run_heat_cycle's per-slab callback."""
    if p.space_time_conv_test:
        raise NotImplementedError("convergence mode needs errors.py, which "
                                  "is not ported")
    from ..problems.coefficient import Coefficient
    from ..problems.heat import cutoff_cinfty

    factory = None
    if p.space_time_mg:
        factory = stmg_preconditioner_factory(
            dtype=torch.float32 if precondition_float else torch.float64,
            params=p.mg_data, coarsening_type=p.coarsening_type,
            time_before_space=p.time_before_space,
            space_time_level_first=p.space_time_level_first,
            use_pmg=p.use_pmg,
            # golden-era conventions: time-k floor at degree >= 1
            fe_degree_min=max(p.fe_degree_min, 1),
            poly_coarsening=p.poly_coarsening)
    src = p.source if p.source is not None else (0.0,) * p.dim
    return run_heat_cycle(
        refinement=ref, fe_degree=k, type_=p.type, problem=p.problem,
        n_timesteps_at_once=p.n_timesteps_at_once,
        subdivisions=p.subdivisions, lower=p.hyperrect_lower_left,
        upper=p.hyperrect_upper_right, end_time=p.end_time,
        frequency=p.frequency, preconditioner_factory=factory,
        gmres_maxiter=100 if factory else 800, rel_tol=p.rel_tol,
        extrapolate=p.extrapolate,
        coefficient=Coefficient(p.subdivisions, p.hyperrect_lower_left,
                                p.hyperrect_upper_right, p.distort_coeff),
        initial_fn=lambda c: cutoff_cinfty(c, src),
        rhs_fn_override=lambda pts, t: torch.zeros_like(pts[..., 0]),
        compute_errors=False, do_output=p.do_output,
        probe_points=PROBES[p.dim], functionals_path=p.functional_file,
        timer=timer, device=device, on_slab=on_slab)


def run_config(p: Parameters, precondition_float: bool = True,
               out=sys.stdout, device="cuda"):
    from ..utils.timer import TimerOutput
    table = ConvergenceTable()
    itable_rows = []
    timer = TimerOutput() if p.print_timing else None
    if os.path.exists(p.functional_file):
        os.remove(p.functional_file)
    for k in range(p.fe_degree, p.fe_degree + p.n_deg_cycles):
        iters_row = {"k \\ r": k}
        for ref in range(p.refinement, p.refinement + p.n_ref_cycles):
            res = run_single(p, k, ref, precondition_float, timer, device)
            print(f":: Number of active cells: {res.n_cells}", file=out)
            print(f":: Number of degrees of freedom: {res.n_dofs}", file=out)
            print(f"Average GMRES iterations {res.avg_iterations:g} "
                  f"({res.total_iterations} gmres_iterations / "
                  f"{res.n_timesteps} timesteps)\n", file=out)
            table.add_row(cells=res.n_cells, **{
                "s-dofs": res.n_dofs, "t-dofs": res.n_blocks,
                "st-dofs": res.st_dofs,
                "work": res.st_dofs // res.n_blocks * res.total_iterations})
            iters_row[str(ref)] = res.avg_iterations
        print(f"Convergence table k={k}", file=out)
        print(table.text(), file=out)
        print("", file=out)
        table.clear()
        itable_rows.append(iters_row)
    print("Iteration count table", file=out)
    cols = list(itable_rows[0].keys())
    print(" ".join(c.rjust(7) for c in cols), file=out)
    for r in itable_rows:
        print(" ".join(f"{r[c]:7.4f}" if isinstance(r[c], float)
                       else str(r[c]).rjust(7) for c in cols), file=out)
    print("", file=out)
    if timer is not None:
        print(timer.summary(), file=out)
        print("", file=out)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--file", "-f", default=str(PRACTICAL_3D))
    ap.add_argument("--dim", "-d", type=int, default=3)
    # reference CLI: `--precondition_float 1` / `0` (tp_01.cc:781-792)
    ap.add_argument("--precondition_float", "-p", type=int, choices=(0, 1),
                    default=1)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("tp01: no CUDA device (pass --device cpu for a run "
                         "on the CPU)")
    run_config(Parameters.parse(args.file, args.dim),
               bool(args.precondition_float), device=args.device)


if __name__ == "__main__":
    main()

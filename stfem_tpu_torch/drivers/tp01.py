"""The tp_01 application (counterpart of stfem_tpu/drivers/tp01.py;
reference tests/tp_01.cc): heat and wave cycles from reference-format
JSON configs, with the convergence tables (errors and observed rates) and
the iteration count table.

    python -m stfem_tpu_torch.drivers.tp01 [--file cfg.json | --file default]
        [--dim 3] [--precondition_float 1] [--device cuda]

Convergence mode (spaceTimeConvergenceTest true, the reference's default
run): the manufactured solution as the initial value (and its time
derivative for the wave), the manufactured rhs, no coefficient, and the
L-infinity(L-infinity), L2(L2) and L2(H1-semi) errors per cycle.
Practical mode: the unit-integral C-infinity bump at sourcePoint as the
initial value, zero rhs, the heterogeneous coefficient on K, point probes
written to the functionals file.

Without --file the driver runs the committed 3D practical configuration,
configs/tp01_practical_3d.json (16^3 cells, Q3 x dG(2), 8 steps per slab,
4 slabs).  `--file default` runs the reference's eight convergence
configs tf01..tf08 from the directory STFEM_TESTDIR names, with the
reference's section headers, as stfem_tpu's default does; the committed
3D convergence configs are configs/tp01_convergence_3d_heat_dg1.json and
configs/tp01_convergence_3d_wave_cgp2.json.  The *_chebyshev.json
configs are the practical and heat convergence ones with the Chebyshev
smoother and the GMRES coarse solve.  "doOutput" writes one binary VTK
file per slab into the working directory.
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

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
PRACTICAL_3D = CONFIGS / "tp01_practical_3d.json"
CONVERGENCE_3D = {"heat_dg1": CONFIGS / "tp01_convergence_3d_heat_dg1.json",
                  "wave_cgp2": CONFIGS / "tp01_convergence_3d_wave_cgp2.json"}

# reference probe points (tp_01.cc:449-453)
PROBES = {2: [(0.75, 0.0)],
          3: [(0.75, 0.0, 0.0), (0.0, 0.0, 0.75), (0.75, 0.1, 0.75)]}

# the reference's default run (tp_01.cc:818-826): section header, file
DEFAULT_RUN = [("HEAT 2 steps at once DG", "tf01.json"), ("", "tf02.json"),
               ("HEAT single step", "tf03.json"), ("", "tf04.json"),
               ("WAVE 4 steps at once", "tf05.json"), ("", "tf06.json"),
               ("WAVE single step", "tf07.json"), ("", "tf08.json")]


def run_single(p: Parameters, k: int, ref: int,
               precondition_float: bool = True, timer=None, device="cuda",
               on_slab=None):
    """One (degree, refinement) cell of the tp_01 sweep (reference
    tests/tp_01.cc:735-742 convergence-cycle body); on_slab is
    run_heat_cycle's per-slab callback."""
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
    mode = {}
    if not p.space_time_conv_test:
        from ..problems.coefficient import Coefficient
        from ..problems.heat import cutoff_cinfty
        src = p.source if p.source is not None else (0.0,) * p.dim
        mode = dict(
            coefficient=Coefficient(p.subdivisions, p.hyperrect_lower_left,
                                    p.hyperrect_upper_right,
                                    p.distort_coeff),
            initial_fn=lambda c: cutoff_cinfty(c, src),
            initial_v_fn=lambda c: torch.zeros_like(c[..., 0]),
            rhs_fn_override=lambda pts, t: torch.zeros_like(pts[..., 0]),
            compute_errors=False, probe_points=PROBES[p.dim],
            functionals_path=p.functional_file)
    return run_heat_cycle(
        refinement=ref, fe_degree=k, type_=p.type, problem=p.problem,
        n_timesteps_at_once=p.n_timesteps_at_once,
        subdivisions=p.subdivisions, lower=p.hyperrect_lower_left,
        upper=p.hyperrect_upper_right, end_time=p.end_time,
        frequency=p.frequency, preconditioner_factory=factory,
        gmres_maxiter=100 if factory else 800, rel_tol=p.rel_tol,
        extrapolate=p.extrapolate, do_output=p.do_output, timer=timer,
        device=device, on_slab=on_slab, **mode)


ERROR_COLUMNS = ("L∞-L∞", "L2-L2", "L2-H1_semi")


def run_config(p: Parameters, precondition_float: bool = True,
               out=None, device="cuda", timer=None, on_cycle=None,
               on_slab=None):
    """Every (degree, refinement) cycle of a config, printing the cycle
    lines, each degree's convergence table (the error columns with their
    observed rates in convergence mode) and the iteration count table in
    stfem_tpu's format.  timer: a utils.timer.TimerOutput for the cycles'
    scopes (one is made when the config asks for printTiming); on_cycle(k,
    ref, result), if given, is called after each cycle, and on_slab is
    run_heat_cycle's per-slab callback; out: a text stream (sys.stdout
    when None).  Returns the CycleResults by (k, ref)."""
    from ..utils.timer import TimerOutput
    out = sys.stdout if out is None else out
    table = ConvergenceTable()
    itable_rows, results = [], {}
    if timer is None and p.print_timing:
        timer = TimerOutput()
    if not p.space_time_conv_test and os.path.exists(p.functional_file):
        os.remove(p.functional_file)
    for k in range(p.fe_degree, p.fe_degree + p.n_deg_cycles):
        iters_row = {"k \\ r": k}
        for ref in range(p.refinement, p.refinement + p.n_ref_cycles):
            res = run_single(p, k, ref, precondition_float, timer, device,
                             on_slab)
            results[(k, ref)] = res
            if on_cycle is not None:
                on_cycle(k, ref, res)
            print(f":: Number of active cells: {res.n_cells}", file=out)
            print(f":: Number of degrees of freedom: {res.n_dofs}", file=out)
            print(f"Average GMRES iterations {res.avg_iterations:g} "
                  f"({res.total_iterations} gmres_iterations / "
                  f"{res.n_timesteps} timesteps)\n", file=out)
            row = {"cells": res.n_cells, "s-dofs": res.n_dofs,
                   "t-dofs": res.n_blocks, "st-dofs": res.st_dofs,
                   "work": res.st_dofs // res.n_blocks
                   * res.total_iterations}
            if p.space_time_conv_test:
                # error columns only in convergence mode (tp_01.cc:357,387)
                row.update(zip(ERROR_COLUMNS, (res.linf_linf, res.l2_l2,
                                               res.l2_h1)))
            table.add_row(**row)
            iters_row[str(ref)] = res.avg_iterations
        if p.space_time_conv_test:
            for c in ERROR_COLUMNS:
                table.evaluate_convergence_rates(c)
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
    if p.print_timing:
        print(timer.summary(), file=out)
        print("", file=out)
    return results


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
    run = lambda path: run_config(Parameters.parse(path, args.dim),
                                  bool(args.precondition_float),
                                  device=args.device)
    if args.file != "default":
        run(args.file)
        return
    test_dir = os.environ.get("STFEM_TESTDIR")
    if not test_dir:
        raise SystemExit("tp01: --file default reads tf01..tf08.json from "
                         "the directory STFEM_TESTDIR names")
    for header, name in DEFAULT_RUN:
        if header:
            print(header)
        run(os.path.join(test_dir, name))


if __name__ == "__main__":
    main()

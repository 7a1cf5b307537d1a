"""The tp_03stokes application (counterpart of
stfem_tpu/drivers/tp03stokes.py; reference tests/tp_03stokes.cc): Stokes
convergence and iteration tables, or the practical lid-driven cavity or
DFG channel, from reference-format JSON configs.

    python -m stfem_tpu_torch.drivers.tp03stokes [--file cfg.json |
        --file default] [--dim 2] [--device cuda]

Convergence mode (spaceTimeConvergenceTest true): per (degree,
refinement) cycle the cycle lines, each degree's convergence table (the
seven error columns of u and p with their observed rates) and the
iteration count table, in stfem_tpu's format.  Practical mode
(spaceTimeConvergenceTest false): with dfgBenchmark 0 the lid-driven
cavity with the functionals file, with dfgBenchmark >= 1 the DFG channel
(gridDescriptor dfgBenchmarkSquare, or dfgBenchmark for the cylinder)
with the obstacle's drag and lift per slab.  The Stokes parameters
(viscosity, meanPressure, dfgBenchmark, uMean, ...) come from the
config's additionalFile, defaults without one.

Without --file the driver runs the committed lid-driven configuration,
configs/tp03stokes_lid_2d.json (256^2 cells, all 512 slabs: a long run);
the committed convergence configuration is
configs/tp03stokes_convergence_2d_dg1.json and the DFG channel's
configs/tp03stokes_dfg_2d.json (288 x 96 cells, 4 slabs).  `--file
default` runs the reference's tf01stokes and tf02stokes from the
directory STFEM_TESTDIR names, as stfem_tpu's default does.
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path

import torch

from ..config import Parameters, StokesParameters
from ..stmg.gmg import build_stmg_stokes
from ..utils.tables import ConvergenceTable
from .stokes import run_dfg_square, run_lid_driven, run_stokes_cycle

CONFIGS = Path(__file__).resolve().parents[1] / "configs"
CONVERGENCE_2D = CONFIGS / "tp03stokes_convergence_2d_dg1.json"
LID_2D = CONFIGS / "tp03stokes_lid_2d.json"
DFG_2D = CONFIGS / "tp03stokes_dfg_2d.json"

ERROR_COLUMNS = ("L∞-L∞(u)", "L2-L2(u)", "L2-H1_semi(u)", "L2-Hdiv_semi(u)",
                 "L∞-L∞(p)", "L2-L2(p)", "L2-H1_semi(p)")


def parse_stokes_extra(path: str) -> StokesParameters:
    """stokes::Parameters (reference stokes.cc:6-27); defaults without a
    file."""
    if path and os.path.exists(path):
        return StokesParameters.parse(path)
    return StokesParameters()


def stmg_factory(p: Parameters):
    """The preconditioner factory of both modes: the float32 Stokes STMG
    V-cycle with the config's multigrid parameters, on the cycle's
    device."""
    def factory(ctx):
        return build_stmg_stokes(
            ctx["mesh"], ctx["fe_degree"], ctx["type_"],
            ctx["n_timesteps_at_once"], ctx["time_step"],
            viscosity=ctx["viscosity"], params=p.mg_data,
            coarsening_type=p.coarsening_type,
            time_before_space=p.time_before_space,
            space_time_level_first=p.space_time_level_first,
            use_pmg=p.use_pmg, fe_degree_min=max(p.fe_degree_min, 1),
            fe_degree_min_space=max(p.fe_degree_min_space, 1),
            weak_faces=ctx.get("weak_faces", ()),
            free_faces=ctx.get("free_faces", ()),
            weak_obstacle=ctx.get("weak_obstacle", False),
            device=ctx["device"])

    return factory if p.space_time_mg else None


def run_single(p: Parameters, stokes_extra: StokesParameters, k: int,
               ref: int, device="cuda", timer=None, on_slab=None):
    """One (degree, refinement) cell of the tp_03stokes sweep."""
    factory = stmg_factory(p)
    return run_stokes_cycle(
        refinement=ref, fe_degree=k, type_=p.type,
        n_timesteps_at_once=p.n_timesteps_at_once,
        viscosity=stokes_extra.viscosity, end_time=p.end_time,
        mean_pressure=stokes_extra.mean_pressure,
        preconditioner_factory=factory,
        gmres_maxiter=100 if factory else 1000, rel_tol=p.rel_tol,
        extrapolate=p.extrapolate, device=device, timer=timer,
        on_slab=on_slab)


def run_practical(p: Parameters, stokes_extra: StokesParameters, k: int,
                  ref: int, n_slabs_max: int | None = None, device="cuda",
                  timer=None, on_slab=None) -> dict:
    """One practical-mode run (spaceTimeConvergenceTest false): the
    lid-driven cavity (dfgBenchmark 0) with the functionals file (probe
    velocity, wall force and divergence, tp_03stokes.cc:918-996), or the
    DFG channel (dfgBenchmark >= 1; the cylinder for gridDescriptor
    dfgBenchmark) for n_slabs_max slabs (4 without), with the drag, lift
    and divergence per slab."""
    factory = stmg_factory(p)
    if stokes_extra.dfg_benchmark != 0:
        return run_dfg_square(
            refinement=ref, fe_degree=k, type_=p.type,
            viscosity=stokes_extra.viscosity, u_mean=stokes_extra.u_mean,
            dfg_benchmark=stokes_extra.dfg_benchmark, end_time=p.end_time,
            n_slabs=n_slabs_max or 4, preconditioner_factory=factory,
            gmres_maxiter=150 if factory else 1500, rel_tol=p.rel_tol,
            cylinder=p.grid_descriptor == "dfgBenchmark", device=device,
            timer=timer, on_slab=on_slab)
    return run_lid_driven(
        refinement=ref, fe_degree=k, type_=p.type,
        n_timesteps_at_once=p.n_timesteps_at_once,
        viscosity=stokes_extra.viscosity, end_time=p.end_time,
        preconditioner_factory=factory,
        gmres_maxiter=100 if factory else 1000, rel_tol=p.rel_tol,
        n_slabs_max=n_slabs_max, strong_bc=not p.nitsche_boundary,
        functionals_path=p.functional_file, device=device, timer=timer,
        on_slab=on_slab)


def run_config(p: Parameters, stokes_extra: StokesParameters, out=None,
               n_slabs_max: int | None = None, device="cuda", timer=None,
               on_cycle=None, on_slab=None) -> dict:
    """Every (degree, refinement) cycle of a config, printing stfem_tpu's
    lines and tables (out: a text stream, sys.stdout when None).
    on_cycle(k, ref, result), if given, is called after each cycle;
    timer and on_slab go to the cycles.  Returns the results by (k, ref):
    StokesCycleResults in convergence mode, run_lid_driven's dicts in
    practical mode."""
    out = sys.stdout if out is None else out
    results = {}
    cycles = [(k, ref) for k in range(p.fe_degree,
                                      p.fe_degree + p.n_deg_cycles)
              for ref in range(p.refinement, p.refinement + p.n_ref_cycles)]
    if not p.space_time_conv_test:
        # practical mode: iteration log + functionals file, no error norms
        if os.path.exists(p.functional_file):
            os.remove(p.functional_file)
        for k, ref in cycles:
            res = run_practical(p, stokes_extra, k, ref, n_slabs_max,
                                device, timer, on_slab)
            results[(k, ref)] = res
            if on_cycle is not None:
                on_cycle(k, ref, res)
            iters = res["iterations"]
            print(f"Average GMRES iterations "
                  f"{sum(iters) / max(len(iters), 1):g} "
                  f"({sum(iters)} gmres_iterations / {len(iters)} "
                  f"timesteps)\n", file=out)
        return results
    table = ConvergenceTable()
    itable_rows = []
    for k in range(p.fe_degree, p.fe_degree + p.n_deg_cycles):
        iters_row = {"k \\ r": k}
        for ref in range(p.refinement, p.refinement + p.n_ref_cycles):
            res = run_single(p, stokes_extra, k, ref, device, timer,
                             on_slab)
            results[(k, ref)] = res
            if on_cycle is not None:
                on_cycle(k, ref, res)
            print(f"\n:: Number of active cells: {res.n_cells}", file=out)
            print(f":: Number of u degrees of freedom: {res.n_dofs_u}",
                  file=out)
            print(f":: Number of p degrees of freedom: {res.n_dofs_p}",
                  file=out)
            print(f"Average GMRES iterations {res.avg_iterations:g} "
                  f"({res.total_iterations} gmres_iterations / "
                  f"{res.n_timesteps} timesteps)\n", file=out)
            st = res.n_timesteps * (res.n_dofs_u + res.n_dofs_p) \
                * res.n_blocks // 2
            table.add_row(**{
                "cells": res.n_cells,
                "s-dofs": res.n_dofs_u + res.n_dofs_p,
                "t-dofs": res.n_blocks // 2, "st-dofs": st,
                "work": st * res.total_iterations // max(res.n_timesteps, 1),
                **dict(zip(ERROR_COLUMNS, (
                    res.linf_linf_u, res.l2_l2_u, res.l2_h1_u,
                    res.l2_hdiv_u, res.linf_linf_p, res.l2_l2_p,
                    res.l2_h1_p)))})
            iters_row[str(ref)] = res.avg_iterations
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
    return results


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--file", "-f", default=str(LID_2D))
    ap.add_argument("--dim", "-d", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("tp03stokes: no CUDA device (pass --device cpu for "
                         "a run on the CPU)")
    test_dir = os.environ.get("STFEM_TESTDIR")

    def run_one(path):
        p = Parameters.parse(path, args.dim)
        extra = p.additional_file
        if extra and not os.path.isabs(extra):
            # the reference's configs name 'tests/json/stokes.json'
            extra = os.path.join(test_dir or os.path.dirname(path),
                                 os.path.basename(extra))
        run_config(p, parse_stokes_extra(extra), device=args.device)

    if args.file != "default":
        run_one(args.file)
        return
    if not test_dir:
        raise SystemExit("tp03stokes: --file default reads tf01stokes.json "
                         "and tf02stokes.json from the directory "
                         "STFEM_TESTDIR names")
    for name in ("tf01stokes.json", "tf02stokes.json"):
        run_one(os.path.join(test_dir, name))


if __name__ == "__main__":
    main()

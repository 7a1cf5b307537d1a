"""bench.py's sections in one run: the Stokes, wave and heat slab-solve
throughput benches (bench_stokes, bench_wave, bench_heat) in that order,
then a summary block.

    python -m stfem_tpu_torch.bench [--no-stokes] [--no-wave]
        [--budget-s 1100] [--device cuda] [heat switches]
        [--wave-* switches] [--stokes-* switches]

Every switch of the three benches is here: the heat ones under their own
names (--cells, --inner, --outer, ...), the wave and Stokes ones with the
prefixes --wave- and --stokes- (--wave-cells, --stokes-ir, ...).  Each
flag's default reads the STFEM_BENCH_* variable that bench.py reads, as
do --stokes / --no-stokes (STFEM_BENCH_STOKES), --wave / --no-wave
(STFEM_BENCH_WAVE) and --budget-s (STFEM_BENCH_BUDGET_S): a secondary
section (Stokes, wave) that would start after the run has taken
budget-s seconds is skipped, with a line that says so.

Each section prints its info JSON line and, when it converged, its metric
line (bench.py's names and units); then the summary block repeats every
section's info and metric lines, and the heat metric line comes last.
Unlike bench.py (bench.py:1653-1663), an exception in a section is not
caught: it ends the run with a non-zero exit code.
"""
from __future__ import annotations

import argparse
import json
import os
import time

import torch

from . import bench_heat, bench_stokes, bench_wave
from .utils.switches import Switch, add_switches, switch_kwargs

SECTIONS = (
    Switch("stokes", "STFEM_BENCH_STOKES", "stokes", "bool", True,
           "run the Stokes section"),
    Switch("wave", "STFEM_BENCH_WAVE", "wave", "bool", True,
           "run the wave section"),
    Switch("budget-s", "STFEM_BENCH_BUDGET_S", "budget_s", float, 1100.0,
           "skip a secondary section once the run has taken this long (s)"))


def parser(environ) -> argparse.ArgumentParser:
    """The command line, every default read from environ."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    add_switches(ap, SECTIONS, environ)
    add_switches(ap, bench_heat.SWITCHES, environ)
    add_switches(ap, bench_wave.SWITCHES, environ, prefix="wave-")
    add_switches(ap, bench_stokes.SWITCHES, environ, prefix="stokes-")
    ap.add_argument("--device", default="cuda")
    return ap


def main(argv=None, environ=None) -> None:
    t_main = time.time()
    args = parser(os.environ if environ is None else environ).parse_args(
        argv)
    if args.device.startswith("cuda") and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA device (the bench measures the "
                         "GPU; pass --device cpu for a functional run)")
    summary = []

    def emit(line: dict) -> None:
        text = json.dumps(line)
        print(text, flush=True)
        summary.append(text)

    for name, module, on in (("stokes", bench_stokes, args.stokes),
                             ("wave", bench_wave, args.wave)):
        if not on:
            continue
        elapsed = time.time() - t_main
        if elapsed > args.budget_s:
            print(f"# {name} bench skipped (elapsed {elapsed:.0f}s > budget "
                  f"{args.budget_s:.0f})", flush=True)
            continue
        info, _ = module.run(device=args.device, **switch_kwargs(
            args, module.SWITCHES, prefix=f"{name}-"))
        emit(info)
        if info["converged"]:
            emit(module.metric_line(info))
        else:
            print(f"# {name} bench NOT converged -- metric withheld",
                  flush=True)
    info, _ = bench_heat.run(device=args.device,
                             **switch_kwargs(args, bench_heat.SWITCHES))
    emit(info)
    print("# ---- bench summary (all sections; heat metric last) ----",
          flush=True)
    for text in summary:
        print(text, flush=True)
    print(json.dumps(bench_heat.metric_line(info)), flush=True)


if __name__ == "__main__":
    main()

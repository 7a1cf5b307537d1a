"""The readings that the limits of `correct` are set from, for one cell:
on each seed, the program as a run drives it (probe, warm-up slab, then
`--slabs` slabs of the march) with the slabs that a run judges (the
warm-up slab, one drawn from the seed, the last) judged by the
reference; then the control, the program's float32-only path (no FP64
refinement pass), on its own seeds.  The set-up that does not depend on
the seed is built once, so a dozen seeds take one process.

    python3 benchmark/readings.py --workload <name> --seeds 1,2,..
        [--control-seeds 3,4,5] [--slabs 4] [--out file.json]

Prints one JSON line per seed and a summary: the largest reading of the
program, the smallest of the control."""
import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def one_seed(marches, program, c, seed: int, slabs: int, ir_passes,
             device) -> dict:
    from benchmark.cell import JudgedSlabs, sync

    march = marches.march(program, c["traffic"], seed, ir_passes)
    t0 = time.perf_counter()
    probe = march.probe()
    judged = JudgedSlabs(seed, march)
    warm = int(c["traffic"]["warmup_slabs"])
    for n in range(warm + slabs):
        i, x, _ = march.slab()
        (judged.warmup if n < warm else judged.window)(i, x)
    sync(device)
    wall = time.perf_counter() - t0
    judged = judged.slabs()
    del x
    checks = march.judge(judged)
    return {"seed": seed, "ir_passes": ir_passes, "wall_s": wall,
            "probe": probe, "solves": march.solves,
            "checks": {k: v["value"] for k, v in checks.items()},
            "max": max(v["value"] for v in checks.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--slabs", type=int, default=4)
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from benchmark import spec
    from benchmark.run import environment
    import torch

    if args.device == "cuda" and not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 3
    environment()
    c = spec.cell(spec.load_benchmark(ROOT), args.workload, ROOT)
    marches = spec.march_module(c["config"])
    program = marches.Program(c["config"], args.device)
    rows = []
    runs = [(int(s), None) for s in args.seeds.split(",") if s]
    runs += [(int(s), 0) for s in args.control_seeds.split(",") if s]
    for seed, irp in runs:
        row = one_seed(marches, program, c, seed, args.slabs, irp,
                       torch.device(args.device))
        rows.append(row)
        print(json.dumps(row), flush=True)
    prog = [r["max"] for r in rows if r["ir_passes"] is None]
    ctrl = [min(r["checks"].values()) for r in rows if r["ir_passes"] == 0]
    summary = {"workload": args.workload, "program_max": max(prog or [0]),
               "program_n": len(prog),
               "control_min": min(ctrl) if ctrl else None,
               "control_n": len(ctrl)}
    print(json.dumps(summary), flush=True)
    if args.out:
        pathlib.Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"rows": rows, "summary": summary}, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""One run of one cell of the port's benchmark, on the machine it is
started on:

    python3 benchmark/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1>

The last line of standard output is the result (one JSON object); the
last lines of standard error are the numbers that decide `correct`, each
beside its limit.  It exits with another code than 0, and prints no
result, where the card is missing or too few cards are present, where the
run loaded JAX or the JAX package, or where a step fails.

Every cache sits at a fixed path inside the checkout: the kernels'
build (`build/kernels/`, the program's own), the smoother estimates
(`benchmark/cache/`, a file named by a hash of the program's solver and
kernel sources), and the traced runs' Chrome traces (`benchmark/out/`)."""
import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import hashlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
# run as a script, the benchmark's own folder would head sys.path and its
# modules would shadow the standard library's (trace, ...): the checkout
# root takes its place
if sys.path and pathlib.Path(sys.path[0] or ".").resolve() == HERE:
    sys.path[0] = str(ROOT)
elif str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

CACHE = HERE / "cache"
OUT = HERE / "out"
HASHED = ("stmg", "ops", "csrc")


def code_hash(package: pathlib.Path = ROOT / "stfem_tpu_torch") -> str:
    """SHA-256 (16 hex digits) over the program's solver and kernel
    sources, so that an estimate is never read by other code."""
    h = hashlib.sha256()
    for sub in HASHED:
        for p in sorted((package / sub).rglob("*")):
            if p.is_file() and p.suffix in (".py", ".cu", ".h", ".cuh"):
                h.update(str(p.relative_to(package)).encode())
                h.update(p.read_bytes())
    return h.hexdigest()[:16]


def environment(environ=os.environ) -> None:
    """The caches of the run, inside the checkout at fixed paths: the
    estimates', and torch's extension and Triton caches for any kernel
    of the program that builds through them."""
    environ["STFEM_EIG_CACHE"] = str(CACHE / f"eig-{code_hash()}.json")
    environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="one run of one cell")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark import spec
    bench = spec.load_benchmark(ROOT)
    chips = int(spec.cell(bench, args.workload, ROOT)["cell"]["chips"])

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"no result: the cell needs {chips} CUDA device(s), "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              " present", file=sys.stderr)
        return 3
    environment()
    from benchmark import cell
    from benchmark.imports import banned

    result, lines = cell.run(
        args.workload, args.seed, args.seconds, bool(args.trace),
        device="cuda", root=ROOT, bench=bench, t_process=T_PROCESS,
        out_dir=OUT / args.workload)
    found = banned(list(sys.modules))
    if found:
        print("no result: the run loaded " + ", ".join(found),
              file=sys.stderr)
        return 4
    for line in lines:
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())

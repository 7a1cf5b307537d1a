"""Build and load the hand-written CUDA kernels of csrc/.

The kernels have a plain C interface and are compiled by nvcc (one
process per source, in parallel) into one shared library, loaded with
ctypes (no PyTorch headers: the build takes seconds).  The build runs at
first use, from the sources in this package alone, into build/kernels/ at
the repository root; it is redone whenever a source is newer than the
library.  Nothing here runs when the package is imported.
"""
from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import time
from pathlib import Path

from ..utils.timer import count, span

CSRC = Path(__file__).resolve().parents[1] / "csrc"
SOURCES = ("time_solve.cu", "kron_pair.cu", "banded_apply.cu",
           "grid_chain.cu", "quad_middle.cu", "level_pair.cu")
LIB_PATH = (Path(__file__).resolve().parents[2] / "build" / "kernels"
            / "libstfem_kernels.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC"]

_LIB = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and Path(root, "bin", "nvcc").exists():
            return str(Path(root, "bin", "nvcc"))
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(force: bool = False, verbose: bool = False) -> tuple[float, str]:
    """Compile csrc/*.cu into LIB_PATH if it is missing or stale: one nvcc
    per source, all started together, then one link.  Returns (seconds
    spent, compiler output).  verbose adds -Xptxas -v (registers, shared
    memory and spills per kernel)."""
    srcs = [CSRC / s for s in SOURCES]
    if (not force and LIB_PATH.exists()
            and all(LIB_PATH.stat().st_mtime >= s.stat().st_mtime
                    for s in srcs)):
        return 0.0, ""
    LIB_PATH.parent.mkdir(parents=True, exist_ok=True)
    nvcc, tag = _nvcc(), f".{os.getpid()}.tmp"
    objs = [LIB_PATH.parent / (s.stem + tag + ".o") for s in srcs]
    t0 = time.time()
    procs = [subprocess.Popen(
        [nvcc] + NVCC_FLAGS + (["-Xptxas", "-v"] if verbose else [])
        + ["-c", "-o", str(o), str(s)], stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for s, o in zip(srcs, objs)]
    logs = [p.communicate()[0] for p in procs]
    log = "".join(logs)
    if any(p.returncode != 0 for p in procs):
        raise RuntimeError("nvcc failed:\n" + log)
    tmp = LIB_PATH.with_suffix(tag)
    link = subprocess.run([nvcc] + NVCC_FLAGS + ["-shared", "-o", str(tmp)]
                          + [str(o) for o in objs], capture_output=True,
                          text=True)
    for o in objs:
        o.unlink()
    if link.returncode != 0:
        raise RuntimeError("nvcc link failed:\n" + link.stdout + link.stderr)
    os.replace(tmp, LIB_PATH)
    return time.time() - t0, log + link.stdout + link.stderr


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first call): the tracer's span
    kernels.load, counting kernels.built when nvcc ran."""
    global _LIB
    if _LIB is None:
        with span("kernels.load"):
            if build()[0] > 0.0:
                count("kernels.built")
            _LIB = bind(ctypes.CDLL(str(LIB_PATH)))
    return _LIB


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C signatures of the entry points that lib has."""
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    i3 = ctypes.POINTER(i32)
    for name, args in (
            ("stfem_time_solve", [vp, vp, vp, vp, i32, i32, i64, i32, vp]),
            ("stfem_kron_pair", [vp] * 5 + [i64] + [i32] * 7 + [vp]),
            ("stfem_banded_apply", [vp, vp, vp, i64, i32, i64, i32, vp]),
            ("stfem_grid_chain",
             [i32] + [vp] * 5 + [i64] + [i3] * 3 + [i32] * 5 + [vp]),
            ("stfem_quad_middle_f64", [vp] * 5 + [i32] * 8 + [vp]),
            ("stfem_quad_middle_f32", [vp] * 6 + [i32] * 5 + [vp]),
            ("stfem_level_pair", [i32] + [vp] * 5 + [i64] + [i32] * 7 + [vp])):
        if hasattr(lib, name):
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, i32
    return lib


def check(code: int, name: str) -> None:
    if code != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {code}")

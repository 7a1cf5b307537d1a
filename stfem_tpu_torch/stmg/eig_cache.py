"""The smoother-estimate disk cache (counterpart of stfem_tpu/stmg/gmg.py::
_eig_cache_path / _cached_estimate).

An estimate of lambda(P A) is a pure function of the level's operator,
its Vanka smoother and the estimate's settings: the start vector is
fixed.  So it is kept on disk across processes, keyed by a SHA-256 over
those inputs, and a second build of the same hierarchy runs no estimate.
Only the levels that stfem_tpu caches are: uniform meshes (no cell mask,
axis steps, vertex map or distortion) without a coefficient.  The key
holds the device type besides stfem_tpu's inputs: float32 sweeps on the
CPU and on the card give omegas that differ in their last bits, and an
estimate taken on one must never be read on the other.  It also holds
the Vanka's storage dtype (stfem_tpu's key leaves it out).

STFEM_EIG_CACHE names the file: "0" turns the cache off, any other
value is the path, and without it the file is build/eig_cache.json in
the checkout.  The file is JSON, key -> [min, max], rewritten whole
through a temporary file and os.replace, so concurrent writers never
leave a torn file (one may drop the other's new entry; it is estimated
again).
"""
from __future__ import annotations

import hashlib
import json
import os
import pathlib
import tempfile
import warnings

import numpy as np
import torch

from ..utils.timer import count
from .smoother import EigInfo

DEFAULT_PATH = (pathlib.Path(__file__).resolve().parents[2] / "build"
                / "eig_cache.json")


def cache_path(environ=os.environ) -> str | None:
    """The cache file, or None when STFEM_EIG_CACHE is "0"."""
    p = environ.get("STFEM_EIG_CACHE")
    if p == "0":
        return None
    return p or str(DEFAULT_PATH)


def estimate_key(K, Alpha, Beta, shape, level_dtype, storage_dtype,
                 n_steps: int, n_iterations: int, safety_factor: float,
                 method: str, device) -> str | None:
    """The SHA-256 key of an estimate on the level of spatial operator K
    with the time tables (Alpha, Beta), or None if the level is not
    cacheable (a coefficient or a non-uniform mesh)."""
    mesh = K.mesh
    if K.coefficient is not None or not mesh.uniform:
        return None
    h = hashlib.sha256()
    for d in range(K.dim):
        h.update(np.asarray(mesh.axis_vertices(d), np.float64).tobytes())
    h.update(np.asarray(Alpha, np.float64).tobytes())
    h.update(np.asarray(Beta, np.float64).tobytes())
    h.update(repr((K.degree, K.n_q, float(K.laplace_scaling),
                   float(K.mass_scaling), tuple(int(s) for s in shape),
                   str(level_dtype), str(storage_dtype), int(n_steps),
                   int(n_iterations), float(safety_factor), str(method),
                   torch.device(device).type)).encode())
    return h.hexdigest()


def _read(path: str) -> dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _write(path: str, cache: dict) -> None:
    """Replace the file atomically (a temporary file in its directory,
    then os.replace)."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, prefix=".eig_cache.", suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(cache, f)
        os.replace(tmp, path)
    except BaseException:
        os.unlink(tmp)
        raise


class EstimateCache:
    """The disk cache as one hierarchy build sees it: `computed` and
    `read` count the estimates it ran and the ones it took from the
    file or from `preset`.

    preset: key -> [min, max] entries read before the file (another
    process's estimates: the sharded solve's rank 0 estimates and sends
    them to the other ranks).  `taken` records every keyed estimate this
    build used, computed or read."""

    def __init__(self, path: str | None, preset: dict | None = None):
        self.path = path
        self.preset = dict(preset or {})
        self.taken = {}
        self.computed = self.read = 0

    def estimate(self, key: str | None, compute) -> EigInfo:
        """The preset or cached EigInfo under key, else compute() (stored
        when its max eigenvalue is finite and positive)."""
        info = self._estimate(key, compute)
        if key is not None:
            self.taken[key] = [float(info.min_eigenvalue),
                               float(info.max_eigenvalue)]
        return info

    def _estimate(self, key, compute) -> EigInfo:
        """The estimate, counted for the tracer as eig_cache.hits (read)
        or eig_cache.misses (computed)."""
        if key is not None and key in self.preset:
            self.read += 1
            count("eig_cache.hits")
            lo, hi = self.preset[key]
            return EigInfo(min_eigenvalue=float(lo), max_eigenvalue=float(hi))
        if self.path is None or key is None:
            self.computed += 1
            count("eig_cache.misses")
            return compute()
        hit = _read(self.path).get(key)
        if hit is not None:
            self.read += 1
            count("eig_cache.hits")
            return EigInfo(min_eigenvalue=float(hit[0]),
                           max_eigenvalue=float(hit[1]))
        info = compute()
        self.computed += 1
        count("eig_cache.misses")
        if np.isfinite(info.max_eigenvalue) and info.max_eigenvalue > 0:
            cache = _read(self.path)
            cache[key] = [float(info.min_eigenvalue),
                          float(info.max_eigenvalue)]
            try:
                _write(self.path, cache)
            except OSError as e:    # the estimate stands; it is not kept
                warnings.warn(f"estimate cache {self.path} not written: "
                              f"{e}")
        return info

"""Load state computed elsewhere into the port's objects.

The parity tests extract numpy arrays from the JAX package's objects
(np.asarray on KronAssembled.M1/A1/Md/Ad, PreconditionVanka.Wdn/Wup/
GinvT/cvecT, StokesVanka.Binv/Kappa, the GMG level omegas, coarse_Ainv
and coarse_null) and load them here, so
that a comparison starts from identical factors and isolates the apply.
The time tables need no loader: both packages build them in NumPy, and
the tests pass the same arrays to both constructors.  Arrays are cast to
the dtype and device of the tensor they replace; bf16 arrays should be
handed over as float32 (exact).
"""
from __future__ import annotations

import numpy as np
import torch


def _like(a, ref: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(np.array(a), dtype=ref.dtype,
                           device=ref.device).contiguous()


def _load_list(dst: list, arrays) -> None:
    assert len(dst) == len(arrays)
    for i, a in enumerate(arrays):
        assert tuple(np.shape(a)) == tuple(dst[i].shape), (np.shape(a),
                                                          dst[i].shape)
        dst[i] = _like(a, dst[i])


def load_kron(kron, M1=None, A1=None, Md=None, Ad=None) -> None:
    """KronAssembled per-axis dense (M1, A1) and banded (Md, Ad) factors."""
    for name, arrays in (("M1", M1), ("A1", A1), ("Md", Md), ("Ad", Ad)):
        if arrays is not None:
            _load_list(getattr(kron, name), arrays)


def load_vanka(vanka, Wdn=None, Wup=None, GinvT=None, cvecT=None,
               TTg=None) -> None:
    """PreconditionVanka grid-mode factors."""
    if Wdn is not None:
        _load_list(vanka.Wdn, Wdn)
    if Wup is not None:
        _load_list(vanka.Wup, Wup)
    for name, a in (("GinvT", GinvT), ("cvecT", cvecT), ("TTg", TTg)):
        if a is not None:
            ref = getattr(vanka, name)
            assert ref is not None and tuple(np.shape(a)) == tuple(ref.shape)
            setattr(vanka, name, _like(a, ref))


def load_stokes_vanka(vanka, Binv=None, Kappa=None) -> None:
    """StokesVanka patch factors (per-step or dense inverse, and the step
    coupling of the per-step factorization)."""
    for name, a in (("Binv", Binv), ("Kappa", Kappa)):
        if a is not None:
            ref = getattr(vanka, name)
            assert ref is not None and tuple(np.shape(a)) == tuple(ref.shape)
            setattr(vanka, name, _like(a, ref))


def load_gmg(gmg, omegas=None, coarse_Ainv=None, coarse_null=None) -> None:
    """GMG level relaxation omegas (one per level, None for Identity
    levels and the directly solved level 0), the Direct coarse inverse or
    pseudo-inverse, and the coarse nullspace vector."""
    if omegas is not None:
        assert len(omegas) == len(gmg.levels)
        for lvl, om in zip(gmg.levels, omegas):
            if om is not None:
                lvl.smoother.omega = float(om)
    if coarse_Ainv is not None:
        gmg.coarse_Ainv = _like(coarse_Ainv, gmg.coarse_Ainv)
    if coarse_null is not None:
        assert gmg.coarse_null is not None
        gmg.coarse_null = _like(coarse_null, gmg.coarse_null)

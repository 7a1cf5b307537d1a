"""Load state computed elsewhere into the port's objects.

The parity tests extract numpy arrays from the JAX package's objects
(np.asarray on KronAssembled.M1/A1/Md/Ad, PreconditionVanka.Wdn/Wup/
GinvT/cvecT or, in the cell-local mode, V/Ginv/cvec/TTinv/dinv,
StokesVanka.Binv/Kappa, LaplaceMassOperator.coeff, SystemMatrix._phig/_w,
GridSumFac.Wa/Wb, the GMG level omegas, coarse_Ainv and coarse_null, an
operator's geometry jxw/jinv/jinv_axis) and load them here, so that a
comparison starts from identical factors and isolates the apply.
Layouts that differ are converted here.
The time tables need no loader: both packages build them in NumPy, and
the tests pass the same arrays to both constructors.  Arrays are cast to
the dtype and device of the tensor they replace; bf16 arrays should be
handed over as float32 (exact).
"""
from __future__ import annotations

import dataclasses

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
    """PreconditionVanka grid-mode factors.  Wdn / Wup must keep the
    cell-blocked pattern that K4 relies on (checked here; ValueError)."""
    if Wdn is not None:
        _load_list(vanka.Wdn, Wdn)
    if Wup is not None:
        _load_list(vanka.Wup, Wup)
    if Wdn is not None or Wup is not None:
        vanka.check_blocks()
    for name, a in (("GinvT", GinvT), ("cvecT", cvecT), ("TTg", TTg)):
        if a is not None:
            ref = getattr(vanka, name)
            assert ref is not None and tuple(np.shape(a)) == tuple(ref.shape)
            setattr(vanka, name, _like(a, ref))


def load_vanka_cell(vanka, V=None, Ginv=None, cvec=None, TTinv=None,
                    dinv=None) -> None:
    """Cell-local PreconditionVanka factors in stfem_tpu's layouts: V (C,
    A, A), Ginv (C, A, nt, nt) and cvec (C, A, nt) of the multi-step
    factorization or TTinv (C, A, T, T) of the single-step one, and dinv
    as (T, C, A) or (C, T*A)."""
    assert vanka.mode == "cell"
    C, A = vanka.V.shape[0], vanka.V.shape[1]
    N, nb = C * A, vanka.n_blocks
    if V is not None:
        assert tuple(np.shape(V)) == tuple(vanka.V.shape)
        vanka.V = _like(V, vanka.V)
    if Ginv is not None:
        g = np.asarray(Ginv).reshape(N, *np.shape(Ginv)[2:])
        vanka.GinvT = _like(np.transpose(g, (1, 2, 0)), vanka.GinvT)
    if cvec is not None:
        vanka.cvecT = _like(np.asarray(cvec).reshape(N, -1).T, vanka.cvecT)
    if TTinv is not None:
        t = np.asarray(TTinv).reshape(N, nb, nb)
        vanka.TTg = _like(np.transpose(t, (1, 2, 0)), vanka.TTg)
    if dinv is not None:
        d = np.asarray(dinv)
        if d.shape == (C, nb * A):
            d = d.reshape(C, nb, A).transpose(1, 0, 2)
        vanka.dinv = _like(d.reshape(nb, C, A), vanka.dinv)


def load_coefficient(op, coeff) -> None:
    """A LaplaceMassOperator's coefficient table [*cells, *q] (and the
    folded weights it feeds)."""
    op.coeff_np = np.asarray(coeff, np.float64)
    op.coeff = _like(coeff, op.coeff)
    op.w = op.jxw * op.coeff


def load_quad_tables(matrix, PhiG=None, W=None) -> None:
    """Route "quad" tables of a SystemMatrix: PhiG (A, (1+dim)Q) and W (C,
    (1+dim)Q)."""
    assert matrix.route == "quad"
    if PhiG is not None:
        matrix._phig = _like(PhiG, matrix._phig)
        matrix._phigT = _like(np.asarray(PhiG).T, matrix._phigT)
    if W is not None:
        matrix._w = _like(W, matrix._w)


def load_gridsumfac(matrix, Wb=None, Wa=None) -> None:
    """Route "grid" weights of a SystemMatrix: the mass grid Wb and the
    per-direction gradient grids Wa, on the interleaved quadrature grid."""
    assert matrix.route == "grid"
    if Wb is not None:
        matrix._grid.Wb = _like(Wb, matrix._grid.Wb)
    if Wa is not None:
        _load_list(matrix._grid.Wa, Wa)


def load_stokes_vanka(vanka, Binv=None, Kappa=None) -> None:
    """StokesVanka patch factors (per-step or dense inverse, and the step
    coupling of the per-step factorization), with Nitsche faces and the
    weak obstacle as well: both packages keep the same patch layout and
    zero a weak-obstacle level's removed-cell factors."""
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


def load_geometry(op, jxw=None, jinv=None, jinv_axis=None) -> None:
    """A LaplaceMassOperator's or StokesOperator's geometry arrays in
    stfem_tpu's Geometry layouts -- jxw, jinv [*cells, *q, dim, dim] of a
    mapped mesh, jinv_axis (one (cells[d],) array per axis) of a
    non-uniform one -- and every table the operator derives from them, so
    that an apply starts with the map Jacobians of stfem_tpu."""
    new = {}
    for name, a in (("jxw", jxw), ("jinv", jinv)):
        if a is not None:
            ref = getattr(op.geom, name)
            assert ref is not None and np.shape(a) == np.shape(ref), name
            new[name] = np.array(a, np.float64)
    if jinv_axis is not None:
        ref = op.geom.jinv_axis
        assert ref is not None and [np.shape(a) for a in jinv_axis] == [
            np.shape(a) for a in ref]
        new["jinv_axis"] = tuple(np.array(a, np.float64) for a in jinv_axis)
    op._set_geometry(dataclasses.replace(op.geom, **new))

"""The Stokes hierarchy with the solver options of the Chebyshev configs,
on the CPU against stfem_tpu (2D Q2 x DGP1, dG(1), float32 levels,
smoothing range 5):

- the weak lid-driven cavity at refinement 2 (2 slabs) through both
  run_configs with "smoother" chebyshev and "smoothingSteps" 2: FGMRES
  iterations within 1, u and p within 1e-8 of their largest entry;
- a GMRES coarse solve on the enclosed flow's levels (2 x 2 cells at
  refinement 2, the routing to the pseudo-inverse switched off by
  GMG.DIRECT_COARSE_MAX = 0 in both packages): the port's coarse solve, with
  stfem_tpu's level-0 Vanka factors and (theta, delta) carried across,
  within 1e-6 relative of stfem_tpu's; each package's own level
  parameters within 1e-5;
- the routing rule: a coarse level of at most GMG.DIRECT_COARSE_MAX
  unknowns goes to the FP64 pseudo-inverse whatever the config asks."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.stmg.gmg import GMG as JGMG
from stfem_tpu.stmg.gmg import GMGParams as JParams
from stfem_tpu.stmg.gmg import build_stmg_stokes as jbuild
from stfem_tpu.types import SupportedSmoothers as JSmoothers
from stfem_tpu.types import TimeStepType as JT
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.stmg.gmg import GMG, GMGParams, build_stmg_stokes
from stfem_tpu_torch.types import SupportedSmoothers, TimeStepType
from stfem_tpu_torch.utils.carry import load_stokes_vanka
from test_torch_tp03stokes import LID, _both, _zeroed_fgmres, jstokes

torch.set_num_threads(1)
TAU = 1 / 16


def test_lid_chebyshev_parity(tmp_path):
    cfg = dict(LID, smoother="chebyshev", smoothingSteps=2)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jstokes, "fgmres", _zeroed_fgmres)
        _, (j,), _, (t,) = _both(tmp_path, cfg, (jstokes, "run_lid_driven"),
                                 n_slabs_max=2)
    assert len(t["iterations"]) == 2
    assert all(abs(a - b) <= 1 for a, b in zip(t["iterations"],
                                               j["iterations"]))
    for n in ("u", "p"):
        np.testing.assert_allclose(t[n], j[n], rtol=0,
                                   atol=1e-8 * np.abs(j[n]).max())


def _build(**kw):
    jm = JMesh([2, 2], [0.0, 0.0], [1.0, 1.0], refinement=2)
    tm = StructuredMesh([2, 2], [0.0, 0.0], [1.0, 1.0], refinement=2)
    jg = jbuild(jm, 1, JT.DG, 1, TAU, dtype=jnp.float32, fe_degree_min=1,
                params=JParams(smoother=JSmoothers.Chebyshev, **kw))
    tg = build_stmg_stokes(tm, 1, TimeStepType.DG, 1, TAU,
                           params=GMGParams(
                               smoother=SupportedSmoothers.Chebyshev, **kw),
                           device="cpu")
    return jg, tg


def test_gmres_coarse_solve(monkeypatch):
    monkeypatch.setattr(GMG, "DIRECT_COARSE_MAX", 0)
    monkeypatch.setattr(JGMG, "DIRECT_COARSE_MAX", 0)
    jg, tg = _build(smoothing_steps=2, smoothing_range=5.0,
                    coarse_grid_smoother_type="GMRES")
    assert tg.coarse == "GMRES" and jg.coarse_Ainv is None
    assert tg.coarse_null is not None
    for jl, tl in zip(jg.levels, tg.levels):
        js, ts = jl.smoother, tl.smoother
        assert type(js).__name__ == type(ts).__name__
        if hasattr(ts, "theta"):
            assert ts.degree == js.degree == 2
            assert ts.theta == pytest.approx(js.theta, rel=1e-5)
            assert ts.delta == pytest.approx(js.delta, rel=1e-5)
    j0, t0 = jg.levels[0], tg.levels[0]
    kappa = j0.smoother.precond.Kappa
    load_stokes_vanka(t0.smoother.precond,
                      np.asarray(j0.smoother.precond.Binv),
                      None if kappa is None else np.asarray(kappa))
    t0.smoother.theta, t0.smoother.delta = (j0.smoother.theta,
                                            j0.smoother.delta)
    S = t0.matrix.S
    mask = np.concatenate([np.tile(S.mask_u_np.reshape(-1), S.dim),
                           np.ones(S.n_p)])
    d = (np.random.default_rng(4).standard_normal((t0.n_blocks,)
                                                  + t0.dof_shape)
         * mask).astype(np.float32)
    ref = np.asarray(jg._coarse_solve(jnp.asarray(d)), np.float64)
    got = tg._coarse_solve(torch.as_tensor(d)).double().numpy()
    assert np.all(np.isfinite(got))
    assert np.abs(got - ref).max() <= 1e-6 * np.abs(ref).max()


def test_routing_to_pinv():
    """The 2 x 2-cell coarse level is solved by the FP64 pseudo-inverse
    though GMRES is asked for, in both packages."""
    jg, tg = _build(smoothing_steps=2, relaxation=0.6,
                    coarse_grid_smoother_type="GMRES")
    lvl0 = tg.levels[0]
    n0 = lvl0.n_blocks * int(np.prod(lvl0.dof_shape))
    assert n0 <= GMG.DIRECT_COARSE_MAX
    assert tg.coarse == "Direct" and tg.coarse_Ainv is not None
    assert jg.params.coarse_grid_smoother_type == "Direct"
    assert jg.params.coarse_direct_pinv
    np.testing.assert_allclose(tg.coarse_Ainv.numpy(),
                               np.asarray(jg.coarse_Ainv), rtol=0,
                               atol=1e-5 * np.abs(jg.coarse_Ainv).max())

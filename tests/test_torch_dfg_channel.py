"""The DFG channel end to end in stfem_tpu_torch against stfem_tpu (CPU):
the Stokes STMG hierarchy on the dfgBenchmarkSquare grid (free outflow:
no coarse nullspace), run_dfg_square on the square and the cylinder, and
the tp_03stokes entry point with the committed DFG config.  Both
packages run the float32 V-cycle of GMGParams' defaults with smoothing
range 5, fe_degree_min 1, space_and_time coarsening (tests/
test_stokes.py:228-262's factory), 2D Q2 x DGP1, dG(1), tau = 1/16,
U_mean 1, DFG 2D-3 inflow, FGMRES to rel 1e-12.

Tolerances: the level ladder and the masks per level exact; the float32
power-estimate omegas 2e-5 relative (on the finest level of this ladder
the 20-step float32 estimate is rounding-bound: stfem_tpu's own float32
and float64 estimates differ by 8.8e-6 there, the two packages' float32
ones by 1.08e-5); one float32 V-cycle from stfem_tpu's
omegas and coarse inverse 1e-5 of the largest entry; the channel's FGMRES
iterations equal per slab, u and p within 1e-8 of their largest entry
(exact zeros where stfem_tpu has them), drag, lift and divergence norm
1e-8 relative."""
import io

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu import types as jtypes
from stfem_tpu.drivers import stokes as jstokes
from stfem_tpu.stmg.gmg import GMGParams as JParams
from stfem_tpu.stmg.gmg import build_stmg_stokes as jbuild
from stfem_tpu_torch import config as tconfig
from stfem_tpu_torch import types as ttypes
from stfem_tpu_torch.drivers import stokes as tstokes
from stfem_tpu_torch.drivers import tp03stokes as tp
from stfem_tpu_torch.stmg.gmg import GMGParams, build_stmg_stokes
from stfem_tpu_torch.stmg.smoother import IdentitySmoother
from stfem_tpu_torch.utils.carry import load_gmg

torch.set_num_threads(1)

WEAK, FREE = ((0, 0), (1, 0), (1, 1)), ((0, 1),)
NU, TAU = 1e-3, 1.0 / 16.0


def _rel_close(t, j, rel):
    t = np.asarray(t.detach() if torch.is_tensor(t) else t, np.float64)
    j = np.asarray(j, np.float64)
    assert t.shape == j.shape, (t.shape, j.shape)
    np.testing.assert_allclose(t, j, rtol=0, atol=rel * np.abs(j).max())


@pytest.fixture(scope="module")
def hierarchies():
    """Both packages' hierarchies on the square at refinement 2 (one step
    per slab, as the channel runs)."""
    jg = jbuild(jstokes.dfg_square_mesh(2), 1, jtypes.TimeStepType.DG, 1,
                TAU, viscosity=NU, params=JParams(smoothing_range=5.0),
                fe_degree_min=1, space_time_level_first=False,
                weak_faces=WEAK, free_faces=FREE)
    tg = build_stmg_stokes(tstokes.dfg_square_mesh(2), 1,
                           ttypes.TimeStepType.DG, 1, TAU, viscosity=NU,
                           params=GMGParams(smoothing_range=5.0),
                           fe_degree_min=1, weak_faces=WEAK,
                           free_faces=FREE, device="cpu")
    return jg, tg


def test_hierarchy_ladder_and_masks(hierarchies):
    jg, tg = hierarchies
    assert [m.name for m in tg.mg_type_level] == \
        [m.name for m in jg.mg_type_level]
    assert len(tg.levels) == len(jg.levels)
    for jl, tl in zip(jg.levels, tg.levels):
        jS, tS = jl.matrix.S, tl.matrix.S
        assert tS.cells == jS.cells and tS.u_degree == jS.u_degree
        np.testing.assert_array_equal(tS.mesh.cell_mask, jS.mesh.cell_mask)
        np.testing.assert_array_equal(tS.mask_u_np, jS.mask_u_np)
        assert tl.n_blocks == jl.n_blocks
    # a do-nothing outflow determines the pressure: nothing projected,
    # the coarse level solved by the pseudo-inverse
    assert tg.coarse_null is None and jg.coarse_null is None
    assert tg.coarse == "Direct" and jg.params.coarse_direct_pinv


def test_hierarchy_omegas(hierarchies):
    jg, tg = hierarchies
    n = 0
    for l, (jl, tl) in enumerate(zip(jg.levels, tg.levels)):
        if l == 0 or isinstance(tl.smoother, IdentitySmoother):
            continue
        jo, to = float(jl.smoother.omega), float(tl.smoother.omega)
        assert abs(to - jo) <= 2e-5 * abs(jo), (l, to, jo)
        n += 1
    assert n


def test_vcycle_with_jax_omegas(hierarchies):
    jg, tg = hierarchies
    omegas = [None if l == 0 or isinstance(tl.smoother, IdentitySmoother)
              else float(jl.smoother.omega)
              for l, (jl, tl) in enumerate(zip(jg.levels, tg.levels))]
    load_gmg(tg, omegas, np.asarray(jg.coarse_Ainv))
    top = tg.levels[-1]
    x = np.random.default_rng(9).standard_normal((top.n_blocks,)
                                                 + top.dof_shape)
    _rel_close(tg.vmult(torch.as_tensor(x, dtype=torch.float32)),
               jax.jit(jg.vmult)(jnp.asarray(x, jnp.float32)), 1e-5)


def _jfactory(ctx):
    return jbuild(ctx["mesh"], ctx["fe_degree"], ctx["type_"], 1,
                  ctx["time_step"], viscosity=ctx["viscosity"],
                  params=JParams(smoothing_range=5.0), fe_degree_min=1,
                  space_time_level_first=False, weak_faces=ctx["weak_faces"],
                  free_faces=ctx["free_faces"])


def _tfactory(ctx):
    return build_stmg_stokes(ctx["mesh"], ctx["fe_degree"], ctx["type_"], 1,
                             ctx["time_step"], viscosity=ctx["viscosity"],
                             params=GMGParams(smoothing_range=5.0),
                             fe_degree_min=1, weak_faces=ctx["weak_faces"],
                             free_faces=ctx["free_faces"],
                             device=ctx["device"])


KW = dict(refinement=1, n_slabs=2, u_mean=1.0, dfg_benchmark=3,
          rel_tol=1e-12, gmres_maxiter=150)


@pytest.fixture(scope="module")
def jax_runs():
    """stfem_tpu's channel, 2 slabs at refinement 1, square and
    cylinder."""
    return {cyl: jstokes.run_dfg_square(preconditioner_factory=_jfactory,
                                        cylinder=cyl, **KW)
            for cyl in (False, True)}


@pytest.mark.parametrize("cylinder", [False, True],
                         ids=["square", "cylinder"])
def test_run_dfg_square(cylinder, jax_runs):
    j = jax_runs[cylinder]
    t = tstokes.run_dfg_square(preconditioner_factory=_tfactory,
                               device="cpu", cylinder=cylinder, **KW)
    assert t["iterations"] == j["iterations"]
    assert t["time"] == pytest.approx(j["time"])
    for name in ("u", "p"):
        _rel_close(t[name], j[name], 1e-8)
        np.testing.assert_array_equal(t[name][j[name] == 0.0], 0.0)
    np.testing.assert_allclose(t["drag_lift"], np.asarray(j["drag_lift"]),
                               rtol=1e-8)
    np.testing.assert_allclose(t["divergence"], j["divergence"], rtol=1e-8)
    assert t["n_dofs"] == 2 * 37 * 13 + 3 * 18 * 6


def test_entry_point_dfg_config(jax_runs):
    """The committed config through tp03stokes.run_config, cut to
    refinement 1 and one slab, on the CPU: stfem_tpu's first slab's
    iterations in the iterations line; gridDescriptor dfgBenchmark runs
    the cylinder."""
    p = tconfig.Parameters.parse(str(tp.DFG_2D), 2)
    extra = tp.parse_stokes_extra(str(tp.CONFIGS / p.additional_file))
    assert (p.refinement, p.grid_descriptor, extra.dfg_benchmark,
            extra.u_mean, extra.viscosity) == (5, "dfgBenchmarkSquare", 3,
                                               1.0, 1e-3)
    p.refinement = 1
    for grid, cyl in (("dfgBenchmarkSquare", False), ("dfgBenchmark", True)):
        p.grid_descriptor = grid
        out = io.StringIO()
        res = tp.run_config(p, extra, out=out, n_slabs_max=1, device="cpu")
        r = res[(1, 1)]
        assert r["iterations"] == jax_runs[cyl]["iterations"][:1]
        assert (r["mesh"].vertex_map is not None) == cyl
        it = r["iterations"][0]
        assert f"Average GMRES iterations {it:g} ({it} gmres_iterations " \
               f"/ 1 timesteps)" in out.getvalue()

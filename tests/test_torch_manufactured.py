"""The symbolically derived manufactured solutions of stfem_tpu_torch
(problems/manufactured.py: heat "solution 2" in 2D and 3D, stokespoly)
against stfem_tpu's on the same seeded points, 1e-13 of the largest
value (in fact bitwise on this CPU: the same sympy expressions, whole
powers in XLA's order), and tests/test_manufactured.py's consistency
checks on the port: the rhs against finite differences of the solution,
stokespoly divergence-free and zero on the boundary; also a batched time
axis and an expression constant in space broadcast to the points."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu.problems import manufactured as jman
from stfem_tpu_torch.problems.manufactured import heat2, stokes_poly

F64 = torch.float64


def _close(got, ref, rel=1e-13):
    got, ref = got.numpy(), np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.mark.parametrize("dim", [2, 3])
def test_heat2_against_stfem_tpu(dim):
    x = np.random.default_rng(dim).uniform(0.25, 1.25, (6, 5, dim))
    for t in (0.0, 0.37, 1.0):
        for got, ref in zip(heat2(dim), jman.heat2(dim)):
            _close(got(torch.as_tensor(x), t), ref(jnp.asarray(x), t))


def test_stokes_poly_against_stfem_tpu():
    x = np.random.default_rng(7).uniform(0.0, 1.0, (6, 5, 2))
    port, ref = stokes_poly(1.0), jman.stokes_poly(1.0)
    assert set(port) == set(ref)
    for t in (0.0, 0.8):
        for name in ref:
            _close(port[name](torch.as_tensor(x), t),
                   ref[name](jnp.asarray(x), t))


def test_batched_time_and_constant_broadcast():
    """A time axis that broadcasts against the points (the batched force
    assembly) gives each time's values; stokespoly's pressure gradient
    along x is constant in x at y = 0.5 and still takes the points'
    shape."""
    x = torch.as_tensor(np.random.default_rng(3).uniform(0.0, 1.0,
                                                         (4, 3, 2)))
    ts = torch.tensor([0.1, 0.5], dtype=F64).reshape(2, 1, 1)
    exact, grad, rhs = heat2(2)
    for fn in (exact, rhs):
        batched = fn(x, ts)
        assert batched.shape == (2, 4, 3)
        for i, t in enumerate((0.1, 0.5)):
            torch.testing.assert_close(batched[i], fn(x, t), rtol=0, atol=0)
    assert grad(x, ts).shape == (2, 4, 3, 2)
    pts = x.clone()
    pts[..., 1] = 0.5
    dp = stokes_poly(1.0)["exact_grad_p"](pts, 0.3)
    assert dp.shape == (4, 3, 2)
    # p = t (-16 x (1-x) y (1-y) + 4/9): dp/dx = -16 t (1 - 2x) y (1 - y)
    torch.testing.assert_close(dp[..., 0], -16 * 0.3 * (1 - 2 * pts[..., 0])
                               * 0.25, rtol=1e-14, atol=1e-14)


def test_heat2_rhs_consistency():
    """tests/test_manufactured.py:9-22 on the port: f = u_t - lap u."""
    exact, _, rhs = heat2(2)
    x = torch.tensor([[0.3, 0.4]], dtype=F64)
    t, h = 0.37, 1e-5
    ut = (exact(x, t + h) - exact(x, t - h)) / (2 * h)
    lap = 0.0
    for d in range(2):
        e = torch.zeros((1, 2), dtype=F64)
        e[0, d] = h
        lap = lap + (exact(x + e, t) - 2 * exact(x, t)
                     + exact(x - e, t)) / h ** 2
    np.testing.assert_allclose(float(rhs(x, t)[0]), float(ut[0] - lap[0]),
                               rtol=1e-4)


def test_stokespoly_consistency():
    """tests/test_manufactured.py:25-53 on the port: divergence-free, zero
    on the boundary, and the momentum residual by finite differences."""
    sp = stokes_poly(1.0)
    x = torch.tensor([[0.3, 0.6]], dtype=F64)
    t = 0.8
    g = sp["exact_grad_u"](x, t)
    assert abs(float(g[0, 0, 0] + g[0, 1, 1])) <= 1e-10
    for pt in ([0.0, 0.5], [1.0, 0.5], [0.5, 0.0], [0.5, 1.0]):
        ub = sp["exact_u"](torch.tensor([pt], dtype=F64), t)
        assert float(ub.abs().max()) <= 1e-12
    h = 1e-4
    ut = (sp["exact_u"](x, t + h) - sp["exact_u"](x, t - h)) / (2 * h)
    lap = 0.0
    for d in range(2):
        e = torch.zeros((1, 2), dtype=F64)
        e[0, d] = h
        lap = lap + (sp["exact_u"](x + e, t) - 2 * sp["exact_u"](x, t)
                     + sp["exact_u"](x - e, t)) / h ** 2
    gp = sp["exact_grad_p"](x, t)
    np.testing.assert_allclose(sp["rhs_u"](x, t).numpy(),
                               (ut - lap + gp).numpy(), rtol=2e-3)

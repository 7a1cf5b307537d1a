"""The reference against a dense assembly of the same slab, its 1D
building blocks against hand values, and against the program's own FP64
residual at a tiny size."""
import numpy as np
import pytest
import torch

from benchmark import data as slab_data
from benchmark.reference import fe
from benchmark.reference.heat_slab import HeatSlabReference


def test_points_and_tables():
    assert np.allclose(fe.gauss_lobatto_points(3), [0.0, 0.5, 1.0])
    assert np.allclose(fe.radau_right_points(2), [1.0 / 3.0, 1.0])
    g = fe.DGTime(0)           # dG(0): implicit Euler
    assert np.allclose([g.mass, g.der_jump, g.coupling], 1.0)
    g = fe.DGTime(2)
    assert np.isclose(g.nodes[-1], 1.0) and np.isclose(g.weights.sum(), 1.0)
    # mass is diagonal on the Radau nodes (the 3-point rule is exact)
    assert np.allclose(g.mass, np.diag(g.weights), atol=1e-15)
    # der_jump annihilates constants up to the jump: D 1 = phi(0)
    assert np.allclose(g.der_jump @ np.ones(3), g.start)


def test_fe_matrices_1d():
    M, K = fe.fe_matrices_1d(4, 3, 2.0)
    ones = np.ones(M.shape[0])
    assert np.isclose(ones @ M @ ones, 2.0)          # the length
    assert np.allclose(K @ ones, 0.0, atol=1e-12)    # constants
    x = fe.node_coordinates_1d(4, 3, 0.0, 2.0)
    assert np.isclose(x @ K @ x, 2.0)                # int (x')^2 = 2


def _dense(ref: HeatSlabReference):
    """The slab matrix of the free dofs and the end-value coupling, from
    numpy Kronecker products."""
    M = [m.numpy() for m in ref.M1]
    K = [k.numpy() for k in ref.K1]
    kron = lambda a, b, c: np.kron(np.kron(a, b), c)
    M3 = kron(*M)
    K3 = (kron(K[0], M[1], M[2]) + kron(M[0], K[1], M[2])
          + kron(M[0], M[1], K[2])) * ref.coefficient
    t, S = ref.time, ref.n_steps
    nt = ref.r + 1
    At, Bt = np.zeros((S * nt,) * 2), np.zeros((S * nt,) * 2)
    for s in range(S):
        b = slice(s * nt, (s + 1) * nt)
        At[b, b] = ref.tau * t.mass
        Bt[b, b] = t.der_jump
        if s:
            At_c = slice((s - 1) * nt, s * nt)
            Bt[b, At_c] = -t.coupling
    P = np.diag(ref.mask.numpy().reshape(-1))
    A = np.kron(At, P @ K3 @ P) + np.kron(Bt, P @ M3 @ P)
    return A, P @ M3 @ P


def test_slab_against_dense_assembly():
    ref = HeatSlabReference([2, 3, 2], [0, 0, 0], [1.0, 1.5, 0.5], k=2,
                            n_q=3, r=1, tau=0.1, n_steps=3,
                            coefficient=0.7, chunk_bytes=1.0)
    assert ref.chunk == 1            # one step a chunk: the carry is tested
    A, MP = _dense(ref)
    g = np.random.default_rng(3)
    x = g.standard_normal((6,) + ref.space_shape)
    u = g.standard_normal(ref.space_shape)
    forcing = slab_data.Modes(np.array([1.5, -0.5]),
                              np.array([[1, 2, 1], [2, 1, 3]]),
                              np.array([0.2, -0.1]), np.array([0.7, 1.3]),
                              np.array([0.3, 2.0]))
    out = ref.residual(torch.as_tensor(x), torch.as_tensor(u), forcing,
                       t0=0.4, keep=True)
    # the load: each block's time point, (f, phi) by the 1D loads
    F = np.zeros_like(x)
    loads = ref._space_loads(forcing).numpy()
    for s in range(3):
        for i in range(2):
            tt = 0.4 + 0.1 * (s + ref.time.nodes[i])
            F[2 * s + i] = 0.1 * ref.time.weights[i] * np.tensordot(
                forcing.time_factors(np.array([tt]))[0], loads, 1)
    rhs = F.reshape(6, -1) @ np.eye(F[0].size)
    rhs[:2] += np.outer(ref.time.start, MP @ u.reshape(-1))
    rhs = rhs * ref.mask.numpy().reshape(1, -1)
    r = rhs.reshape(-1) - A @ x.reshape(-1)
    scale = np.abs(r).max()
    assert np.abs(out["r"].numpy().reshape(-1) - r).max() <= 1e-12 * scale
    assert np.abs(out["rhs"].numpy().reshape(-1)
                  - rhs.reshape(-1)).max() <= 1e-12 * np.abs(rhs).max()
    assert np.isclose(out["rel"], np.linalg.norm(r) / np.linalg.norm(rhs),
                      rtol=1e-12)


def test_against_the_programs_residual(tiny_root):
    """Independent formulas, one answer: the reference's norms equal the
    program's SlabResidual64 on an arbitrary slab vector."""
    from benchmark import spec
    from benchmark.marches.heat import March, Program, reference_for
    from benchmark.tests.conftest import TINY_CELL

    c = spec.cell(spec.load_benchmark(tiny_root), TINY_CELL, tiny_root)
    cfg = c["config"]
    p = Program(cfg, "cpu")
    d = slab_data.make(2 ** 31 + 11, c["traffic"], p.slab_duration)
    m = March(p, d)
    ref = reference_for(cfg, "cpu")
    g = torch.Generator().manual_seed(1)
    x = torch.randn(p.shape, generator=g, dtype=torch.float64)
    u = torch.randn(p.shape[1:], generator=g, dtype=torch.float64)
    for index in (0, 5):
        _, rn, bn = p.resid.residual(u, x, m.slab_force(index))
        out = ref.residual(x, u, d.forcing, index * p.slab_duration)
        assert out["r_norm"] == pytest.approx(float(rn), rel=1e-12)
        assert out["rhs_norm"] == pytest.approx(float(bn), rel=1e-12)

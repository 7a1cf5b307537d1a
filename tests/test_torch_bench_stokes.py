"""stfem_tpu_torch.bench_stokes end to end on the CPU at a small size: 4^3
cells, 4 steps per slab, 3 slabs (the plain versions of the kernels).
Every slab must reach a TRUE FP64 relative residual <= 1e-8, the probe
floor must sit in (1e-9, 1e-3) (the float32 first solve stalls there),
and the carried block must be finite with zero mean pressure (1e-12,
FP64 rounding of a 64-cell sum)."""
import numpy as np
import pytest
import torch

from stfem_tpu_torch import bench_stokes
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.stokes import StokesOperator

torch.set_num_threads(1)

CELLS, NTAO = 4, 4


@pytest.fixture(scope="module")
def bench_run():
    return bench_stokes.run(CELLS, NTAO, n_slabs=3, device="cpu")


def test_bench_stokes_small_cpu(bench_run):
    info, x = bench_run
    assert info["converged"] and len(info["true_rels"]) == 3
    assert all(r <= 1e-8 for r in info["true_rels"])
    assert 1e-9 < info["probe_floor"] < 1e-3
    assert info["u_dofs"] == 3 * 9 ** 3 and info["p_dofs"] == 4 * 64
    assert x.shape == (2 * NTAO, info["u_dofs"] + info["p_dofs"])
    assert x.dtype == torch.float64 and bool(torch.isfinite(x).all())
    assert abs(info["carry_p_mean"]) <= 1e-12
    assert all(0 < it <= 2 * bench_stokes.MAXITER for it in info["iters"])
    m = bench_stokes.metric_line(info)
    assert m["metric"] == bench_stokes.METRIC and m["value"] > 0


def test_mean_normalize_removes_block_means():
    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
    S = StokesOperator(mesh, 2, 1, 3, dtype=torch.float64, device="cpu")
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (3, S.n_u + S.n_p)))
    detj = float(np.prod(mesh.h))
    y = bench_stokes.mean_normalize(S, x)
    u0, p0 = S.unpack(x)
    u1, p1 = S.unpack(y)
    assert torch.equal(u0, u1) and torch.equal(p0[..., 1:], p1[..., 1:])
    means = p1[..., 0].sum(dim=(1, 2, 3)) * detj
    assert float(means.abs().max()) <= 1e-14
    assert float(bench_stokes.pressure_means(S, y).abs().max()) <= 1e-14
    shift = (p0[..., 0] - p1[..., 0]).reshape(3, -1)
    assert torch.allclose(shift, shift[:, :1].expand_as(shift), atol=0)


def test_bench_stokes_needs_two_probe_slabs():
    """A run of one slab probes slab 0 alone: bench.py probes slab 1 only
    when the run has one (bench.py:351-369)."""
    info, _ = bench_stokes.run(CELLS, NTAO, n_slabs=1, device="cpu")
    assert len(info["probe_floors"]) == 1 and info["converged"]
    assert info["true_rels"][0] <= 1e-8


def test_profile_slab_counts_ops_cpu():
    """The profile summary of the benches' --profile slab, read from the
    raw trace: op call counts, no device events on the CPU."""
    from stfem_tpu_torch.bench_heat import profile_slab
    x = torch.ones((8, 8))

    def fn():
        for _ in range(7):
            torch.mm(x, x)
        for _ in range(3):
            x.add_(0.0)

    prof = profile_slab(fn, torch.device("cpu"), top=50)
    calls = {name: n for name, n, _ in prof["top_ops_ms"]}
    assert calls["aten::mm"] == 7 and calls["aten::add_"] == 3
    assert prof["n_kernel_launches"] == 0 and prof["device_busy_s"] == 0.0
    assert prof["top_kernels_ms"] == []
    assert prof["wall_s"] > 0 and prof["summary_s"] >= 0

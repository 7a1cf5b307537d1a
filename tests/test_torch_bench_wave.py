"""bench_wave's whole route on the CPU at 4^3 cells, Q4 x dG(2), 4 steps
per slab (bf16 levels, as the bench runs): probe, first solve, FP64
residual, IR pass(es), v-recovery, untimed TRUE check.  It imports no
stfem_tpu: the route is held to the TRUE residual, the dense f64 v oracle
and the exact solution."""
import numpy as np
import pytest
import torch

from stfem_tpu_torch import bench_wave
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.problems import heat

torch.set_num_threads(1)

CELLS, NTAO = 4, 4


@pytest.fixture(autouse=True, scope="module")
def _no_estimate_cache():
    """The port's hierarchies estimate afresh: no estimate disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        yield


def test_bench_route_true_1e8_and_v_oracle():
    """bench_wave's route on the CPU: probe, first solve, FP64 residual,
    IR pass(es), v-recovery; every slab's untimed TRUE residual <= 1e-8,
    the probe's FP64 v within 1e-9 of the dense f64 oracle, and u close to
    the exact solution at the end of the last slab."""
    info, x = bench_wave.run(CELLS, NTAO, n_slabs=3, device="cpu")
    assert info["converged"], info["true_rels"]
    assert all(r <= 1e-8 for r in info["true_rels"]), info["true_rels"]
    assert info["v_oracle_rel"] < 1e-9
    assert 1e-8 < info["probe_floor"] < 1e-3 and info["n_corr"] == 1
    assert all(3 <= it <= 60 for it in info["iters"]), info["iters"]
    assert x.dtype == torch.float64 and torch.isfinite(x).all()
    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
    exact = heat.exact_solution(torch.as_tensor(
        mesh.dof_coordinates(4), dtype=torch.float64), 3 * NTAO / 16.0)
    err = float((x[-1] - exact).norm() / exact.norm())
    assert np.isfinite(err) and err <= 1e-2, err

"""The heat slice at 4^3 cells with bench.py's bf16 levels (level_bf16 and
vanka_bf16), stfem_tpu_torch vs stfem_tpu, and bench_heat's whole route on
the CPU.  Helpers, sizes and tolerances are those of
test_torch_heat_slice.py; the Richardson counts may differ by one here,
because the two packages' bf16 roundings differ."""
import pytest
import torch

from stfem_tpu_torch import bench_heat
from test_torch_heat_slice import (CELLS, NTAO, PROXY, build_slice,
                                   check_ladder, check_omega_own_build,
                                   check_richardson_iterations)


@pytest.fixture(autouse=True, scope="module")
def _no_estimate_cache():
    """The port's hierarchies estimate afresh: no estimate disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        yield


@pytest.fixture(scope="module")
def slice_setup():
    return build_slice(True)


def test_level_ladder(slice_setup):
    check_ladder(*slice_setup[:2], bf16=True)


def test_relaxation_omega_own_build(slice_setup):
    check_omega_own_build(*slice_setup[:2], tol=5e-3)


def test_richardson_iterations(slice_setup):
    """Each package's own build: preconditioned-Richardson counts within
    +-1 with the bench's bf16 levels."""
    check_richardson_iterations(*slice_setup, slack=1)


def test_ir_pass_reaches_true_1e8():
    """bench_heat's route on the CPU: probe, first solve, FP64 residual,
    one correction, FP64 update; every slab's untimed TRUE residual <=
    1e-8 and the solution close to the exact one."""
    info, x = bench_heat.run(CELLS, NTAO, n_slabs=2, device="cpu",
                             eig_proxy_cells=PROXY)
    assert info["converged"] and info["outer"] == "richardson"
    assert all(r <= 1e-8 for r in info["true_rels"]), info["true_rels"]
    assert 1e-8 < info["probe_floor"] < 1e-3
    assert all(5 <= it <= 25 for it in info["iters"]), info["iters"]
    assert x.dtype == torch.float64 and torch.isfinite(x).all()

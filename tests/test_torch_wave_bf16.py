"""The wave slice at 4^3 cells with run_wave_bench's bf16 levels
(level_bf16 and vanka_bf16), stfem_tpu_torch vs stfem_tpu (bench_wave's
whole route is in test_torch_bench_wave.py).  Helpers and sizes are those of
test_torch_wave.py; the Richardson counts may differ by two here, because
the two packages' bf16 roundings differ (the port's grid chain rounds once
per chain, stfem_tpu's XLA path once per axis)."""
import pytest
import torch

from test_torch_wave import (build_wave_slice, check_ladder,
                             check_richardson_iterations)


@pytest.fixture(autouse=True, scope="module")
def _no_estimate_cache():
    """The port's hierarchies estimate afresh: no estimate disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        yield


@pytest.fixture(scope="module")
def slice_setup():
    return build_wave_slice(True)


def test_level_ladder(slice_setup):
    check_ladder(*slice_setup[:2])
    assert slice_setup[1].dtype == torch.bfloat16


def test_richardson_iterations(slice_setup):
    """Each package's own build: preconditioned-Richardson counts within
    +-2 with the bench's bf16 levels."""
    check_richardson_iterations(*slice_setup, slack=2)

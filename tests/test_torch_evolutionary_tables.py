"""get_fe_time_weights_2variable_evolutionary of stfem_tpu_torch against
stfem_tpu's (time/tables.py:396-419), bitwise: DG and CGP at r = 1 and
2, one and two steps at once."""
import numpy as np
import pytest

from stfem_tpu.time.tables import \
    get_fe_time_weights_2variable_evolutionary as jweights
from stfem_tpu.types import TimeStepType as JT
from stfem_tpu_torch.time.tables import \
    get_fe_time_weights_2variable_evolutionary as tweights
from stfem_tpu_torch.types import TimeStepType


@pytest.mark.parametrize("kind", ["DG", "CGP"])
@pytest.mark.parametrize("r", [1, 2])
@pytest.mark.parametrize("n_steps", [1, 2])
def test_two_variable_evolutionary_bitwise(kind, r, n_steps):
    want = jweights(JT[kind], r, 0.125, n_steps)
    got = tweights(TimeStepType[kind], r, 0.125, n_steps)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)

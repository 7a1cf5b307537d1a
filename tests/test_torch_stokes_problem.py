"""The Stokes problem data of stfem_tpu_torch against stfem_tpu's (CPU,
x64): the manufactured solution, its gradients and the momentum rhs
(also with the Navier term) at seeded random points and times, to 1e-14
relative to the largest value; StokesParameters parsed from the same
JSON; the strong Dirichlet block times."""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu import config as jconfig
from stfem_tpu import types as jtypes
from stfem_tpu.ops.boundary import slab_time_offsets as jslab_time_offsets
from stfem_tpu.problems import stokes as jstokes
from stfem_tpu_torch import config as tconfig
from stfem_tpu_torch import types as ttypes
from stfem_tpu_torch.ops.boundary import slab_time_offsets
from stfem_tpu_torch.problems import stokes as tstokes

RNG = np.random.default_rng(7)
PTS = RNG.uniform(-0.2, 1.2, (5, 7, 2))
TIMES = RNG.uniform(0.0, 2.0, (5, 1))


def _close(t, j, tol=1e-14):
    j = np.asarray(j, np.float64)
    np.testing.assert_allclose(t.numpy(), j, rtol=0,
                               atol=tol * np.abs(j).max())


@pytest.mark.parametrize("name", ["exact_u", "exact_grad_u", "exact_p",
                                  "exact_grad_p"])
def test_exact_solution_matches(name):
    for t in (0.0, 0.37, 1.9):
        _close(getattr(tstokes, name)(torch.tensor(PTS), t),
               getattr(jstokes, name)(jnp.asarray(PTS), t))
    # one time per leading block, as the batched error pass calls it
    _close(getattr(tstokes, name)(torch.tensor(PTS), torch.tensor(TIMES)),
           getattr(jstokes, name)(jnp.asarray(PTS), jnp.asarray(TIMES)))


@pytest.mark.parametrize("navier", [False, True])
def test_rhs_matches(navier):
    for nu, t in ((1.0, 0.37), (0.01, 1.3)):
        _close(tstokes.rhs_u(torch.tensor(PTS), t, nu, navier=navier),
               jstokes.rhs_u(jnp.asarray(PTS), t, nu, navier=navier))
    _close(tstokes.rhs_u(torch.tensor(PTS), torch.tensor(TIMES), 0.5,
                         navier=navier),
           jstokes.rhs_u(jnp.asarray(PTS), jnp.asarray(TIMES), 0.5,
                         navier=navier))


def test_stokes_parameters_parse(tmp_path):
    raw = {"computeDragLift": "false", "rho": 2.5,
           "characteristicDiam": "0.2", "uMean": 1.5, "viscosity": "1e-3",
           "delta0": 0.1, "delta1": "0.2", "penalty1": 30,
           "penalty2": "15", "outflowPenalty": 0.5, "meanPressure": "false",
           "dGPressure": "true", "dfgBenchmark": "2", "feDegree": 3}
    path = tmp_path / "stokes.json"
    path.write_text(json.dumps(raw))
    j = jconfig.StokesParameters.parse(str(path))
    t = tconfig.StokesParameters.parse(str(path))
    assert vars(t) == vars(j)
    assert vars(tconfig.StokesParameters()) == vars(
        jconfig.StokesParameters())


@pytest.mark.parametrize("kind,r,n", [("DG", 1, 3), ("DG", 2, 1),
                                      ("CGP", 2, 2), ("CGP", 3, 1)])
def test_slab_time_offsets(kind, r, n):
    np.testing.assert_allclose(
        slab_time_offsets(getattr(ttypes.TimeStepType, kind), r, 0.125, n),
        jslab_time_offsets(getattr(jtypes.TimeStepType, kind), r, 0.125, n),
        rtol=0, atol=1e-16)

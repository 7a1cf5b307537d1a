"""tp_01's config driver with the solver options of the Chebyshev
configs, on the CPU against stfem_tpu: run_config on the 2D heat DG(1)
golden cells (Q2, 2 steps at once, refinements 2 and 3) with "smoother"
chebyshev, "smoothingSteps" 2, "smoothingRange" 5 and
"coarseGridSmootherType" GMRES.  The three norms within 1e-9 relative of
stfem_tpu's run_single, and within 2e-5 of the reference goldens (the
preconditioner does not move a solve to rel 1e-12); the mean FGMRES
iterations within 1 of stfem_tpu's 5.0 at both refinements (6.5 and 8.0
at the defaults).  Its GMRES coarse level is the 1-cell Q2 level of the
config's h-only ladder, one free dof a block: GMRES breaks down after
two iterations and the minimum-norm solve is exact."""
import io
import json

import pytest
import torch

from stfem_tpu.config import Parameters as JParameters
from stfem_tpu.drivers import tp01 as jtp01
from stfem_tpu_torch.config import Parameters
from stfem_tpu_torch.drivers import tp01

torch.set_num_threads(1)

CHEB_KEYS = {"smoother": "chebyshev", "smoothingSteps": 2,
             "smoothingRange": 5.0, "coarseGridSmootherType": "GMRES"}
GOLDEN_L2 = {2: 1.78760e-02, 3: 3.24200e-03}


@pytest.fixture(autouse=True, scope="module")
def _no_estimate_cache():
    """The port's hierarchies estimate afresh: no estimate disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        yield


@pytest.mark.parametrize("ref", [2, 3])
def test_run_config_chebyshev(tmp_path, monkeypatch, ref):
    monkeypatch.setenv("STFEM_EIG_CACHE", "0")
    cfg = {"problemType": "heat", "timeType": "DG", "feDegree": 1,
           "nTimestepsAtOnce": 2, "subdivisions": "1,1", "refinement": ref,
           "nRefCycles": 1, "endTime": 1.0,
           "spaceTimeConvergenceTest": True, "relativeTolerance": 1e-12,
           "spaceTimeMg": True, **CHEB_KEYS}
    path = tmp_path / "heat.json"
    path.write_text(json.dumps(cfg))
    gmgs = []
    res = tp01.run_config(
        Parameters.parse(str(path), 2), device="cpu", out=io.StringIO(),
        on_slab=lambda integ, *a: gmgs.append(integ.preconditioner))[(1, ref)]
    j = jtp01.run_single(JParameters.parse(str(path), 2), 1, ref)
    for n in ("linf_linf", "l2_l2", "l2_h1"):
        assert getattr(res, n) == pytest.approx(getattr(j, n), rel=1e-9), n
    assert abs(res.avg_iterations - j.avg_iterations) <= 1
    assert res.avg_iterations == pytest.approx(5.0, abs=1)
    assert res.l2_l2 == pytest.approx(GOLDEN_L2[ref], rel=2e-5)
    gmg = gmgs[-1]
    lvl0 = gmg.levels[0]
    assert gmg.coarse == "GMRES" and lvl0.dof_shape == (3, 3)
    assert int(lvl0.matrix.K.mask_np.sum()) == 1
    assert type(lvl0.smoother).__name__ == "ChebyshevSmoother"

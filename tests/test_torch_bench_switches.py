"""bench.py's STFEM_BENCH_* switches in the port (bench_heat, bench_wave,
bench_stokes and the combined stfem_tpu_torch.bench) on the CPU.

  * Every variable reaches its run() argument through main(), and a flag
    overrides it; without either, main() passes run()'s own defaults.
  * Every STFEM_BENCH_* name in bench.py is a switch of the port or one
    of the three not ported (README.md says why).
  * The combined bench runs Stokes, wave, heat in that order, skips a
    secondary section past the budget, repeats the lines in its summary
    with the heat metric last, and lets a section's exception through.
  * bench_heat.run at 4^3 cells, 4 steps a slab, 1 slab, float32 levels,
    converges (TRUE <= 1e-8) with each outer solver, and its first
    solve's iterations equal those of stfem_tpu's build_stmg with the same
    GMGParams and stfem_tpu's richardson_solve / fgmres / chebyshev_solve
    (on the same rhs, start and tolerance; Chebyshev on the port's
    interval, the two rho estimates within 1e-3).  The first solve stops
    at rtol1 = 1e-4 (and the correction at 1e-5): below ~3e-5 stfem_tpu's
    float32 Givens estimate with one Gram-Schmidt pass lags the port's
    FP64 one on this system (6 against 4 FGMRES iterations at 3e-5, none
    converging at 1e-5 in 18), and the derived rtol1 sits just above the
    float32 floor."""
import inspect
import json
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from stfem_tpu import krylov as jkrylov
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.stmg.gmg import GMGParams as JParams
from stfem_tpu.stmg.gmg import build_stmg as jbuild
from stfem_tpu.stmg.smoother import initial_guess as jinitial_guess
from stfem_tpu.system import SystemMatrix as JSys
from stfem_tpu.time.tables import get_fe_time_weights as jweights
from stfem_tpu.types import TimeStepType as JT
from stfem_tpu_torch import bench, bench_heat, bench_stokes, bench_wave
from stfem_tpu_torch.integrators import ForceAssembler
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.problems import heat as heat_problem
from stfem_tpu_torch.system import SystemMatrix
from stfem_tpu_torch.time.tables import get_fe_time_weights, get_time_quad
from stfem_tpu_torch.types import TimeStepType

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
MODULES = (bench_heat, bench_wave, bench_stokes)
_ORIGINAL_RUN = {m: m.run for m in MODULES}
NOT_PORTED = ("STFEM_BENCH_IR_FF", "STFEM_BENCH_IR_STEPWISE",
              "STFEM_BENCH_FUSED")
# a value other than the default for the switches whose values are names
NAMED = {"coarse": "GMRES", "smoother": "Chebyshev", "outer": "fgmres",
         "x0": "extrap", "reorth": "selective"}


@pytest.fixture(autouse=True, scope="module")
def _no_estimate_cache():
    """Both packages estimate afresh: no estimate disk cache."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        yield


def _changed(s):
    """(the variable's text, the run() value) of a value other than the
    switch's default."""
    if s.kind == "bool":
        return ("0", False) if s.default else ("1", True)
    if s.name in NAMED:
        raw = NAMED[s.name]
        return raw, s.kind(raw)
    if s.kind is int:
        v = (s.default or 2) + 3
        return str(v), v
    return "0.375", 0.375


class _Called(Exception):
    pass


def _recorder(calls, name, info=None):
    def run(**kw):
        calls.append((name, kw))
        if info is None:
            raise _Called
        return dict(info), None
    return run


@pytest.mark.parametrize("module", MODULES, ids=lambda m: m.__name__)
def test_switches_reach_run(monkeypatch, module):
    calls = []
    monkeypatch.setattr(module, "run", _recorder(calls, "run"))
    env = {s.env: _changed(s)[0] for s in module.SWITCHES}
    with pytest.raises(_Called):
        module.main(["--device", "cpu"], environ=env)
    kw = calls[-1][1]
    for s in module.SWITCHES:
        assert kw[s.arg] == _changed(s)[1], s.env
    # a flag beats its variable
    with pytest.raises(_Called):
        module.main(["--device", "cpu", "--slabs", "7"], environ=env)
    assert calls[-1][1]["n_slabs"] == 7
    # neither: run()'s own defaults
    defaults = {k: p.default for k, p in inspect.signature(
        _ORIGINAL_RUN[module]).parameters.items()}
    with pytest.raises(_Called):
        module.main(["--device", "cpu"], environ={})
    for s in module.SWITCHES:
        assert calls[-1][1][s.arg] == defaults[s.arg], s.env


def test_every_bench_switch_ported_or_listed():
    names = set(re.findall(r"STFEM_BENCH_[A-Z0-9_]+",
                           (REPO / "bench.py").read_text()))
    ported = {s.env for m in MODULES for s in m.SWITCHES} | {
        s.env for s in bench.SECTIONS}
    assert names == ported | set(NOT_PORTED)
    assert not ported & set(NOT_PORTED)
    readme = (REPO / "README.md").read_text()
    for name in names:
        assert name in readme, name


_INFO = {"converged": True}


def test_combined_bench_sections(monkeypatch, capsys):
    calls = []
    for m in MODULES:
        name = m.__name__.rsplit("_", 1)[1]
        monkeypatch.setattr(m, "run", _recorder(calls, name, _INFO))
        monkeypatch.setattr(m, "metric_line",
                            lambda info, name=name: {"metric": name})
    env = {s.env: _changed(s)[0] for m in MODULES for s in m.SWITCHES}
    bench.main(["--device", "cpu"], environ=env)
    assert [c[0] for c in calls] == ["stokes", "wave", "heat"]
    for (_, kw), m in zip(calls, (bench_stokes, bench_wave, bench_heat)):
        assert kw == dict({s.arg: _changed(s)[1] for s in m.SWITCHES},
                          device="cpu")
    lines = capsys.readouterr().out.strip().splitlines()
    summary = lines[lines.index(
        "# ---- bench summary (all sections; heat metric last) ----") + 1:]
    assert [json.loads(t) for t in summary] == [
        _INFO, {"metric": "stokes"}, _INFO, {"metric": "wave"}, _INFO,
        {"metric": "heat"}]
    # off, and past the budget
    calls.clear()
    bench.main(["--device", "cpu", "--no-stokes"],
               environ={"STFEM_BENCH_BUDGET_S": "-1"})
    assert [c[0] for c in calls] == ["heat"]
    out = capsys.readouterr().out
    assert "# wave bench skipped" in out and "stokes bench" not in out
    # a section's exception ends the run
    monkeypatch.setattr(bench_wave, "run", _recorder(calls, "wave"))
    with pytest.raises(_Called):
        bench.main(["--device", "cpu"], environ={})


def _slab0(cells=4, ntao=4):
    """The port's first-solve rhs and start of bench_heat's slab 0 (the
    same code as bench_heat.run), float32."""
    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3,
                          refinement=int(np.log2(cells // 2)))
    K, M = (LaplaceMassOperator(mesh, 4, 5, m, l, dtype=torch.float32,
                                device="cpu")
            for m, l in ((0.0, 1.0), (1.0, 0.0)))
    A, B, G, _ = get_fe_time_weights(TimeStepType.DG, 2, 1 / 16, ntao)
    rhs_matrix = SystemMatrix(K, M, np.zeros_like(G), G)
    force = ForceAssembler(mesh, 4, 5,
                           lambda p, t: heat_problem.rhs(p, t, 1.0),
                           K.mask_np, dtype=torch.float32, device="cpu")
    tq = get_time_quad(TimeStepType.DG, 2)[0]
    nt, nb = len(tq), A.shape[0]
    t_off = torch.as_tensor(np.array(
        [(row // nt) / 16 + float(tq[row % nt]) / 16 for row in range(nb)],
        np.float32))
    f_sc = torch.as_tensor(np.array([A[r, r] for r in range(nb)],
                                    np.float32))
    coords = torch.as_tensor(mesh.dof_coordinates(4), dtype=torch.float32)
    prev = heat_problem.exact_solution(coords, 0.0, 1.0).to(torch.float32)
    rhs = rhs_matrix.vmult(prev[None]) + force.batched(0.0 + t_off, f_sc)
    x0 = prev.expand((nb,) + mesh.dof_shape(4))
    return rhs.numpy(), np.array(x0.numpy())


@pytest.fixture(scope="module")
def jax_heat():
    """stfem_tpu's bench hierarchy with bench_heat's GMGParams at 4^3 and
    float32 levels, and its float32 slab operator."""
    m = JMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=1)
    jg = jbuild(m, 2, 4, JT.DG, 4, 1 / 16, dtype=jnp.float32,
                fe_degree_min=1,
                params=JParams(smoother_inner_iterations=2,
                               coarse_grid_smoother_type="Direct",
                               variable=False, skip_identity_levels=True,
                               eig_proxy_cells=2))
    A, B, _, _ = jweights(JT.DG, 2, 1 / 16, 4)
    K, M = (JOp(m, 4, 5, ms, ls, dtype=jnp.float32)
            for ms, ls in ((0.0, 1.0), (1.0, 0.0)))
    return jg, JSys(K, M, A, B), K.mask_np


@pytest.mark.parametrize("outer", ["richardson", "fgmres", "chebyshev"])
def test_bench_heat_outer_modes(jax_heat, outer):
    info, x = bench_heat.run(4, 4, 1, device="cpu", eig_proxy_cells=2,
                             bf16=False, level_bf16=False, outer=outer,
                             rtol1=1e-4, ir_rtol=1e-5)
    assert info["outer"] == outer and info["converged"]
    assert info["true_rels"][0] <= 1e-8 and bool(torch.isfinite(x).all())
    jg, jmat, mask = jax_heat
    rhs, x0 = (jnp.asarray(a) for a in _slab0())
    tol = info["rtol1"]
    common = dict(maxiter=40, abstol=1e-30, reltol=tol)
    if outer == "richardson":
        solve = lambda b: jkrylov.richardson_solve(
            jmat.vmult, b, x0, jg.vmult, **common)
    elif outer == "fgmres":
        solve = lambda b: jkrylov.fgmres(
            jmat.vmult, b, x0, precondition=jg.vmult, maxiter=18,
            abstol=1e-30, reltol=tol, reorthogonalize=False)
    else:
        # the bench's start vector (stmg/smoother.initial_guess)
        v0 = jinitial_guess(rhs.shape, mask, jnp.float32)
        rho = float(jax.jit(lambda v: jkrylov.estimate_error_propagator_radius(
            jmat.vmult, jg.vmult, v))(v0))
        assert abs(rho - info["rho"]) <= 1e-3
        solve = lambda b: jkrylov.chebyshev_solve(
            jmat.vmult, b, x0, jg.vmult, lambda_min=1 - 1.05 * info["rho"],
            lambda_max=1 + 1.05 * info["rho"], **common)
    res = jax.jit(solve)(rhs)
    assert bool(res.converged)
    assert info["first_iters"][0] == int(res.iterations)

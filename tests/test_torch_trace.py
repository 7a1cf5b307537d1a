"""The port's tracer (stfem_tpu_torch/utils/timer.py) and its spans and
counters inside the V-cycle, the level operators, the smoother, the
transfers, the Krylov solvers' host reads and the set-up (CPU, small
hierarchies with a fixed omega unless the test needs the estimates).

  * off (the default): nothing recorded, no profiler range of the
    program's names, and the V-cycle's output bit-identical to the
    tracer on, with and without the profiler;
  * on: the V-cycle's span tree (stage spans per level, in the V-cycle's
    order, none nested across levels; the operator, smoother and
    transfer spans inside them), stmg.vcycles equal to the calls,
    vanka.applies equal to what GMG._steps and the Relaxation /
    Chebyshev sweeps predict;
  * under a CPU torch.profiler: the record and the profiler's ranges
    agree in names, order and nesting, and after one offset their starts
    differ by under 100 us;
  * every SystemMatrix route and Vanka mode, the solvers' host reads,
    the set-up spans with the estimate cache's hits and misses, the
    kernels' launch counters, clear() inside an open span, and
    TimerOutput scopes in the record."""
import numpy as np
import pytest
import torch

from stfem_tpu_torch import krylov
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops import time_solve as time_solve_mod
from stfem_tpu_torch.ops.kronfac import KronAssembled
from stfem_tpu_torch.ops.slab_residual import SlabResidual64
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.stmg import vanka as tvanka
from stfem_tpu_torch.stmg.eig_cache import EstimateCache
from stfem_tpu_torch.stmg.gmg import GMGParams, bench_params, build_stmg
from stfem_tpu_torch.stmg.smoother import (ChebyshevSmoother,
                                           RelaxationSmoother)
from stfem_tpu_torch.stmg.vanka import PreconditionVanka
from stfem_tpu_torch.system import SystemMatrix
from stfem_tpu_torch.time.tables import get_fe_time_weights
from stfem_tpu_torch.types import SupportedSmoothers, TimeStepType
from stfem_tpu_torch.utils import timer
from stfem_tpu_torch.utils.timer import TimerOutput

torch.set_num_threads(1)
F32, F64 = torch.float32, torch.float64
PREFIXES = ("stmg.", "sysmat.", "vanka.", "transfer.", "krylov.",
            "residual64", "kernels.")

# name -> (mesh cells per axis, refinement, space degree, n steps,
# GMGParams); omega fixed (no estimate) except for Chebyshev
HIERARCHIES = {
    # the benches' V-cycle: Identity levels skipped, the Direct coarse solve
    "bench3d": ([1, 1, 1], 2, 2, 4, bench_params(
        level_bf16=False, vanka_bf16=False, eig_proxy_cells=0,
        relaxation=0.7)),
    # stfem_tpu's defaults: variable smoothing, Identity levels visited,
    # the Smoother coarse solve
    "defaults2d": ([2, 2], 2, 2, 2, GMGParams(relaxation=0.7)),
    # Chebyshev of degree 3, estimated; post-smoothing off on the finest
    "chebyshev2d": ([2, 2], 2, 2, 2, GMGParams(
        smoother=SupportedSmoothers.Chebyshev, smoother_inner_iterations=3,
        variable=False, smooth_all_levels=True, no_post_smooth_finest=True,
        eig_exact=False)),
    # the GMRES coarse solve, two steps, one post sweep
    "gmres2d": ([2, 2], 1, 2, 2, GMGParams(
        relaxation=0.7, coarse_grid_smoother_type="GMRES",
        coarse_grid_maxiter=3, variable=False, smoothing_steps=2,
        smoother_inner_iterations=2, post_smoother_inner_iterations=1,
        smooth_all_levels=True)),
}


@pytest.fixture(autouse=True)
def _fresh_record():
    """Every test starts and ends with the tracer off and its record
    empty."""
    timer.clear()
    yield
    assert not timer._ON
    timer.clear()


@pytest.fixture(autouse=True, scope="module")
def _no_estimate_cache():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        yield


_BUILT = {}


def hierarchy(name):
    """(gmg, a V-cycle input) of HIERARCHIES[name], built once."""
    if name not in _BUILT:
        cells, refinement, k, n_steps, params = HIERARCHIES[name]
        dim = len(cells)
        mesh = StructuredMesh(cells, [0.0] * dim, [1.0] * dim,
                              refinement=refinement)
        gmg = build_stmg(mesh, 1, k, TimeStepType.DG, n_steps, 0.1, params,
                         dtype=F32, device="cpu")
        top = gmg.levels[-1]
        x = torch.as_tensor(np.random.default_rng(3).standard_normal(
            (top.n_blocks,) + tuple(top.dof_shape)), dtype=F32)
        _BUILT[name] = (gmg, x * top.matrix.K.mask)
    return _BUILT[name]


def children(spans, i):
    return [j for j, s in enumerate(spans) if s[1] == i]


def names(spans, idx):
    return [spans[j][0] for j in idx]


def program_ranges(prof):
    """(name, start ns, end ns) of the profiler's ranges of the program's
    names, in start order."""
    out = [(e.name(), int(e.start_ns()), int(e.start_ns())
            + int(e.duration_ns()))
           for e in prof.profiler.kineto_results.events()
           if e.name().startswith(PREFIXES)]
    return sorted(out, key=lambda r: (r[1], -r[2]))


def nest(intervals):
    """The parent index of each (start, end) interval, nesting by time."""
    parent, stack = [], []
    for s, e in intervals:
        while stack and intervals[stack[-1]][1] <= s:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(len(parent) - 1)
    return parent


def predicted_vanka_applies(gmg) -> int:
    """Vanka applies of one V-cycle: per visited level _steps smoother
    applications before and after the coarse correction, each
    Relaxation application its sweeps (the post-smoother's own where
    set), each Chebyshev application its degree; the coarse solve's as
    its type says."""
    def per_application(level, post=False):
        sm = gmg.levels[level].smoother
        if isinstance(sm, RelaxationSmoother):
            return (gmg.post_inner if post and gmg.post_inner is not None
                    else sm.n_iterations)
        if isinstance(sm, ChebyshevSmoother):
            return sm.degree
        return 0

    total = 0
    for level in range(1, gmg.max_level + 1):
        if gmg._skipped(level):
            continue
        total += gmg._steps(level) * per_application(level)
        if not (gmg.no_post_smooth or (gmg.no_post_smooth_finest
                                       and level == gmg.max_level)):
            total += gmg._steps(level) * per_application(level, post=True)
    if gmg.coarse == "Smoother" and not gmg._skipped(0):
        total += gmg._steps(0) * per_application(0)
    elif gmg.coarse not in ("Direct", "Smoother"):
        total += (gmg.coarse_maxiter + 1) * per_application(0)
    return total


def test_off_records_nothing_and_opens_no_range():
    """With the tracer off the spans and counters stay empty, and a CPU
    profiler sees none of the program's range names (V-cycle, solver)."""
    gmg, x = hierarchy("bench3d")
    assert timer.span("stmg.vcycle") is timer.span("vanka.vmult")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        gmg.vmult(x)
        krylov.richardson_solve(lambda v: 2.0 * v, x, torch.zeros_like(x),
                                lambda r: 0.5 * r, maxiter=2)
        timer.count("stmg.vcycles")
    assert timer.records() == {"spans": [], "counters": {}}
    assert program_ranges(prof) == []


@pytest.mark.parametrize("name", sorted(HIERARCHIES))
def test_vcycle_span_tree(name):
    """One V-cycle's record: stmg.vcycle holds the stage spans of every
    level in the V-cycle's order (down: smooth, residual, restrict; the
    coarse solve; up: prolongate, post_smooth), none nested in another;
    smoothing holds Vanka and operator applies, the residual an operator
    apply, restrict and prolongate a transfer each; each operator apply
    holds its space part, each Vanka apply down, time and up."""
    gmg, x = hierarchy(name)
    with timer.tracing():
        gmg.vmult(x)
    spans = timer.records()["spans"]
    assert spans[0][0] == "stmg.vcycle" and spans[0][1] == -1
    assert all(s[1] >= 0 for s in spans[1:])
    top = gmg.max_level
    stages = []
    for level in range(top, 0, -1):
        stages += [f"stmg.{s}.L{level}"
                   for s in ("smooth", "residual", "restrict")]
    stages.append("stmg.coarse.L0")
    for level in range(1, top + 1):
        stages += [f"stmg.{s}.L{level}" for s in ("prolongate",
                                                  "post_smooth")]
    assert names(spans, children(spans, 0)) == stages
    inside = {"smooth": {"vanka.vmult", "sysmat.vmult"},
              "post_smooth": {"vanka.vmult", "sysmat.vmult"},
              "residual": {"sysmat.vmult"},
              "restrict": {"transfer.restrict"},
              "prolongate": {"transfer.prolongate"},
              "coarse": {"vanka.vmult", "sysmat.vmult", "krylov.norm_read"}}
    for i in children(spans, 0):
        stage = spans[i][0].split(".")[1]
        below = set(names(spans, children(spans, i)))
        assert below <= inside[stage], (spans[i][0], below)
        assert not any(n.startswith("stmg.") for n in below)
        level = int(spans[i][0].rsplit(".L", 1)[1])
        if stage in ("residual", "restrict", "prolongate"):
            assert len(below) == 1
        if stage == "smooth" and isinstance(gmg.levels[level].smoother,
                                            (RelaxationSmoother,
                                             ChebyshevSmoother)):
            assert "vanka.vmult" in below
    for i, s in enumerate(spans):
        if s[0] == "sysmat.vmult":
            assert "sysmat.space" in names(spans, children(spans, i))
        if s[0] == "vanka.vmult":
            assert names(spans, children(spans, i)) == [
                "vanka.down", "vanka.time", "vanka.up"]
    for s in spans:
        assert s[2] <= s[3]
        assert spans[s[1]][2] <= s[2] and s[3] <= spans[s[1]][3] \
            if s[1] >= 0 else True


@pytest.mark.parametrize("name", sorted(HIERARCHIES))
def test_vcycle_counters(name):
    """stmg.vcycles equals the calls; vanka.applies equals the applies
    the cycle's options predict, and the vanka.vmult spans; the operator
    applies count by route."""
    gmg, x = hierarchy(name)
    calls = 3
    with timer.tracing():
        for _ in range(calls):
            gmg(x)
    rec = timer.records()
    c, spans = rec["counters"], rec["spans"]
    assert c["stmg.vcycles"] == calls
    assert sum(s[0] == "stmg.vcycle" for s in spans) == calls
    assert c["vanka.applies"] == calls * predicted_vanka_applies(gmg) > 0
    assert c["vanka.applies"] == sum(s[0] == "vanka.vmult" for s in spans)
    assert c["sysmat.vmults.kron"] == sum(s[0] == "sysmat.vmult"
                                          for s in spans)


@pytest.mark.parametrize("name", sorted(HIERARCHIES))
def test_output_bit_identical(name):
    """The V-cycle's output with the tracer off, on, and on under the
    profiler is the same, bit for bit."""
    from torch.profiler import ProfilerActivity, profile
    gmg, x = hierarchy(name)
    off = gmg.vmult(x)
    with timer.tracing():
        on = gmg.vmult(x)
    with profile(activities=[ProfilerActivity.CPU]):
        with timer.tracing(profiler=True):
            profiled = gmg.vmult(x)
    assert torch.equal(off, on) and torch.equal(off, profiled)


@pytest.mark.parametrize("name", ["bench3d", "gmres2d"])
def test_record_matches_profiler(name):
    """Under a CPU profiler the record and the profiler's ranges of the
    program's names agree in names, order and nesting; the offset of the
    first stmg.vcycle puts every paired start within 100 us."""
    from torch.profiler import ProfilerActivity, profile
    gmg, x = hierarchy(name)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.tracing(profiler=True):
            for _ in range(2):
                gmg.vmult(x)
    spans = timer.records()["spans"]
    ranges = program_ranges(prof)
    assert [r[0] for r in ranges] == [s[0] for s in spans]
    assert nest([r[1:] for r in ranges]) == [s[1] for s in spans]
    offset = ranges[0][1] - spans[0][2]
    worst = max(abs(r[1] - (s[2] + offset)) for r, s in zip(ranges, spans))
    assert worst < 100_000, worst


def _level_ops(geometry, dtype):
    dim = 2
    kw = dict(refinement=1, distort=0.15) if geometry == "distorted" \
        else dict(refinement=1)
    mesh = StructuredMesh([2, 2], [0.0] * dim, [1.0] * dim, **kw)
    return (LaplaceMassOperator(mesh, 2, 3, 0.0, 1.0, dtype=dtype,
                                device="cpu"),
            LaplaceMassOperator(mesh, 2, 3, 1.0, 0.0, dtype=dtype,
                                device="cpu"))


@pytest.mark.parametrize("route,geometry,dtype", [
    ("kron", "uniform", F32), ("grid", "uniform", F32),
    ("quad", "uniform", F64), ("cell", "distorted", F64)])
def test_system_matrix_routes(route, geometry, dtype):
    """vmult, Tvmult and vmult_slice on every route: one sysmat.vmult span
    each, counted as sysmat.vmults.<route>, holding sysmat.space; the
    block mixing is sysmat.time_mix, beside the Kronecker pair on route
    kron and inside the spatial apply on the others; the output as with
    the tracer off."""
    K, M = _level_ops(geometry, dtype)
    A, B, G, _ = get_fe_time_weights(TimeStepType.DG, 1, 0.1, 2)
    S = SystemMatrix(K, M, A, B, precision=None, route=route)
    R = SystemMatrix(K, M, np.zeros_like(G), G, route=route)
    x = torch.as_tensor(np.random.default_rng(1).standard_normal(
        (A.shape[0],) + tuple(K.dof_shape)), dtype=dtype)
    off = (S.vmult(x), S.Tvmult(x), R.vmult_slice(x[0]), R.vmult(x[:1]))
    with timer.tracing():
        on = (S.vmult(x), S.Tvmult(x), R.vmult_slice(x[0]), R.vmult(x[:1]))
    assert all(torch.equal(a, b) for a, b in zip(off, on))
    rec = timer.records()
    spans = rec["spans"]
    tops = [i for i, s in enumerate(spans) if s[1] == -1]
    assert names(spans, tops) == ["sysmat.vmult"] * 4
    assert rec["counters"] == {f"sysmat.vmults.{route}": 4}
    for i in tops:
        below = children(spans, i)
        assert "sysmat.space" in names(spans, below)
        mixes = [j for j, s in enumerate(spans) if s[0] == "sysmat.time_mix"
                 and (s[1] == i or s[1] in below)]
        assert mixes
        assert all(spans[spans[j][1]][0] == ("sysmat.vmult" if route
                                             == "kron" else "sysmat.space")
                   for j in mixes)


@pytest.mark.parametrize("mode", ["grid", "cell", "dense"])
def test_vanka_modes(mode, monkeypatch):
    """Every Vanka mode's apply is vanka.vmult holding vanka.down,
    vanka.time and vanka.up, counted as vanka.applies; the output as
    with the tracer off."""
    K, M = _level_ops("uniform", F64)
    A, B, _, _ = get_fe_time_weights(TimeStepType.DG, 1, 0.1, 4)
    if mode == "cell":
        monkeypatch.setattr(tvanka, "separable", lambda K_op, M_op: False)
    v = PreconditionVanka(K, M, A, B, n_steps=4,
                          mode="dense" if mode == "dense" else None)
    assert v.mode == mode
    x = torch.as_tensor(np.random.default_rng(2).standard_normal(
        (A.shape[0],) + tuple(K.dof_shape)) * K.mask_np)
    off = v.vmult(x)
    with timer.tracing():
        on = v.vmult(x)
        v.vmult(x)
    assert torch.equal(off, on)
    rec = timer.records()
    spans = rec["spans"]
    assert rec["counters"] == {"vanka.applies": 2}
    for i in (0, 4):
        assert spans[i][0] == "vanka.vmult" and spans[i][1] == -1
        assert names(spans, children(spans, i)) == [
            "vanka.down", "vanka.time", "vanka.up"]


def _solvers():
    A = torch.diag(torch.linspace(1.0, 3.0, 12, dtype=F64))
    b = torch.ones(12, dtype=F64)
    mat, pre = (lambda v: A @ v), (lambda r: r / 2.0)
    return {
        # one read before the loop, one a step
        "richardson": (lambda: krylov.richardson_solve(
            mat, b, torch.zeros_like(b), pre, maxiter=50, reltol=1e-6),
            lambda res: 1 + res.iterations),
        "chebyshev": (lambda: krylov.chebyshev_solve(
            mat, b, torch.zeros_like(b), pre, 0.5, 1.5, maxiter=50,
            reltol=1e-6), lambda res: 1 + res.iterations),
        # the initial norm, then per step the new vector's norm and the
        # Givens column
        "fgmres": (lambda: krylov.fgmres(
            mat, b, torch.zeros_like(b), pre, maxiter=8, reltol=1e-6),
            lambda res: 1 + 2 * res.iterations),
        # the Hessenberg matrix once
        "gmres_fixed_left": (lambda: krylov.gmres_fixed_left(
            mat, b, pre, 4), lambda res: 1),
    }


@pytest.mark.parametrize("solver", sorted(_solvers()))
def test_krylov_host_reads(solver):
    """Each host read of a norm or of products is one krylov.norm_read
    span and one krylov.host_reads."""
    run, expected = _solvers()[solver]
    with timer.tracing():
        res = run()
    rec = timer.records()
    n = expected(res)
    assert rec["counters"]["krylov.host_reads"] == n
    assert [s[0] for s in rec["spans"]] == ["krylov.norm_read"] * n


def test_slab_residual_span():
    """The FP64 IR residual is one residual64 span."""
    K, M = _level_ops("uniform", F64)
    A, B, G, _ = get_fe_time_weights(TimeStepType.DG, 1, 0.1, 2)
    res = SlabResidual64(KronAssembled(K, M, F64), K.mask_np, A, B, G)
    x = torch.ones((A.shape[0],) + tuple(K.dof_shape), dtype=F64)
    with timer.tracing():
        res.residual(x[0], x, torch.zeros_like(x))
    spans = timer.records()["spans"]
    assert [s[0] for s in spans if s[1] == -1] == ["residual64"]


def test_setup_spans_and_estimate_cache(tmp_path):
    """build_stmg: stmg.build holds a span per level in order, each with
    its Vanka and estimate spans where the level has a smoother, and the
    Direct coarse inverse; the estimates count as eig_cache misses on a
    first build and as hits on a second build from the same file."""
    mesh = StructuredMesh([2, 2], [0.0, 0.0], [1.0, 1.0], refinement=1)
    params = bench_params(level_bf16=False, vanka_bf16=False,
                          eig_proxy_cells=0)
    path = str(tmp_path / "eig.json")
    counters = []
    for _ in range(2):
        with timer.tracing():
            gmg = build_stmg(mesh, 1, 2, TimeStepType.DG, 2, 0.1, params,
                             dtype=F32, device="cpu",
                             estimate_cache=EstimateCache(path))
        rec = timer.records()
        timer.clear()
        counters.append(rec["counters"])
        spans = rec["spans"]
        assert spans[0][0] == "stmg.build" and spans[0][1] == -1
        n = len(gmg.levels)
        below = names(spans, children(spans, 0))
        assert below == [f"stmg.build.level.L{l}" for l in range(n)] \
            + ["stmg.build.coarse_direct"]
        smoothed = [l for l in range(n)
                    if isinstance(gmg.levels[l].smoother,
                                  RelaxationSmoother)]
        for i in children(spans, 0)[:n]:
            level = int(spans[i][0].rsplit(".L", 1)[1])
            expect = ([f"stmg.build.vanka.L{level}",
                       f"stmg.build.estimate.L{level}"]
                      if level in smoothed else [])
            assert names(spans, children(spans, i)) == expect
    first, second = counters
    n_est = len(smoothed)
    assert first.get("eig_cache.misses") == n_est and \
        "eig_cache.hits" not in first
    assert second.get("eig_cache.hits") == n_est and \
        "eig_cache.misses" not in second


def test_kernel_launches_counted_while_tracing(monkeypatch):
    """records() reports the kernels' own launch counters as
    kernel.<name>.launches, counting only launches while tracing."""
    monkeypatch.setattr(time_solve_mod.time_solve, "launches",
                        time_solve_mod.time_solve.launches)
    time_solve_mod.time_solve.launches += 5          # before: not counted
    with timer.tracing():
        time_solve_mod.time_solve.launches += 2
        assert timer.records()["counters"] == {
            "kernel.time_solve.launches": 2}
        time_solve_mod.time_solve.launches += 1
    time_solve_mod.time_solve.launches += 4          # after: not counted
    with timer.tracing():
        time_solve_mod.time_solve.launches += 1
    assert timer.records()["counters"] == {"kernel.time_solve.launches": 4}


def test_clear_inside_open_span():
    """clear() empties the record; a span open across it is not
    recorded, and the spans after it nest afresh."""
    with timer.tracing():
        with timer.span("stmg.vcycle"):
            timer.clear()
            with timer.span("vanka.vmult"):
                pass
        with timer.span("sysmat.vmult"):
            pass
    spans = timer.records()["spans"]
    assert [(s[0], s[1]) for s in spans] == [("vanka.vmult", -1),
                                             ("sysmat.vmult", -1)]
    assert all(0 < s[2] <= s[3] for s in spans)


@pytest.mark.parametrize("raises", [False, True])
def test_timer_output_scopes_in_record(raises):
    """A TimerOutput scope is timed on the performance counter, also
    when its body raises, and lands in the record as a span holding the
    spans opened inside it."""
    t = TimerOutput()
    with timer.tracing():
        try:
            with t.scope("step", sync="cpu"):
                with timer.span("stmg.vcycle"):
                    pass
                if raises:
                    raise ValueError("inside the scope")
        except ValueError:
            assert raises
    assert t.counts["step"] == 1 and len(t.times["step"]) == 1
    assert 0.0 <= t.totals["step"] < 1.0
    assert "step" in t.summary()
    spans = timer.records()["spans"]
    assert [(s[0], s[1]) for s in spans] == [("step", -1),
                                             ("stmg.vcycle", 0)]
    assert spans[0][3] >= spans[1][3] > 0

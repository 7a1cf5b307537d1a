"""The sharded whole solve of stfem_tpu_torch.parallel (minibench.py, the
distributed V-cycle of stmg/gmg.py::distribute_gmg) against stfem_tpu on
the CPU.

One spawn of 8 gloo ranks (tests/torch_sharded_ranks.py, which imports
only torch and the port; a file init under tmp_path, a 60 s timeout, a
join of at most 120 s) runs every multi-rank case:
  (i) stfem_tpu's tests/test_halo.py::test_sharded_stmg_solve_parity in
      2D (8 x 8 cells, Q2 x dG(1), 2 steps, the 2 x 4 mesh,
      level_sharding_policy(min_dofs_per_device=24), sharded and
      replicated levels mixed), with stfem_tpu's omegas (of its float32
      hierarchy, on both precisions) and coarse inverses carried across:
      one FP64 V-cycle of the joined slabs
      within 1e-10 of stfem_tpu's GMG.vmult, and float32 FGMRES to
      reltol 1e-10 in stfem_tpu's iterations with its solution within
      2e-4 / 2e-5; shard_block_vector / gather_block_vector round trip;
  (ii) the 3D minibench at cells 4, ntao 2, Q2 x dG(1) on the (2, 2, 2)
      mesh: TRUE <= 1e-8, iteration parity, stfem_tpu's single-device
      iterations, the gathered solution within SOLUTION_RTOL of the
      single-device one, halo exchanges and the all-reduce budget of
      tests/test_multichip_bench.py.
In this process, on one rank: the round trip, the Krylov solvers' new
norm and dot left out or given as the one-rank layout's (bitwise the
old), a distributed hierarchy on one rank (bitwise the global one), the
sliced Vanka (bitwise on the whole mesh; on two slabs its partial sums
add up to the global apply).  The slow test runs stfem_tpu's dry-run
size (cells 8, ntao 8, Q4 x dG(2)) on 8 gloo ranks."""
import json
import threading
import time
from datetime import timedelta

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as tmp

from stfem_tpu.krylov import fgmres as jfgmres
from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.parallel.minibench import \
    run_sharded_minibench as jrun_minibench
from stfem_tpu.stmg.gmg import GMGParams as JParams
from stfem_tpu.stmg.gmg import build_stmg as jbuild
from stfem_tpu.system import SystemMatrix as JSys
from stfem_tpu.time.tables import get_fe_time_weights
from stfem_tpu.types import TimeStepType as JT
from stfem_tpu_torch import krylov
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.ops.spatial import LaplaceMassOperator
from stfem_tpu_torch.parallel import dryrun, halo
from stfem_tpu_torch.parallel.minibench import (SOLUTION_RTOL,
                                                run_sharded_minibench)
from stfem_tpu_torch.parallel.sharding import (RankLayout,
                                               gather_block_vector,
                                               install_level_shardings,
                                               shard_block_vector,
                                               spatial_mesh)
from stfem_tpu_torch.stmg.gmg import GMGParams, build_stmg
from stfem_tpu_torch.system import SystemMatrix
from stfem_tpu_torch.types import TimeStepType

import torch_sharded_ranks as ranks_prog

torch.set_num_threads(1)

TAU = ranks_prog.TAU
JOIN_S = 120


@pytest.fixture(autouse=True, scope="module")
def _no_estimate_memo():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        yield


def _jax_2d():
    """stfem_tpu's side of case (i): the omegas of its float32 hierarchy
    (estimated) and the coarse inverses of its float32 and FP64 ones (the
    FP64 one built with these omegas), a seeded vector and its FP64
    V-cycle, the float32 system, rhs and FGMRES solve."""
    mesh = JMesh([1, 1], [0, 0], [1, 1], refinement=3)
    A, B, _, _ = get_fe_time_weights(JT.DG, 1, TAU, 2)
    cases = {"A": A, "B": B, "omegas": {}, "Ainv": {}}
    gmgs = {}
    for tdt, jdt, omega in ((torch.float32, jnp.float32, 0.0),
                            (torch.float64, jnp.float64, 1.0)):
        g = jbuild(mesh, 1, 2, JT.DG, 2, TAU, dtype=jdt, fe_degree_min=1,
                   params=JParams(smoothing_steps=2, variable=False,
                                  coarse_grid_smoother_type="Direct",
                                  relaxation=omega))
        gmgs[tdt] = g
        cases["Ainv"][tdt] = np.asarray(g.coarse_Ainv)
    cases["omegas"][torch.float32] = cases["omegas"][torch.float64] = [
        getattr(lvl.smoother, "omega", None)
        for lvl in gmgs[torch.float32].levels]
    for lvl, omega in zip(gmgs[torch.float64].levels,
                          cases["omegas"][torch.float32]):
        if omega is not None:
            lvl.smoother.omega = omega
    rng = np.random.default_rng(1)
    x = rng.standard_normal((4,) + mesh.dof_shape(2))
    cases["x"] = x
    vref = np.asarray(jax.jit(gmgs[torch.float64].vmult)(jnp.asarray(x)))
    K, M = (JOp(mesh, 2, 3, ms, ls, dtype=jnp.float32)
            for ms, ls in ((0.0, 1.0), (1.0, 0.0)))
    mat = JSys(K, M, A, B)
    rhs = mat.vmult(jnp.asarray(rng.standard_normal(x.shape), jnp.float32))
    cases["rhs"] = np.asarray(rhs)

    def solve(matrix, gmg, b):
        res = jfgmres(matrix.vmult, b, jnp.zeros_like(b),
                      precondition=gmg.vmult, maxiter=25, abstol=1e-30,
                      reltol=1e-10)
        return res.x, res.iterations

    xr, itr = jax.jit(solve)(mat, gmgs[torch.float32], rhs)
    return cases, vref, np.asarray(xr), int(itr)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the 8 ranks once; stfem_tpu's minibench runs meanwhile, in a
    thread beside the 2D references (most of both is XLA compiling)."""
    tmpd = tmp_path_factory.mktemp("sharded")
    jmb = {}
    thread = threading.Thread(target=lambda: jmb.update(jrun_minibench(
        n_devices=1, compare_single=True, verbose=False,
        **ranks_prog.MINIBENCH)))
    thread.start()
    cases, vref, xref, itref = _jax_2d()
    ctx = tmp.start_processes(
        ranks_prog.run_ranks, args=(str(tmpd / "init"), str(tmpd), cases),
        nprocs=ranks_prog.WORLD, join=False, start_method="spawn")
    deadline = time.time() + JOIN_S
    try:
        while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
            if time.time() > deadline:
                pytest.fail(f"the gloo ranks did not finish in {JOIN_S} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
        thread.join()
    out = [dict(np.load(tmpd / f"rank{r}.npz"))
           for r in range(ranks_prog.WORLD)]
    mbs = [json.loads((tmpd / f"rank{r}.json").read_text())
           for r in range(ranks_prog.WORLD)]
    return out, mbs, {"vref": vref, "xref": xref, "itref": itref,
                      "jax_minibench": jmb}


def _join_2x4(out, key):
    grid = {tuple(o["coord"]): o[key] for o in out}
    rows = [halo.join_dof_grid([grid[(i, j)] for j in range(4)], 2, axis=2)
            for i in range(2)]
    return halo.join_dof_grid(rows, 2, axis=1)


def test_policy_mixes(ranks):
    out, _, _ = ranks
    policy = list(out[0]["policy"])
    assert policy[0] == "replicated" and policy[-1] == "sharded", policy
    assert tuple(out[0]["coord"]) in {(i, j) for i in range(2)
                                      for j in range(4)}


def test_vcycle_parity(ranks):
    """One FP64 V-cycle of the distributed hierarchy, joined, against
    stfem_tpu's single-device GMG.vmult."""
    out, _, ref = ranks
    np.testing.assert_allclose(_join_2x4(out, "vcycle"), ref["vref"],
                               rtol=1e-10, atol=1e-10)


def test_fgmres_parity(ranks):
    out, _, ref = ranks
    assert {int(o["fgmres_iters"]) for o in out} == {ref["itref"]}
    np.testing.assert_allclose(_join_2x4(out, "fgmres_x"), ref["xref"],
                               rtol=2e-4, atol=2e-5)


def test_round_trip(ranks):
    out, _, _ = ranks
    assert all(bool(o["round_trip"]) for o in out)


def test_minibench(ranks):
    """The 3D minibench's gates (tests/test_multichip_bench.py's, the
    collectives read as call counts) and stfem_tpu's iterations."""
    _, mbs, ref = ranks
    jmb = ref["jax_minibench"]
    for mb in mbs:
        assert mb["converged"] and mb["sharded_true_rel"] <= 1e-8, mb
        assert mb["iter_parity"], mb
        assert mb["sharded_iters"] == jmb["single_iters"], (mb, jmb)
        assert mb["single_iters"] == jmb["single_iters"], (mb, jmb)
        assert mb["solution_rel_diff"] <= SOLUTION_RTOL, mb
        assert mb["solution_match"], mb
        # the plain versions on the CPU: no kernel computed the residual
        assert mb["residual_kernel"] is None, mb
        assert mb["mesh"] == {"x": 2, "y": 2, "z": 2}
        assert "sharded" in mb["policy"] and "replicated" in mb["policy"]
        n_ex, n_ar = (mb["collectives"]["halo_exchanges"],
                      mb["collectives"]["all_reduces"])
        assert n_ex > 0 and n_ar <= max(100, n_ex // 4), mb["collectives"]
    assert len({mb["sharded_iters"] for mb in mbs}) == 1


@pytest.fixture
def one_rank(tmp_path):
    """A one-rank gloo group in this process, and its 3D layout."""
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/init",
                            rank=0, world_size=1,
                            timeout=timedelta(seconds=60))
    try:
        yield RankLayout.from_mesh(spatial_mesh(1, dim=3, shard_z=True,
                                                device_type="cpu"))
    finally:
        dist.destroy_process_group()


def _hierarchy_3d(dtype=torch.float64):
    mesh = StructuredMesh([2] * 3, [0.0] * 3, [1.0] * 3, refinement=1)
    params = GMGParams(smoothing_steps=1, variable=False,
                       smoother_inner_iterations=2,
                       skip_identity_levels=True,
                       coarse_grid_smoother_type="Direct", relaxation=0.7)
    return mesh, build_stmg(mesh, 1, 2, TimeStepType.DG, 2, 1 / 16, params,
                            dtype=dtype, device="cpu", fe_degree_min=1)


def test_one_rank_round_trip_and_hierarchy(one_rank):
    """On one rank: the round trip is the identity, bitwise, and the
    distributed hierarchy -- every level but the coarsest split, or none
    -- computes the global V-cycle bitwise, without mutating it."""
    mesh, g = _hierarchy_3d()
    x = torch.as_tensor(np.random.default_rng(5).standard_normal(
        (4,) + mesh.dof_shape(2)))
    assert torch.equal(gather_block_vector(shard_block_vector(x, one_rank,
                                                              2), one_rank),
                       x)
    levels, transfers = list(g.levels), list(g.transfers)
    ref = g.vmult(x)
    n = len(g.levels)
    for policy in (["replicated"] + ["sharded"] * (n - 1), [None] * n):
        dg = install_level_shardings(g, policy, one_rank)
        assert torch.equal(dg.vmult(x), ref)
    assert g.levels == levels and g.transfers == transfers
    with pytest.raises(ValueError, match="coarsest"):
        install_level_shardings(g, ["sharded"] * n, one_rank)


def test_krylov_norm_bitwise(one_rank):
    """richardson_solve and fgmres without a norm (and dot) are the
    solvers as they were: bitwise the same with the plain 2-norm and
    matmul given, and with the one-rank layout's."""
    mesh, g = _hierarchy_3d(torch.float32)
    K, M = (LaplaceMassOperator(mesh, 2, 3, ms, ls, dtype=torch.float32,
                                device="cpu")
            for ms, ls in ((0.0, 1.0), (1.0, 0.0)))
    A, B, _, _ = get_fe_time_weights(JT.DG, 1, 1 / 16, 2)
    mat = SystemMatrix(K, M, A, B)
    b = mat.vmult(torch.as_tensor(np.random.default_rng(2).standard_normal(
        (4,) + mesh.dof_shape(2)), dtype=torch.float32))
    x0 = torch.zeros_like(b)
    opts = one_rank.krylov_options(b.shape, b.dtype, b.device)
    rich = lambda **o: krylov.richardson_solve(
        mat.vmult, b, x0, g.vmult, maxiter=6, reltol=1e-9, **o)
    gmres = lambda **o: krylov.fgmres(mat.vmult, b, x0, g.vmult, maxiter=6,
                                      reltol=1e-9, **o)
    for kw in ({"norm": krylov._norm, "dot": torch.matmul}, opts):
        for plain, given in ((rich(), rich(norm=kw["norm"])),
                             (gmres(), gmres(**kw))):
            assert plain.iterations == given.iterations > 0
            assert plain.residual == given.residual
            assert torch.equal(plain.x, given.x)


def _vankas(g):
    return [lvl.smoother.precond for lvl in g.levels
            if hasattr(lvl.smoother, "precond")]


def test_vanka_shard_whole_mesh_bitwise():
    """The global-valence Vanka on a one-rank "mesh" (all cells) is the
    unsharded Vanka, bitwise."""
    mesh, g = _hierarchy_3d()
    for v in _vankas(g):
        x = torch.as_tensor(np.random.default_rng(1).standard_normal(
            (v.n_blocks,) + tuple(int(c) * v.k + 1 for c in v.cells)))
        whole = v.shard([(0, int(c)) for c in v.cells])
        assert torch.equal(whole.vmult(x), v.vmult(x))


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_vanka_shard_partial_sums(axis):
    """Two slabs along an axis: each slab's Vanka on its consistent
    slice, the partial sums of the shared plane added, is the global
    Vanka (the valence of the shared plane is the global grid's 2)."""
    mesh, g = _hierarchy_3d()
    for v in _vankas(g):
        nc, k = [int(c) for c in v.cells], v.k
        if nc[axis] < 2:
            continue
        x = torch.as_tensor(np.random.default_rng(axis).standard_normal(
            (v.n_blocks,) + tuple(c * k + 1 for c in nc)))
        half = nc[axis] // 2
        parts = []
        for lo, hi in ((0, half), (half, nc[axis])):
            rng = [(0, c) for c in nc]
            rng[axis] = (lo, hi)
            parts.append(v.shard(rng).vmult(
                x.narrow(1 + axis, lo * k, (hi - lo) * k + 1)))
        shared = parts[0].narrow(1 + axis, half * k, 1) \
            + parts[1].narrow(1 + axis, 0, 1)
        joined = torch.cat([parts[0].narrow(1 + axis, 0, half * k), shared,
                            parts[1].narrow(1 + axis, 1,
                                            parts[1].shape[1 + axis] - 1)],
                           dim=1 + axis)
        torch.testing.assert_close(joined, v.vmult(x), rtol=1e-12,
                                   atol=1e-12)


def test_vanka_shard_rejects_cell_mode():
    mesh = StructuredMesh([2, 2], [0, 0], [1, 1], refinement=1)
    g = build_stmg(mesh, 1, 2, TimeStepType.DG, 2, 1 / 16,
                   GMGParams(relaxation=0.7), dtype=torch.float64,
                   device="cpu", fe_degree_min=1,
                   laplace_coefficient=lambda p: 1.0 + p[..., 0])
    v = _vankas(g)[-1]
    assert v.mode == "cell"
    with pytest.raises(ValueError, match="grid-mode"):
        v.shard([(0, 2), (0, 4)])


def test_raises_without_process_group():
    for call in (lambda: run_sharded_minibench(cells=4, ntao=2,
                                               device="cpu"),
                 lambda: dryrun.run_rank(cells=4, ntao=2, device="cpu"),
                 lambda: gather_block_vector(torch.zeros((1, 3, 3, 3)),
                                             None)):
        with pytest.raises(RuntimeError, match="process group"):
            call()


@pytest.mark.slow
def test_sharded_minibench_dryrun_size():
    """stfem_tpu's tests/test_multichip_bench.py on 8 gloo ranks: 8^3
    cells, ntao 8, Q4 x dG(2), z split; prints the counts."""
    outs = dryrun.dryrun_multichip(8, "cpu")
    for out in outs:
        assert out["converged"] and out["iter_parity"], out
        assert out["solution_rel_diff"] <= SOLUTION_RTOL, out
        assert out["mesh"]["z"] > 1
        n_ex, n_ar = (out["collectives"]["halo_exchanges"],
                      out["collectives"]["all_reduces"])
        assert n_ex > 0 and n_ar <= max(100, n_ex // 4), out["collectives"]
    print({k: outs[0][k] for k in ("single_iters", "sharded_iters",
                                   "single_true_rel", "sharded_true_rel",
                                   "solution_rel_diff", "collectives",
                                   "policy", "single_s", "sharded_s")})

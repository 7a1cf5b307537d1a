"""The explicit domain decomposition of stfem_tpu_torch.parallel against
stfem_tpu.parallel on the CPU (the counterpart of tests/test_halo.py's
fast tests).

One spawn of 8 gloo ranks (tests/torch_dist_ranks.py, which imports only
torch and the port) runs every multi-rank case: the sharded space-time
operator apply on test_halo.py's 8 x 8-cell mesh, split along x over 4
ranks at degrees 1 and 2 and over the 2 x 4 mesh (corners shared by four
ranks) at degree 2, each joined and held against stfem_tpu's
single-device SystemMatrix.vmult to 1e-10 in FP64; psum_dot / psum_norm
at degree 3 on the 2 x 4 mesh to 1e-12 relative; gather_metadata; the
periodic and open halo sums; two_level_mesh's axes and its local tile.
The ranks initialise through a file under tmp_path with a 60 s timeout,
and the spawn is joined for at most 90 s.  The host-side split, join and
masks are held to stfem_tpu's bitwise, spatial_mesh's shapes and
level_sharding_policy's decisions to stfem_tpu's, in this process."""
import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as tmp
from jax.sharding import PartitionSpec

from stfem_tpu.mesh.grid import StructuredMesh as JMesh
from stfem_tpu.ops.spatial import LaplaceMassOperator as JOp
from stfem_tpu.parallel import halo as jhalo
from stfem_tpu.parallel import sharding as jsharding
from stfem_tpu.stmg.gmg import GMGParams as JParams
from stfem_tpu.stmg.gmg import build_stmg as jbuild
from stfem_tpu.system import SystemMatrix as JSys
from stfem_tpu.time.tables import get_fe_time_weights
from stfem_tpu.types import TimeStepType as JT
from stfem_tpu_torch.mesh.grid import StructuredMesh
from stfem_tpu_torch.parallel import comm, halo, sharding
from stfem_tpu_torch.stmg.gmg import GMGParams, build_stmg
from stfem_tpu_torch.types import TimeStepType

import torch_dist_ranks

torch.set_num_threads(1)

TAU = 1.0 / 8
JOIN_S = 90


def _reference(degree, seed, n_steps=1):
    """(Alpha, Beta, x, stfem_tpu's SystemMatrix.vmult(x)) on the 8 x 8
    mesh, FP64."""
    mesh = JMesh([1, 1], [0, 0], [1, 1], refinement=3)
    K = JOp(mesh, degree, degree + 1, 0.0, 1.0)
    M = JOp(mesh, degree, degree + 1, 1.0, 0.0)
    A, B, _, _ = get_fe_time_weights(JT.DG, 1, TAU, n_steps)
    x = np.random.default_rng(seed).standard_normal(
        (A.shape[0],) + mesh.dof_shape(degree))
    return A, B, x, np.asarray(JSys(K, M, A, B).vmult(jnp.asarray(x)))


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Spawn the 8 ranks once; (their results by rank, the references)."""
    tmpd = tmp_path_factory.mktemp("ranks")
    refs = {d: _reference(d, d) for d in (1, 2)}
    refs["2d"] = _reference(2, 2)
    rng = np.random.default_rng(3)
    dots = [rng.standard_normal((2,) + JMesh([1, 1], [0, 0], [1, 1],
                                             refinement=3).dof_shape(3))
            for _ in range(2)]
    cases = {"split1d": {d: refs[d][:3] for d in (1, 2)},
             "split2d": refs["2d"][:3], "dots": dots}
    ctx = tmp.start_processes(
        torch_dist_ranks.run_ranks,
        args=(str(tmpd / "init"), str(tmpd), cases),
        nprocs=torch_dist_ranks.WORLD, join=False, start_method="spawn")
    deadline = time.time() + JOIN_S
    while not ctx.join(timeout=max(deadline - time.time(), 0.1)):
        if time.time() > deadline:
            for p in ctx.processes:
                p.kill()
            pytest.fail(f"the gloo ranks did not finish in {JOIN_S} s")
    out = [dict(np.load(tmpd / f"rank{r}.npz"))
           for r in range(torch_dist_ranks.WORLD)]
    return out, refs, dots


@pytest.mark.parametrize("degree", [1, 2])
def test_sharded_vmult_parity(ranks, degree):
    out, refs, _ = ranks
    parts = [out[r][f"split1d_{degree}"] for r in range(4)]
    y = halo.join_dof_grid(parts, degree, axis=1)
    np.testing.assert_allclose(y, refs[degree][3], rtol=1e-10, atol=1e-10)


def test_sharded_vmult_parity_2axis(ranks):
    out, refs, _ = ranks
    assert tuple(out[0]["mesh_shape"]) == (2, 4)
    grid = {tuple(o["coord"]): o["split2d"] for o in out}
    rows = [halo.join_dof_grid([grid[(i, j)] for j in range(4)], 2, axis=2)
            for i in range(2)]
    y = halo.join_dof_grid(rows, 2, axis=1)
    np.testing.assert_allclose(y, refs["2d"][3], rtol=1e-10, atol=1e-10)


def test_psum_dot_parity(ranks):
    out, _, (a, b) = ranks
    for o in out:
        np.testing.assert_allclose(float(o["dot"]), float(np.sum(a * b)),
                                   rtol=1e-12)
        np.testing.assert_allclose(float(o["norm"]),
                                   float(np.sqrt(np.sum(a * a))), rtol=1e-12)


def test_collectives(ranks):
    """gather_metadata in rank order; the open and periodic halo sums of
    ones over 4 ranks (an end plane without a neighbour keeps 1)."""
    out, _, _ = ranks
    want = np.array([[r, 10 * r] for r in range(8)], np.float64)
    for o in out:
        np.testing.assert_array_equal(o["gathered"], want)
    for r in range(4):
        np.testing.assert_array_equal(out[r]["periodic"],
                                      [[2.0] * 3, [2.0] * 3])
        ends = [1.0 if r == 0 else 2.0, 1.0 if r == 3 else 2.0]
        np.testing.assert_array_equal(out[r]["open"],
                                      [[ends[0]] * 3, [ends[1]] * 3])


def test_two_level_mesh(ranks):
    out, _, _ = ranks
    for o in out:
        assert tuple(o["two_level_names"]) == ("dcn", "x", "y")
        assert tuple(o["two_level_shape"]) == (2, 2, 2)
        assert tuple(o["two_level_tile"]) == (2, 2, 2)


def test_raises_without_process_group():
    x = torch.ones((2, 5, 5), dtype=torch.float64)
    for call in (lambda: comm.halo_accumulate(x, None, 1),
                 lambda: comm.psum_dot(x, x, (None,), (1,)),
                 lambda: comm.gather_metadata(x),
                 lambda: comm.two_level_mesh(1, (1, 1)),
                 lambda: sharding.spatial_mesh(1),
                 lambda: halo.make_sharded_vmult(_Identity(), None)(x)):
        with pytest.raises(RuntimeError, match="process group"):
            call()


class _Identity:
    def vmult(self, x):
        return x


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_split_join_mask_bitwise(degree):
    """split_dof_grid (on NumPy and on tensors), join_dof_grid, local_mask
    and local_submesh against stfem_tpu's."""
    jm = JMesh([1, 1], [0, 0], [1, 1], refinement=3)
    tm = StructuredMesh([1, 1], [0, 0], [1, 1], refinement=3)
    x = np.random.default_rng(degree).standard_normal(
        (2,) + jm.dof_shape(degree))
    for axis, n in ((1, 4), (2, 2), (1, 8)):
        jparts = jhalo.split_dof_grid(x, n, degree, axis)
        tparts = halo.split_dof_grid(x, n, degree, axis)
        xparts = halo.split_dof_grid(torch.as_tensor(x), n, degree, axis)
        for j, t, u in zip(jparts, tparts, xparts):
            np.testing.assert_array_equal(t, j)
            np.testing.assert_array_equal(u.numpy(), j)
        np.testing.assert_array_equal(
            halo.join_dof_grid(tparts, degree, axis),
            jhalo.join_dof_grid(jparts, degree, axis))
        np.testing.assert_array_equal(
            halo.join_dof_grid(xparts, degree, axis).numpy(), x)
    for shard, n in ((2, 4), ((1, 3), (2, 4)), ((0, 1), (4, 2))):
        np.testing.assert_array_equal(
            halo.local_mask(tm, degree, shard, n),
            jhalo.local_mask(jm, degree, shard, n))
        js, ts = (jhalo.local_submesh(jm, shard, n),
                  halo.local_submesh(tm, shard, n))
        assert tuple(ts.cells) == tuple(js.cells)
        np.testing.assert_array_equal(ts.h, js.h)
        np.testing.assert_array_equal(ts.lower, js.lower)
        np.testing.assert_array_equal(ts.upper, js.upper)


def test_spatial_mesh_shapes():
    for n in range(1, 9):
        for dim in (1, 2, 3):
            for shard_z in (False, True):
                jm = jsharding.spatial_mesh(n, dim=dim, shard_z=shard_z)
                shape, names = sharding.spatial_mesh_shape(n, dim, shard_z)
                assert shape == jm.devices.shape, (n, dim, shard_z)
                assert names == tuple(jm.axis_names)
                assert sharding.block_vector_spec(names, dim) == tuple(
                    jsharding.block_vector_spec(jm, dim))


def test_level_sharding_policy():
    """The decisions on test_halo.py's slow hierarchy (8 x 8 cells, Q2,
    dG(1), 2 steps) with 8 devices and 24 dofs a device: sharded where
    stfem_tpu's spec splits the level, replicated where it does not."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("STFEM_EIG_CACHE", "0")
        jg = jbuild(JMesh([1, 1], [0, 0], [1, 1], refinement=3), 1, 2,
                    JT.DG, 2, TAU, dtype=jnp.float32, fe_degree_min=1,
                    params=JParams(smoothing_steps=2, variable=False,
                                   coarse_grid_smoother_type="Direct"))
        tg = build_stmg(StructuredMesh([1, 1], [0, 0], [1, 1],
                                       refinement=3), 1, 2, TimeStepType.DG,
                        2, TAU, GMGParams(smoothing_steps=2, variable=False,
                                          coarse_grid_smoother_type="Direct"),
                        dtype=torch.float32, device="cpu", fe_degree_min=1)
    specs = [s.spec for s in jsharding.level_sharding_policy(
        jsharding.spatial_mesh(8, dim=2), jg, min_dofs_per_device=24)]
    got = sharding.level_sharding_policy(8, tg, min_dofs_per_device=24)
    assert got == ["replicated" if s == PartitionSpec() else "sharded"
                   for s in specs]
    assert "sharded" in got and "replicated" in got
    assert sharding.level_sharding_policy(8, tg) == ["replicated"] * len(got)

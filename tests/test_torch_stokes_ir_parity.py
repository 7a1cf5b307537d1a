"""Slab-by-slab parity of the Stokes iterative-refinement march (CPU, x64):
stfem_tpu_torch.bench_stokes.run against stfem_tpu's run_stokes_bench IR
branch (bench.py:287-398), rebuilt here from the same stfem_tpu pieces so
that each slab's V-cycle count, probe floor and TRUE residual can be read
(bench.py prints only the mean count and the larger floor).  Both marches
take the same FP64 force (bench_stokes.force_slab, which
test_torch_stokes.py holds to bench.py's form).

As a test: 4^3 cells, 4 steps per slab, 2 slabs.  Every slab's V-cycles
(first solve + correction) equal to +-1, each probe floor within a factor
of 2 (a float32 stall level: its digits are rounding noise), and TRUE <=
1e-8 on every slab of both.

As a script, at the bench's size (tens of minutes on a CPU):

    JAX_PLATFORMS=cpu python -m tests.test_torch_stokes_ir_parity \
        --cells 8 --ntao 8 --slabs 2 [--bench]

prints one JSON line per march and their per-slab counts side by side;
--bench also runs bench.py's run_stokes_bench at the same size on the CPU,
whose mean count and floor check the rebuilt march.
"""
import json
import os
import time

import numpy as np
import torch

TAU = 1.0 / 16.0
MAXITER = 60


def forces64(cells: int, ntao: int, n_slabs: int):
    """[n_slabs, T, n_u + n_p] float64 forces of bench_stokes (numpy)."""
    from stfem_tpu_torch import bench_stokes
    from stfem_tpu_torch.mesh.grid import StructuredMesh
    from stfem_tpu_torch.ops.stokes import StokesOperator
    from stfem_tpu_torch.time.tables import get_fe_time_weights, get_time_quad
    from stfem_tpu_torch.types import TimeStepType

    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3,
                          refinement=int(np.log2(cells // 2)))
    S64 = StokesOperator(mesh, 2, 1, 3, 1.0, dtype=torch.float64,
                         device="cpu")
    tq = get_time_quad(TimeStepType.DG, 1)[0]
    a1 = get_fe_time_weights(TimeStepType.DG, 1, TAU, 1)[0]
    t_off = np.array([TAU * it + TAU * float(q) for it in range(ntao)
                      for q in tq])
    sc = np.array([a1[j, j] for _ in range(ntao) for j in range(len(tq))])
    return np.stack([bench_stokes.force_slab(mesh, S64,
                                             i * TAU * ntao + t_off,
                                             sc).numpy()
                     for i in range(n_slabs)])


def jax_ir_march(cells: int, ntao: int, n_slabs: int, f64):
    """bench.py's Stokes IR march with stfem_tpu on the CPU: the probe over
    slabs 0 and 1, rtol1 / ir_rtol from the larger floor, then n_slabs
    slabs, each verified by the float-float residual.  Returns a dict of
    per-slab V-cycles, probe floors and TRUE residuals."""
    import jax
    import jax.numpy as jnp

    from stfem_tpu.krylov import richardson_solve
    from stfem_tpu.mesh.grid import StructuredMesh
    from stfem_tpu.ops.ff_stokes import build_ff_stokes_residual
    from stfem_tpu.ops.floatfloat import ff_add_f32, ff_from_f64
    from stfem_tpu.ops.spatial import LaplaceMassOperator
    from stfem_tpu.ops.stokes import StokesOperator
    from stfem_tpu.stmg.gmg import GMGParams, build_stmg_stokes
    from stfem_tpu.system_stokes import StokesSystemMatrix
    from stfem_tpu.time.tables import get_fe_time_weights
    from stfem_tpu.types import TimeStepType

    dg, f32 = TimeStepType.DG, jnp.float32
    t_setup = time.time()
    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3,
                          refinement=int(np.log2(cells // 2)))
    S = StokesOperator(mesh, 2, 1, 3, 1.0, dtype=f32)
    Mu = LaplaceMassOperator(mesh, 2, 3, 1.0, 0.0, dtype=f32,
                             mask=S.mask_u_np)
    a, b, g, _ = get_fe_time_weights(dg, 1, TAU, ntao)
    matrix = StokesSystemMatrix(S, Mu, a, b)
    rhs_matrix = StokesSystemMatrix(S, Mu, a, b, gamma=None, zeta=g,
                                    type_=dg)
    gmg = build_stmg_stokes(
        mesh, 1, dg, ntao, TAU, viscosity=1.0, dtype=f32,
        params=GMGParams(smoothing_range=5.0, smoothing_steps=1,
                         coarse_grid_smoother_type="Smoother"),
        fe_degree_min=1)
    S64 = StokesOperator(mesh, 2, 1, 3, 1.0, dtype=jnp.float64)
    ffres = build_ff_stokes_residual(S64, a, b, zeta=g)
    fhi, flo = ff_from_f64(jnp.asarray(f64))
    setup_s = time.time() - t_setup
    T, n_flat, dim = a.shape[0], S.n_u + S.n_p, 3
    detj = float(np.prod(mesh.h))

    # the operators go in as arguments, as in bench.py: closed over, their
    # arrays would be compiled in as constants
    @jax.jit
    def stage(matrix, rhs_matrix, gmg, ffres, prev_ff, x_base32, fh, fl,
              reltol, is_corr):
        one = jnp.asarray(1.0, f32)

        def prolog_first(_):
            pu = prev_ff[0][:S.n_u].reshape((dim,) + S.dof_shape_u)
            pp = prev_ff[0][S.n_u:].reshape(S.p_shape)
            rhs = rhs_matrix.vmult_slice(pu, pp).astype(f32) + fh
            return rhs, jnp.broadcast_to(prev_ff[0], (T, n_flat)), one, one

        def prolog_corr(_):
            x_ff = (x_base32, jnp.zeros_like(x_base32))
            (r_hi, _), rnorm, bn = ffres.residual(prev_ff, x_ff, (fh, fl))
            return r_hi / rnorm, jnp.zeros((T, n_flat), f32), rnorm, bn

        rhs, x0, rnorm, bn = jax.lax.cond(is_corr, prolog_corr,
                                          prolog_first, None)
        res = richardson_solve(lambda v: matrix.vmult(v).astype(f32), rhs,
                               x0, lambda v: gmg.vmult(v).astype(f32),
                               maxiter=MAXITER, abstol=1e-30, reltol=reltol)
        x_ff = ff_add_f32((x_base32, jnp.zeros_like(x_base32)),
                          rnorm * res.x)
        return x_ff, res.iterations, rnorm, bn

    @jax.jit
    def verify(ffres, prev_ff, x_ff, fh, fl):
        _, rn, bn = ffres.residual(prev_ff, x_ff, (fh, fl))
        return rn, bn

    @jax.jit
    def carry(x_ff):
        u, p = S.unpack(x_ff[0])
        means = jnp.sum(p[..., 0], axis=tuple(range(1, dim + 1))) * detj
        p = p.at[..., 0].add(-means.reshape((T,) + (1,) * dim))
        return S.pack(u, p)[-1], x_ff[1][-1]

    def slab(prev_ff, i, rtol1, ir_rtol):
        zero = jnp.zeros((T, n_flat), f32)
        ops = (matrix, rhs_matrix, gmg, ffres, prev_ff)
        x1, it, _, _ = stage(*ops, zero, fhi[i], flo[i], rtol1, False)
        x_ff, extra, rnorm, bn = stage(*ops, x1[0], fhi[i], flo[i],
                                       ir_rtol, True)
        return x_ff, int(it) + int(extra), float(rnorm) / float(bn)

    prev0 = jnp.zeros(n_flat, f32)
    p0 = (prev0, jnp.zeros_like(prev0))
    x, _, floor0 = slab(p0, 0, np.float32(1e-8), np.float32(2.0))
    floors = [floor0, slab(carry(x), 1, np.float32(1e-8),
                           np.float32(2.0))[2]]
    floor = max(floors)
    rtol1 = np.float32(max(1.4 * floor, 1e-8))
    ir_rtol = np.float32(min(max(0.5e-8 / max(floor, 1e-12), 1e-7), 2e-3))
    prev, iters, rels = p0, [], []
    for i in range(n_slabs):
        x_ff, its, _ = slab(prev, i, rtol1, ir_rtol)
        rn, bn = verify(ffres, prev, x_ff, fhi[i], flo[i])
        iters.append(its)
        rels.append(float(rn) / float(bn))
        prev = carry(x_ff)
    return dict(package="stfem_tpu", iters=iters, probe_floors=floors,
                true_rels=rels, setup_s=setup_s)


def torch_ir_march(cells: int, ntao: int, n_slabs: int):
    from stfem_tpu_torch import bench_stokes
    info, _ = bench_stokes.run(cells, ntao, n_slabs=n_slabs, device="cpu")
    return dict(package="stfem_tpu_torch", iters=info["iters"],
                probe_floors=info["probe_floors"],
                true_rels=info["true_rels"], setup_s=info["setup_s"])


def test_stokes_ir_march_per_slab():
    torch.set_num_threads(1)
    cells, ntao, n_slabs = 4, 4, 2
    j = jax_ir_march(cells, ntao, n_slabs, forces64(cells, ntao, n_slabs))
    t = torch_ir_march(cells, ntao, n_slabs)
    for i in range(n_slabs):
        assert abs(t["iters"][i] - j["iters"][i]) <= 1, (i, t, j)
        assert t["true_rels"][i] <= 1e-8 and j["true_rels"][i] <= 1e-8
    for tf, jf in zip(t["probe_floors"], j["probe_floors"]):
        assert 0.5 <= tf / jf <= 2.0, (t, j)


def main(argv=None):
    import argparse

    import jax
    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--cells", type=int, default=8)
    ap.add_argument("--ntao", type=int, default=8)
    ap.add_argument("--slabs", type=int, default=2)
    ap.add_argument("--bench", action="store_true",
                    help="also run bench.py's run_stokes_bench")
    args = ap.parse_args(argv)
    # one thread, as the tests: torch's multi-threaded batched CPU inverse
    # (the Vanka patch factors) has hung on some hosts
    torch.set_num_threads(1)
    t0 = time.time()
    t = torch_ir_march(args.cells, args.ntao, args.slabs)
    t["wall_s"] = time.time() - t0
    print(json.dumps(t), flush=True)
    t0 = time.time()
    j = jax_ir_march(args.cells, args.ntao, args.slabs,
                     forces64(args.cells, args.ntao, args.slabs))
    j["wall_s"] = time.time() - t0
    print(json.dumps(j), flush=True)
    print("slab  V-cycles torch / jax   TRUE torch / jax")
    for i in range(args.slabs):
        print(f"{i:4d}  {t['iters'][i]:5d} / {j['iters'][i]:<5d}  "
              f"{t['true_rels'][i]:.3e} / {j['true_rels'][i]:.3e}")
    print("probe floors torch", t["probe_floors"], "jax", j["probe_floors"],
          flush=True)
    if args.bench:
        import bench
        os.environ.update(STFEM_BENCH_STOKES_CELLS=str(args.cells),
                          STFEM_BENCH_STOKES_NTAO=str(args.ntao),
                          STFEM_BENCH_STOKES_SLABS=str(args.slabs))
        cpu = jax.devices("cpu")[0]
        bench.run_stokes_bench(jax, jax.numpy, cpu, cpu)


if __name__ == "__main__":
    main()

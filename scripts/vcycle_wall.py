"""Wall time of one Stokes V-cycle on the card, for A/B runs of two trees.

Builds two float32 Stokes STMG hierarchies as their paths build them:
  bench  bench_stokes.py's (3D Q2^3 x DGP1, dG(1), 8^3 cells, 8 steps a
         slab, smoothing range 5);
  lid    configs/tp03stokes_lid_2d.json's through drivers/tp03stokes.py's
         factory (2D, the Nitsche lid face, 256^2 cells, one step);
then times `repeats` V-cycles on one unit vector (host clock, each ended
by a synchronise) and one more under torch.profiler.  Prints one JSON
line per hierarchy: the setup, every V-cycle wall, their median, the
profiled V-cycle's wall, device busy share and kernel launches.

    python scripts/vcycle_wall.py [--root DIR] [--repeats 5] [--device cuda]

--root names the checkout whose stfem_tpu_torch is imported (default:
this script's own); the script uses only interfaces the port has had
since its Stokes application landed, so one call can time a parent
checkout and the change, e.g. parent, change, change, parent.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import sys
import time

import torch


def _bench_hierarchy(device):
    from stfem_tpu_torch.mesh.grid import StructuredMesh
    from stfem_tpu_torch.stmg.gmg import GMGParams, build_stmg_stokes
    from stfem_tpu_torch.types import TimeStepType

    mesh = StructuredMesh([2, 2, 2], [0.0] * 3, [1.0] * 3, refinement=2)
    return build_stmg_stokes(mesh, 1, TimeStepType.DG, 8, 1.0 / 16.0,
                             params=GMGParams(smoothing_range=5.0),
                             dtype=torch.float32, device=device)


def _lid_hierarchy(device):
    from stfem_tpu_torch.config import Parameters
    from stfem_tpu_torch.drivers import tp03stokes
    from stfem_tpu_torch.drivers.stokes import _step_geometry

    p = Parameters.parse(str(tp03stokes.LID_2D), 2)
    mesh, tau = _step_geometry(p.refinement, p.end_time, min_steps=1)
    ctx = dict(mesh=mesh, fe_degree=p.fe_degree, type_=p.type,
               n_timesteps_at_once=p.n_timesteps_at_once, time_step=tau,
               viscosity=1.0, weak_faces=((0, 1),), device=device)
    return tp03stokes.stmg_factory(p)(ctx)


def measure(name: str, build, device, repeats: int) -> dict:
    from stfem_tpu_torch.bench_heat import _sync, profile_slab

    _sync(device)
    t0 = time.time()
    gmg = build(device)
    _sync(device)
    setup_s = time.time() - t0
    top = gmg.levels[-1]
    gen = torch.Generator(device=device).manual_seed(0)
    v = torch.randn((top.n_blocks,) + tuple(top.dof_shape), generator=gen,
                    device=device)
    v = v / v.norm()
    gmg.vmult(v)                                  # warm-up
    walls = []
    for _ in range(repeats):
        _sync(device)
        t0 = time.time()
        gmg.vmult(v)
        _sync(device)
        walls.append(time.time() - t0)
    prof = profile_slab(lambda: gmg.vmult(v), device, top=4)
    return dict(hierarchy=name, setup_s=setup_s, vcycle_s=walls,
                median_s=statistics.median(walls),
                profiled_wall_s=prof["wall_s"],
                device_busy_share=prof["device_busy_share"],
                n_kernel_launches=prof["n_kernel_launches"],
                root=sys.path[0],
                device=(torch.cuda.get_device_name(device)
                        if device.type == "cuda" else "cpu"))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(a.root))
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("vcycle_wall: no CUDA device")
    for name, build in (("bench", _bench_hierarchy),
                        ("lid", _lid_hierarchy)):
        print(json.dumps(measure(name, build, device, a.repeats)),
              flush=True)
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

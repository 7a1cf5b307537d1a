"""The trace reader and every metric of BENCHMARK.json read the same
values from a trace that holds the program's own ranges (the spans of
stfem_tpu_torch/utils/timer.py under tracing(profiler=True)) as from the
same trace without them: a synthetic trace with hand-placed program
ranges, and a CPU profile of a tiny march's slab.  Only the idle gaps'
labels may name a program range (the innermost range at a gap where no
op runs)."""
import json

import pytest
import torch

from benchmark import spec, trace
from benchmark.marches import heat
from benchmark.tests.conftest import tiny_config
from benchmark.tests.test_stbench_trace import ev, synthetic
from stfem_tpu_torch.utils import timer

PREFIXES = ("stmg.", "sysmat.", "vanka.", "transfer.", "krylov.",
            "residual64", "kernels.")


def with_program_ranges():
    """synthetic() with program ranges around its ops: the V-cycle and
    its stages, a Vanka apply round the cast, an operator apply round the
    relayout (its time mixing round the copy), the coarse solve over an
    idle gap, and the residual with a host norm read."""
    return synthetic() + [
        ev("cpu", "stmg.vcycle", 12, 398, corr=201),
        ev("cpu", "stmg.smooth.L1", 15, 66, corr=202),
        ev("cpu", "vanka.vmult", 16, 65, corr=203),
        ev("cpu", "stmg.residual.L1", 68, 100, corr=204),
        ev("cpu", "sysmat.vmult", 69, 99, corr=205),
        ev("cpu", "sysmat.time_mix", 70, 91, corr=206),
        ev("cpu", "stmg.coarse.L0", 250, 350, corr=207),
        ev("cpu", "residual64", 505, 895, corr=208),
        ev("cpu", "krylov.norm_read", 590, 885, corr=209),
    ]


def cpu_profile():
    """The events of one slab of the tiny march on the CPU under the
    profiler, the harness's spans and the program's ranges both on."""
    from torch.profiler import ProfilerActivity, profile
    with open(spec.HERE / "traffic" / "march.json") as f:
        traffic = json.load(f)
    program = heat.Program(tiny_config(), "cpu")
    march = heat.march(program, traffic, 11)
    march.probe()
    march.slab()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with timer.tracing(profiler=True):
            march.spans = True
            march.slab()
            march.spans = False
    timer.clear()
    events, _ = trace.events_from_profiler(prof, heat.SPANS)
    return events


def summary(events, probes):
    """The summary the metric readers take, from events."""
    tsum = trace.summarize(events, heat.SPANS,
                           {n: k for n, k, _, _ in probes})
    tsum["kernel_bounds"] = {n: {"calls": tsum["groups"][n]["count"],
                                 "bound_s": 0.5 * tsum["groups"][n]
                                 ["device_s"]} for n, _, _, _ in probes}
    tsum["slabs"] = 2
    window = {"slabs": 10, "elapsed_s": 4.0, "slab_walls_s": [0.4] * 10,
              "dofs_per_slab": 1000, "vcycles": 100, "vcycle_host_s": 2.0}
    return {"window": window, "trace": tsum,
            "setup": {"setup_s": 10.0, "hierarchy_build_s": 2.0}}


@pytest.mark.parametrize("source", ["synthetic", "cpu_profile"])
def test_existing_metrics_unchanged_by_program_ranges(source,
                                                      monkeypatch):
    monkeypatch.setenv("STFEM_EIG_CACHE", "0")
    torch.set_num_threads(1)
    events = (with_program_ranges() if source == "synthetic"
              else cpu_profile())
    without = [e for e in events if not e["name"].startswith(PREFIXES)]
    assert len(without) < len(events)
    bench = spec.load_benchmark()
    probes = spec.kernel_probes(bench["per_layer"])
    a, b = summary(events, probes), summary(without, probes)
    for key in a["trace"]:
        if key != "idle_gaps":
            assert a["trace"][key] == b["trace"][key], key
    assert (sum(v for _, v in a["trace"]["idle_gaps"])
            == pytest.approx(sum(v for _, v in b["trace"]["idle_gaps"])))
    read = 0
    for m in bench["end_to_end"] + bench["per_layer"]:
        va, vb = (spec.reader(m["name"])(s) for s in (a, b))
        assert va == vb, m["name"]
        read += va is not None
    assert read >= (10 if source == "synthetic" else 5)
    if source == "synthetic":
        # the gap in the V-cycle at 280 us is now named by the coarse
        # solve's range
        gaps = dict(a["trace"]["idle_gaps"])
        assert gaps["vcycle:stmg.coarse.L0"] == pytest.approx(40e-6)

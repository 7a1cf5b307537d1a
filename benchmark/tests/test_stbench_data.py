"""The seeded data: one seed one problem, every seed the same sizes, and
the program's forcing callable equal to the modes' formula."""
import numpy as np
import pytest
import torch

from benchmark import data as slab_data
from benchmark.reference import fe
from benchmark.spec import HERE

import json

TRAFFIC = json.loads((HERE / "traffic" / "march.json").read_text())


def test_same_seed_same_data_and_sizes():
    a = slab_data.make(2 ** 31 + 5, TRAFFIC, 2.0)
    b = slab_data.make(2 ** 31 + 5, TRAFFIC, 2.0)
    c = slab_data.make(-3, TRAFFIC, 2.0)
    for f in ("amplitude", "waves", "offset", "period", "phase"):
        assert np.array_equal(getattr(a.forcing, f), getattr(b.forcing, f))
    assert not (np.array_equal(a.forcing.amplitude, c.forcing.amplitude)
                and np.array_equal(a.forcing.waves, c.forcing.waves))
    # the same magnitudes, wave-number sets, periods and phases on every
    # seed: the same work
    assert np.allclose(np.abs(a.forcing.amplitude),
                       np.abs(c.forcing.amplitude))
    assert np.array_equal(np.sort(a.forcing.waves), np.sort(c.forcing.waves))
    assert np.array_equal(a.forcing.period, c.forcing.period)
    assert np.array_equal(a.forcing.phase, c.forcing.phase)


def test_forcing_field_matches_modes():
    d = slab_data.make(7, TRAFFIC, 2.0)
    f = slab_data.ForcingField(d.forcing)
    g = torch.Generator().manual_seed(0)
    pts = torch.rand((2, 3, 4, 3), generator=g, dtype=torch.float64)
    ts = torch.tensor([0.3, 1.7], dtype=torch.float64)
    batched = f(pts, ts.reshape(-1, 1, 1, 1))
    p = pts.numpy()
    for j, t in enumerate(ts.tolist()):
        want = sum(d.forcing.time_factors(np.array([t]))[0, m]
                   * np.prod([d.forcing.space_1d(m, k, p[..., k])
                              for k in range(3)], axis=0)
                   for m in range(d.forcing.amplitude.size))
        assert np.allclose(batched[j].numpy(), want, rtol=1e-13)
        assert np.allclose(f(pts, t).numpy(), want, rtol=1e-13)


def test_initial_state_vanishes_on_the_boundary():
    d = slab_data.make(1, TRAFFIC, 2.0)
    u = slab_data.initial_state(d, [4, 4, 4], 2, "cpu")
    assert u.shape == (9, 9, 9)
    for ax in range(3):
        assert float(u.select(ax, 0).abs().max()) < 1e-14
        assert float(u.select(ax, -1).abs().max()) < 1e-14
    x = fe.node_coordinates_1d(4, 2)
    i = 3
    want = sum(d.initial.amplitude[m] * np.prod(
        [d.initial.space_1d(m, k, np.array([x[i]]))[0] for k in range(3)])
        for m in range(d.initial.amplitude.size))
    assert float(u[i, i, i]) == pytest.approx(want, rel=1e-13)

"""What the K5 wrapper (ops/quad_middle.py) computes in Python for the FP64
tensor-core kernel, on the CPU: the tile plan and the zero-padded tables.

- tile_plan: every (block t, cell c) row is owned by exactly one tile row,
  for ragged T and C, with at most 64 rows a tile (the kernel's M tile),
  following the row map the kernel uses (tile_plan's docstring).
- pad_tables: quad_middle_reference on the padded PhiG/W (ub, ua padded
  with zero dofs, the padded dofs dropped from the output) equals it on
  the originals to 1e-14 in FP64 (the added products are exact zeros, so
  only the summation's grouping can differ); padded shapes are multiples
  of the kernel's 16 dofs and 32 columns; at the Q3 shape the tables
  pass through uncopied."""
import numpy as np
import pytest
import torch

from stfem_tpu_torch.ops.quad_middle import (CHUNK, TILE_ROWS, pad_tables,
                                             quad_middle_reference, tile_plan)


@pytest.mark.parametrize("T", [1, 2, 3, 5, 8, 9, 17, 24, 33])
@pytest.mark.parametrize("C", [1, 7, 27, 100, 4096])
def test_tile_plan_covers_every_row_once(T, C):
    tt, cc = tile_plan(T, C)
    assert 1 <= tt <= 8 and 1 <= cc and tt * cc <= TILE_ROWS
    count = np.zeros((T, C), np.int64)
    for by in range(-(-T // tt)):
        for bx in range(-(-C // cc)):
            for r in range(TILE_ROWS):
                if r >= tt * cc:
                    continue
                t, c = by * tt + r // cc, bx * cc + r % cc
                if t < T and c < C:
                    count[t, c] += 1
    assert (count == 1).all()


def test_tile_plan_main_shapes():
    # the tp_01 outer operator (24 blocks) fills 64-row tiles of 8 x 8;
    # the rhs slice (3 rows) 3 x 21
    assert tile_plan(24, 4096) == (8, 8)
    assert tile_plan(3, 4096) == (3, 21)


@pytest.mark.parametrize("T,C,A,Q,dim", [(3, 10, 27, 27, 3), (5, 7, 16, 16, 2),
                                         (2, 9, 9, 9, 2), (4, 6, 64, 64, 3),
                                         (1, 5, 125, 125, 3)])
def test_padded_tables_give_the_same_middle(T, C, A, Q, dim):
    rng = np.random.default_rng(T * C + A)
    NQ = (1 + dim) * Q
    ub, ua = (torch.as_tensor(rng.standard_normal((T, C, A)))
              for _ in range(2))
    PhiG = torch.as_tensor(rng.standard_normal((A, NQ)))
    W = torch.as_tensor(np.abs(rng.standard_normal((C, NQ))))
    P, Wp, qp = pad_tables(PhiG, W, Q)
    ap, nqp = P.shape
    assert ap % 16 == 0 and ap - A < 16 and Wp.shape == (C, nqp)
    assert qp % CHUNK == 0 and (nqp - qp) % CHUNK == 0
    assert qp - Q < CHUNK and nqp - qp - (NQ - Q) < CHUNK
    if (ap, qp, nqp) == (A, Q, NQ):
        assert P is PhiG and Wp is W
    pad = lambda u: torch.nn.functional.pad(u, (0, ap - A))
    got = quad_middle_reference(pad(ub), pad(ua), P, Wp, qp)
    assert bool((got[..., A:] == 0).all())
    ref = quad_middle_reference(ub, ua, PhiG, W, Q)
    err = float((got[..., :A] - ref).abs().max() / ref.abs().max())
    assert err <= 1e-14

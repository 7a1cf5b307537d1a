"""stfem_tpu_torch host tables vs stfem_tpu: the copied NumPy modules
(time quadrature/tables/transfers, MG ladder logic, 1D shape data) must give
EXACTLY the same arrays and sequences (tolerance 0)."""
import numpy as np
import pytest

from stfem_tpu import types as jtypes
from stfem_tpu.mesh import fe as jfe
from stfem_tpu.stmg import transfers as jtr
from stfem_tpu.time import mg_seq as jmg
from stfem_tpu.time import tables as jtab
from stfem_tpu.time import transfer as jtt
from stfem_tpu_torch import types as ttypes
from stfem_tpu_torch.mesh import fe as tfe
from stfem_tpu_torch.stmg import transfers as ttr
from stfem_tpu_torch.time import mg_seq as tmg
from stfem_tpu_torch.time import tables as ttab
from stfem_tpu_torch.time import transfer as ttt


def _enum(e, module):
    """The same-named member of the other package's enum."""
    return getattr(getattr(module, type(e).__name__), e.name)


def _eq(a, b):
    if isinstance(a, (tuple, list)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _eq(x, y)
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


CASES = [(t, r) for t in ("DG", "CGP") for r in range(4)
         if not (t == "CGP" and r == 0)]


@pytest.mark.parametrize("tname,r", CASES)
def test_time_tables_equal(tname, r):
    jt, tt = jtypes.TimeStepType[tname], ttypes.TimeStepType[tname]
    for n_at_once in (1, 2, 4):
        _eq(jtab.get_fe_time_weights(jt, r, 0.125, n_at_once),
            ttab.get_fe_time_weights(tt, r, 0.125, n_at_once))
    _eq(jtab.get_time_quad(jt, r), ttab.get_time_quad(tt, r))


@pytest.mark.parametrize("tname,r", CASES)
def test_time_transfers_equal(tname, r):
    jt, tt = jtypes.TimeStepType[tname], ttypes.TimeStepType[tname]
    for n in (2, 4):
        _eq(jtt.get_time_prolongation_matrix(jt, r, n),
            ttt.get_time_prolongation_matrix(tt, r, n))
        _eq(jtt.get_time_restriction_matrix(jt, r, n),
            ttt.get_time_restriction_matrix(tt, r, n))
        for r2 in range(1 if tname == "CGP" else 0, r):
            _eq(jtt.get_time_projection_matrix(jt, r2, r, n),
                ttt.get_time_projection_matrix(tt, r2, r, n))
            _eq(jtt.get_time_projection_matrix(jt, r, r2, n),
                ttt.get_time_projection_matrix(tt, r, r2, n))


@pytest.mark.parametrize("n_sp_lvl,k,p,ntao", [(2, 2, 4, 4), (4, 2, 4, 32),
                                                (3, 3, 2, 8), (1, 1, 1, 2)])
def test_mg_sequence_equal(n_sp_lvl, k, p, ntao):
    seqs = []
    for mod, ty in ((jmg, jtypes), (tmg, ttypes)):
        bis = ty.PolynomialCoarseningSequenceType.bisect
        kseq = mod.get_poly_mg_sequence(k, 1, bis)
        pseq = mod.get_poly_mg_sequence(p, 1, bis)
        lad = mod.get_mg_sequence(n_sp_lvl, kseq, pseq, ntao,
                                  max(ntao // 2, 1), ty.MGType.tau,
                                  ty.CoarseningType.space_and_time, False,
                                  True, False)
        pre = mod.get_precondition_stmg_types(
            lad, ty.CoarseningType.space_and_time, False, False,
            ty.SupportedSmoothers.Relaxation)
        seqs.append((kseq, pseq, [m.name for m in lad],
                     [s.name for s in pre]))
    assert seqs[0] == seqs[1]


def test_level_table_sequence_equal():
    lad_j = [jtypes.MGType.h, jtypes.MGType.tau, jtypes.MGType.p,
             jtypes.MGType.k, jtypes.MGType.p]
    lad_t = [_enum(m, ttypes) for m in lad_j]
    _eq(jtab.get_fe_time_weights_sequence(jtypes.TimeStepType.DG, 1 / 16, 4,
                                          lad_j, [1, 2]),
        ttab.get_fe_time_weights_sequence(ttypes.TimeStepType.DG, 1 / 16, 4,
                                          lad_t, [1, 2]))


@pytest.mark.parametrize("k", [1, 2, 3, 4])
def test_shape_data_and_space_transfers_equal(k):
    a, b = jfe.shape_data_1d(k, k + 1), tfe.shape_data_1d(k, k + 1)
    _eq((a.S, a.D, a.quad_x, a.quad_w, a.points),
        (b.S, b.D, b.quad_x, b.quad_w, b.points))
    _eq(jfe.prolongation_1d(k), tfe.prolongation_1d(k))
    _eq(jtr.h_prolongation_global_1d(3, k), ttr.h_prolongation_global_1d(3, k))
    for kc in range(1, k):
        _eq(jtr.p_prolongation_global_1d(3, kc, k),
            ttr.p_prolongation_global_1d(3, kc, k))


def test_port_imports_neither_jax_nor_stfem_tpu():
    """stfem_tpu_torch runs without JAX: no module imports jax or the JAX
    package, and importing it builds no kernel."""
    import ast
    import importlib
    import pathlib

    import stfem_tpu_torch
    from stfem_tpu_torch.ops import cuda_kernels

    root = pathlib.Path(stfem_tpu_torch.__file__).parent
    for path in root.rglob("*.py"):
        mod = ".".join(path.relative_to(root.parent).with_suffix("").parts)
        importlib.import_module(mod.removesuffix(".__init__"))
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                top = name.split(".")[0]
                assert top not in ("jax", "jaxlib", "stfem_tpu"), (path, name)
    assert cuda_kernels._LIB is None

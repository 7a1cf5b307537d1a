"""Space-time multigrid preconditioner (counterpart of
stfem_tpu/stmg/gmg.py; the reference's GMG, stmg.h:1047-1419).

One GMG object owns the heat, wave or Stokes hierarchy: per-level slab
operators (level dtype, bf16 with level_bf16), Vanka smoothers,
Relaxation/Chebyshev/Identity smoother wiring with deterministic
eigenvalue estimates, space transfers and dense time transfers.  The
V-cycle has deal.II Multigrid semantics as stfem_tpu runs them (and
distribute_gmg splits it over a mesh of ranks):

  pre-smooth:   u = S(d), then u += S(d - A u) for the level's further
                steps (smoothing_steps x 2^(max_level - l) when variable)
  post-smooth:  that many times u += S(d - A u)
  S = `inner` Relaxation sweeps with the level's Vanka, or the Chebyshev
      polynomial of degree `inner` in it
  coarse:       level 0's smoother (the reference's "Smoother" coarse
                solve), an assembled dense inverse ("Direct"), or any
                other coarse type: coarse_grid_maxiter iterations of
                left-preconditioned GMRES with level 0's smoother

The benches choose their V-cycles through bench_params: the heat one
(bench.py:886-923) applies S = 2 sweeps once per visit, skips the
Identity levels (paired space/time levels of the reference's ladder) and
solves the coarsest level directly; the wave one (bench.py:545-571) is
the same with variable smoothing and power estimates on every full level.
The tp_01 practical mode (drivers/tp01.py) runs stfem_tpu's GMGParams
defaults: one sweep, variable smoothing, Identity levels visited, the
Smoother coarse solve, and a coefficient on every level.  The Stokes
hierarchy (build_stmg_stokes below) takes GMGParams as stfem_tpu's does:
the tp_03stokes application runs its defaults with the config's
smoothing range, run_stokes_bench the same with range 5: variable
smoothing with S = 1 Relaxation sweep,
Identity levels visited (their smoother returns the defect: deal.II's
Richardson steps), and the coarse level solved by an assembled
pseudo-inverse, with the coarse nullspace (per-block constant pressure)
projected out before and after unless a do-nothing face determines the
pressure (the DFG channel's outflow).

Every GMGParams field of stfem_tpu is read.  The V-cycle knobs of
bench.py's switches: variable_steps_cap bounds the variable doubling,
post_smoother_inner_iterations gives a Relaxation level's post-smoother
its own sweep count, no_post_smooth / no_post_smooth_finest drop the
post-smoothing on every level / on the finest, smooth_all_levels gives
every level the smoother (no Identity levels).  vanka_bf16 stores the
Vanka factors in bf16 (with level_bf16 off the levels stay float32 and
K4 reads bf16 matrices against float32 vectors).  The smoother estimates
of uniform coefficient-free levels are kept in a disk cache
(stmg/eig_cache.py, STFEM_EIG_CACHE).
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch

from ..krylov import gmres_fixed_left
from ..mesh.grid import StructuredMesh
from ..ops.spatial import LaplaceMassOperator
from ..parallel.halo import Accumulated
from ..system import SystemMatrix
from ..time.mg_seq import (get_mg_sequence, get_poly_mg_sequence,
                           get_precondition_stmg_types)
from ..time.tables import (get_fe_time_weights_sequence,
                           get_fe_time_weights_wave_sequence)
from ..types import (CoarseningType, MGType, PolynomialCoarseningSequenceType,
                     ProblemType, SupportedSmoothers, TimeStepType)
from ..utils.timer import count, span, traced
from .eig_cache import EstimateCache, cache_path, estimate_key
from .smoother import (ChebyshevSmoother, IdentitySmoother,
                       RelaxationSmoother, chebyshev_parameters,
                       estimate_eigenvalues, relaxation_parameters)
from .transfers import (SpaceTransfer, TimeTransfer, h_prolongation_global_1d,
                        p_prolongation_global_1d)
from .vanka import PreconditionVanka, cell_eigenbasis, separable


@dataclass
class GMGParams:
    """stfem_tpu's GMGParams, every field with stfem_tpu's default
    (reference PreconditionerGMGAdditionalData, parameters.h:12-31, plus
    stfem_tpu's bench knobs):

    smoother: Relaxation, Chebyshev or Identity on every level that the
        precondition sequence does not make Identity.
    smoothing_steps: MG smoothing steps per level visit (times
        2^(max_level - l) on level l when `variable`, the factor capped at
        variable_steps_cap when that is > 0).
    smoother_inner_iterations: Relaxation sweeps, or the Chebyshev
        degree, per smoother application (None: smoothing_steps,
        stfem_tpu's wiring).
    post_smoother_inner_iterations: the Relaxation sweeps of the
        post-smoother alone (None: as the pre-smoother); a Chebyshev
        level keeps its degree.
    no_post_smooth / no_post_smooth_finest: no post-smoothing on any
        level / on the finest level.
    smooth_all_levels: every level gets the smoother (no Identity
        levels).
    smoothing_degree, coarse_grid_abstol, coarse_grid_reltol: parsed and
        read by nothing, in stfem_tpu and the reference alike.
    relaxation: a fixed omega; 0.0 estimates it (a Chebyshev level always
        estimates).
    smoothing_range: omega = 2 / (alpha + max_eig), alpha from the range;
        Chebyshev: theta and delta, the centre and half-width of
        [alpha, max_eig].
    coarse_grid_smoother_type: "Smoother" (level 0 gets a real smoother,
        applied 2^max_level times when `variable`), "Direct" (the dense
        float32 inverse of the assembled coarsest slab operator) or
        anything else (coarse_grid_maxiter iterations of
        left-preconditioned GMRES with level 0's smoother).
    coarse_direct_pinv: the Direct coarse solve is the FP64
        pseudo-inverse; a Stokes hierarchy then keeps its own coarse type
        (otherwise it routes a small enough coarse level to the
        pseudo-inverse).
    restrict_is_transpose_prolongate: False restricts in time with the
        interpolation down.
    skip_identity_levels: Identity levels contribute nothing.
    smoothing_eig_cg_n_iterations / eig_safety_factor: the power
        estimate's sweeps and safety factor (deal.II's 20 and 1.2).
    eig_exact: converged Arnoldi lambda_max (no safety factor) for
        estimates of up to eig_exact_max_n unknowns; False = the power
        method.
    vanka_bf16: store the Vanka down/up (or cell) matrices in bf16.
    level_bf16: run the V-cycle levels in bf16 (their Vanka matrices then
        bf16 too); the Vanka time-solve factors and the coarse inverse
        stay float32.
    eig_proxy_cells: > 0 estimates the smoother eigenvalues on a proxy of
        this many cells per axis (same cell size, degree and 2-step tables)
        for every coefficient-free level larger than it; lambda_max(P A) is
        h- and S-independent for heat (not for wave: 0 there)."""
    smoothing_range: float = 1.0
    smoothing_steps: int = 1
    smoother_inner_iterations: int | None = None
    post_smoother_inner_iterations: int | None = None
    relaxation: float = 0.0
    coarse_grid_smoother_type: str = "Smoother"
    coarse_direct_pinv: bool = False
    variable: bool = True
    variable_steps_cap: int = 0
    skip_identity_levels: bool = False
    no_post_smooth: bool = False
    no_post_smooth_finest: bool = False
    smooth_all_levels: bool = False
    smoothing_eig_cg_n_iterations: int = 20
    eig_safety_factor: float = 1.2
    eig_exact: bool = True
    eig_exact_max_n: int = 4_000_000
    vanka_bf16: bool = False
    level_bf16: bool = False
    eig_proxy_cells: int = 0
    smoother: SupportedSmoothers = SupportedSmoothers.Relaxation
    smoothing_degree: int = 5
    coarse_grid_maxiter: int = 10
    coarse_grid_abstol: float = 1e-20
    coarse_grid_reltol: float = 1e-4
    restrict_is_transpose_prolongate: bool = True


def bench_params(problem: ProblemType = ProblemType.heat,
                 **overrides) -> GMGParams:
    """bench.py's heat and wave V-cycles (bench.py:550-571, 886-923): two
    Relaxation sweeps per smoother application, Identity levels skipped,
    the Direct coarse solve, bf16 levels and Vanka matrices, `variable`
    smoothing for wave only; heat estimates on a 4-cell proxy."""
    wave = problem == ProblemType.wave
    kw = dict(smoother_inner_iterations=2, coarse_grid_smoother_type="Direct",
              variable=wave, skip_identity_levels=True, level_bf16=True,
              vanka_bf16=True, eig_proxy_cells=0 if wave else 4)
    kw.update(overrides)
    return GMGParams(**kw)


@dataclass
class _Level:
    matrix: SystemMatrix
    smoother: object
    n_blocks: int
    dof_shape: tuple


# the V-cycle's stage spans of a level, in _level_v_step's order
STAGES = ("smooth", "residual", "restrict", "prolongate", "post_smooth")


class GMG:
    DIRECT_COARSE_MAX = 16384

    def __init__(self, levels, transfers, dtype, precondition_sequence,
                 variable: bool = False, skip_identity: bool = True,
                 coarse_null: torch.Tensor | None = None,
                 smoothing_steps: int = 1, coarse: str = "Direct",
                 coarse_pinv: bool = False, coarse_maxiter: int = 10,
                 steps_cap: int = 0, post_inner: int | None = None,
                 no_post_smooth: bool = False,
                 no_post_smooth_finest: bool = False):
        """variable: 2^(max_level - l) x smoothing_steps smoother
        applications on level l, the factor capped at steps_cap when that
        is > 0.  skip_identity: Identity levels contribute nothing (the
        heat and wave benches); False visits them (stfem_tpu's GMGParams
        default).  coarse: "Direct" assembles the coarsest slab operator
        and inverts it; "Smoother" applies level 0's smoother (the
        reference's default coarse solve); any other value runs
        coarse_maxiter iterations of GMRES left-preconditioned by level 0's
        smoother (stfem_tpu gmg.py:275-291).  coarse_null: the normalized
        nullspace vector of a singular coarse system (enclosed-flow Stokes:
        the per-time-block constant pressure).  Given, it is projected out
        of the coarse defect and solution.  coarse_pinv: the Direct solve
        is the host FP64 pseudo-inverse (the Stokes saddle systems), else
        the plain inverse.  post_inner: the post-smoother's Relaxation
        sweeps (None: the smoother's own); no_post_smooth(_finest): no
        post-smoothing on any level (on the finest level)."""
        self.levels = levels
        self.transfers = transfers
        self.dtype = dtype
        self.precondition_sequence = precondition_sequence
        self.max_level = len(levels) - 1
        self.variable = variable
        self.skip_identity = skip_identity
        self.smoothing_steps = smoothing_steps
        self.steps_cap = steps_cap
        self.post_inner = post_inner
        self.no_post_smooth = no_post_smooth
        self.no_post_smooth_finest = no_post_smooth_finest
        self.coarse = coarse
        self.coarse_maxiter = coarse_maxiter
        self.coarse_null = coarse_null
        # the tracer's stage span names per level, made once
        self._stage_spans = [tuple(f"stmg.{s}.L{l}" for s in STAGES)
                            for l in range(len(levels))]
        self.coarse_Ainv = (self._assemble_direct_coarse(coarse_pinv)
                            if coarse == "Direct" else None)

    @traced("stmg.build.coarse_direct")
    def _assemble_direct_coarse(self, pinv: bool):
        """Dense float32 inverse (or FP64 pseudo-inverse stored in float32)
        of the coarsest slab operator, assembled from all unit columns at
        once (unit diagonal on constrained dofs)."""
        lvl = self.levels[0]
        n = lvl.n_blocks * int(np.prod(lvl.dof_shape))
        assert n <= self.DIRECT_COARSE_MAX, \
            f"coarse level too large for Direct solver ({n})"
        shape = (lvl.n_blocks,) + tuple(lvl.dof_shape)
        eye = torch.eye(n, dtype=self.dtype, device=lvl.matrix.device)
        # block axis first, the n columns as a batch axis before the grid
        cols = lvl.matrix.vmult(eye.reshape((n,) + shape).transpose(0, 1))
        A = cols.transpose(0, 1).reshape(n, n).T.to(torch.float32)
        zero_rows = (torch.amax(torch.abs(A), dim=1) == 0.0).to(
            torch.float32)
        A = A + torch.diag(zero_rows)
        if not pinv:
            return torch.linalg.inv(A)
        # a host numpy SVD in true FP64: float32 SVD noise (~1e-7 smax)
        # sits above rcond and would keep the near-null directions
        # (stfem_tpu/stmg/gmg.py:210-225)
        A64 = A.cpu().numpy().astype(np.float64)
        return torch.as_tensor(np.linalg.pinv(A64, rcond=1e-10),
                               dtype=torch.float32, device=A.device)

    def _project_null(self, x):
        """Remove the coarse nullspace component per leading block."""
        z = self.coarse_null.to(x.dtype)
        flat = x.reshape(x.shape[0], -1)
        return (flat - (flat @ z)[:, None] * z[None, :]).reshape(x.shape)

    def _coarse_solve(self, defect):
        if self.coarse_null is not None:
            defect = self._project_null(defect)
        if self.coarse == "Direct":
            d = defect.to(torch.float32).reshape(-1)
            out = (self.coarse_Ainv @ d).reshape(defect.shape).to(self.dtype)
        elif self.coarse == "Smoother":
            out = self._apply_smoother(0, defect)
        else:
            lvl = self.levels[0]
            out = gmres_fixed_left(lvl.matrix.vmult, defect,
                                   lvl.smoother.vmult, self.coarse_maxiter)
        if self.coarse_null is not None:
            out = self._project_null(out)
        return out

    def _steps(self, level: int) -> int:
        m = 2 ** (self.max_level - level) if self.variable else 1
        if self.steps_cap:
            m = min(m, self.steps_cap)
        return self.smoothing_steps * m

    def _skipped(self, level: int) -> bool:
        return self.skip_identity and isinstance(self.levels[level].smoother,
                                                 IdentitySmoother)

    def _apply_smoother(self, level: int, rhs):
        """Pre-smoothing from a zero guess (MGSmootherPrecondition::apply):
        u = S(d), then u += S(d - A u) for the level's further steps."""
        if self._skipped(level):
            return torch.zeros_like(rhs)
        lvl = self.levels[level]
        u = lvl.smoother.vmult(rhs)
        for _ in range(self._steps(level) - 1):
            u = u + lvl.smoother.vmult(rhs - lvl.matrix.vmult(u))
        return u

    def _level_v_step(self, level: int, defect):
        """One visit of `level`, each stage a span of the tracer; the
        recursion into level - 1 lies between restrict and prolongate,
        outside them."""
        if level == 0:
            with span("stmg.coarse.L0"):
                return self._coarse_solve(defect)
        smooth, residual, restrict, prolongate, post = \
            self._stage_spans[level]
        lvl = self.levels[level]
        with span(smooth):
            u = self._apply_smoother(level, defect)
        with span(residual):
            r = defect - lvl.matrix.vmult(u)
        with span(restrict):
            dc = self.transfers[level - 1].restrict(r)
        uc = self._level_v_step(level - 1, dc)
        with span(prolongate):
            u = u + self.transfers[level - 1].prolongate(uc)
        with span(post):
            return self._post_smooth(level, u, defect)

    def _post_smooth(self, level: int, u, defect):
        """The level's post-smoothing steps u += S(d - A u), S with
        post_inner sweeps on a Relaxation level (stfem_tpu
        gmg.py:248-265)."""
        if (self._skipped(level) or self.no_post_smooth
                or (self.no_post_smooth_finest and level == self.max_level)):
            return u
        lvl = self.levels[level]
        relax = (self.post_inner is not None
                 and isinstance(lvl.smoother, RelaxationSmoother))
        for _ in range(self._steps(level)):
            r = defect - lvl.matrix.vmult(u)
            u = u + (lvl.smoother.vmult(r, n_iterations=self.post_inner)
                     if relax else lvl.smoother.vmult(r))
        return u

    def vmult(self, src):
        """One V-cycle in the level precision; cast at the boundary
        (reference stmg.h:1331-1344)."""
        count("stmg.vcycles")
        with span("stmg.vcycle"):
            y = self._level_v_step(self.max_level, src.to(self.dtype))
            return y.to(src.dtype)

    __call__ = vmult


def _shard_level(lvl: _Level, layout) -> _Level:
    """The rank's slab of a level: the local operator on its sub-mesh
    under the global mask, the global smoother's omega (or Chebyshev
    interval) and degree on the sliced Vanka, each apply accumulated."""
    m = lvl.matrix
    if m.route != "kron":
        raise ValueError(f"a sharded level needs the separable (kron) "
                         f"operator, not route {m.route!r}")
    K, M = m.K, m.M
    sub = layout.submesh(K.mesh)
    mask = layout.mask(K.mesh, K.degree)
    Kl, Ml = (LaplaceMassOperator(sub, op.degree, op.n_q, op.mass_scaling,
                                  op.laplace_scaling, dtype=op.dtype,
                                  device=op.device, mask=mask)
              for op in (K, M))
    tables = (t.to(torch.float64).cpu().numpy() for t in (m.Alpha, m.Beta))
    matrix = Accumulated(SystemMatrix(Kl, Ml, *tables,
                                      precision=m.precision, route="kron"),
                         layout.accumulate)
    smoother = lvl.smoother
    if not isinstance(smoother, IdentitySmoother):
        smoother = copy.copy(smoother)
        smoother.matrix = matrix
        smoother.precond = Accumulated(
            lvl.smoother.precond.shard(layout.cell_ranges(K.cells)),
            layout.accumulate)
    return _Level(matrix=matrix, smoother=smoother, n_blocks=lvl.n_blocks,
                  dof_shape=sub.dof_shape(K.degree))


def distribute_gmg(gmg: GMG, policy, layout) -> GMG:
    """This rank's distributed V-cycle of the global hierarchy `gmg` (the
    counterpart of stfem_tpu's level_shardings / _constrain, gmg.py:177,
    292-310), on a parallel/sharding.py::RankLayout.  policy[l] is
    "sharded" or "replicated" (None: replicated) for level l, coarsest
    first; the sharded levels are the finest ones, level 0 is replicated.

    Every vector of a sharded level is the rank's consistent slab: each
    operator and smoother apply is the local one on the rank's sub-mesh
    then one accumulate, the Vanka the global one's slice
    (PreconditionVanka.shard), the omegas, Chebyshev intervals and
    sweeps the global smoothers' (an estimate on a sub-mesh gives
    another).  Replicated levels are the global ones, the coarse inverse
    the global one: every rank computes the same.  Time transfers are
    block-local; a space transfer out of a sharded level is the
    transfers.py ShardedSpaceTransfer.  gmg is left as it is."""
    n = len(gmg.levels)
    policy = ["replicated" if p is None else p for p in policy]
    if len(policy) != n or any(p not in ("sharded", "replicated")
                               for p in policy):
        raise ValueError(f"policy: one of 'sharded' / 'replicated' per "
                         f"level ({n}), not {policy}")
    if policy[0] == "sharded":
        raise ValueError("the coarsest level is replicated (its direct "
                         "inverse is applied on every rank)")
    if any(policy[l] == "sharded" and policy[l + 1] == "replicated"
           for l in range(n - 1)):
        raise ValueError(f"policy {policy}: a replicated level above a "
                         "sharded one")
    levels, transfers = list(gmg.levels), list(gmg.transfers)
    for l in range(1, n):
        if policy[l] == "replicated":
            continue
        levels[l] = _shard_level(gmg.levels[l], layout)
        t = gmg.transfers[l - 1]
        if isinstance(t, TimeTransfer):
            if policy[l - 1] != "sharded":
                raise ValueError(f"levels {l - 1}, {l}: a time transfer "
                                 "between a replicated and a sharded level")
            continue
        fine, coarse = gmg.levels[l].matrix.K, gmg.levels[l - 1].matrix.K
        transfers[l - 1] = t.shard(layout, fine.cells, fine.degree,
                                   coarse.cells, coarse.degree,
                                   coarse_replicated=policy[l - 1]
                                   == "replicated")
    out = copy.copy(gmg)
    out.levels, out.transfers = levels, transfers
    out.level_policy = policy
    return out


def _cycle_options(params: GMGParams) -> dict:
    """GMG's V-cycle arguments from params."""
    return dict(variable=params.variable,
                skip_identity=params.skip_identity_levels,
                smoothing_steps=params.smoothing_steps,
                coarse_maxiter=params.coarse_grid_maxiter,
                steps_cap=params.variable_steps_cap,
                post_inner=params.post_smoother_inner_iterations,
                no_post_smooth=params.no_post_smooth,
                no_post_smooth_finest=params.no_post_smooth_finest)


def _two_step_tables(Alpha, Beta):
    """The 2-step tables with the same per-step blocks, or None."""
    struct = SystemMatrix._detect_step_structure(np.asarray(Alpha),
                                                 np.asarray(Beta))
    if struct is None:
        return None
    nt, A0, A1, B0, B1 = struct
    A2 = np.zeros((2 * nt, 2 * nt))
    B2 = np.zeros((2 * nt, 2 * nt))
    A2[:nt, :nt] = A2[nt:, nt:] = A0
    A2[nt:, :nt] = A1
    B2[:nt, :nt] = B2[nt:, nt:] = B0
    B2[nt:, :nt] = B1
    return A2, B2


def _level_smoother(kind: SupportedSmoothers, matrix, precond, info,
                    params: GMGParams):
    """stfem_tpu's smoother wiring for a Relaxation or Chebyshev level
    (stfem_tpu gmg.py:643-666, :870-891): degree or sweeps
    smoother_inner_iterations, else smoothing_steps; without an estimate
    (a degenerate level, or one that failed) omega = 1 or (theta, delta) =
    (1, 0.5)."""
    inner = (params.smoother_inner_iterations
             if params.smoother_inner_iterations is not None
             else params.smoothing_steps)
    if kind == SupportedSmoothers.Chebyshev:
        theta, delta = ((1.0, 0.5) if info is None else
                        chebyshev_parameters(info, params.smoothing_range))
        return ChebyshevSmoother(matrix, precond, theta, delta, inner)
    if params.relaxation != 0.0:
        omega = params.relaxation
    elif info is None:
        omega = 1.0
    else:
        omega = relaxation_parameters(info, params.smoothing_range)
    return RelaxationSmoother(matrix, precond, omega, inner)


def _usable(info):
    """The estimate, or None where it failed."""
    ok = np.isfinite(info.max_eigenvalue) and info.max_eigenvalue > 0
    return info if ok else None


@traced("stmg.build")
def build_stmg(mesh_fine: StructuredMesh, fe_degree: int, space_degree: int,
               type_: TimeStepType, n_timesteps_at_once: int,
               time_step: float, params: GMGParams | None = None,
               dtype=torch.float32, device="cuda",
               problem: ProblemType = ProblemType.heat,
               coarsening_type: CoarseningType = CoarseningType.space_and_time,
               time_before_space: bool = False,
               space_time_level_first: bool = False,
               use_pmg: bool = True, fe_degree_min: int | None = None,
               n_timesteps_at_once_min: int | None = None,
               space_degree_min: int = 1,
               poly_coarsening=PolynomialCoarseningSequenceType.bisect,
               laplace_coefficient=None, time_only: bool = False,
               estimate_cache: EstimateCache | None = None) -> GMG:
    """Assemble the STMG hierarchy for the heat or wave cycle with
    stfem_tpu's ladder conventions (stfem_tpu/stmg/gmg.py::build_stmg):
    the space p-sequence bisects space_degree down to space_degree_min,
    the time k-sequence fe_degree down to fe_degree_min, and
    get_mg_sequence orders the h, p, k and tau levels by the coarsening
    arguments.  time_only keeps every level on the fine mesh (no h level;
    the reference's transfer_01 ladder): the coarsest level is the fine
    mesh at the coarsest steps and time degree, and a "Smoother" coarse
    solve applies its Vanka.  The defaults
    give the benches' ladder (space_and_time, p-multigrid, one tau
    level).  laplace_coefficient multiplies every level's stiffness
    operator; such levels take the GridSumFac route and the cell-local
    Vanka, and their eigenvalues are estimated on the level itself.  On a
    distorted fine mesh every coarser mesh is coarsened() from it (strided
    vertices): each level takes SystemMatrix's "cell" route and the
    cell-local Vanka, and its eigenvalues are estimated on the level
    itself too.
    Everything lives on `device`; the estimates sweep there, or come from
    the disk cache (stmg/eig_cache.py), or from `estimate_cache` where the
    caller gives one; gmg.estimates counts the ones computed and the ones
    read, gmg.estimate_entries holds every keyed one."""
    params = params or GMGParams()
    if params.level_bf16:
        dtype = torch.bfloat16
    device = torch.device(device)
    if fe_degree_min is None:
        fe_degree_min = max(fe_degree - 1,
                            1 if type_ == TimeStepType.CGP else 0)
    if n_timesteps_at_once_min is None:
        n_timesteps_at_once_min = max(n_timesteps_at_once // 2, 1)

    n_sp_lvl = 1 if time_only else mesh_fine.refinement + 1
    if time_only:
        meshes = [mesh_fine]
    elif mesh_fine.distort != 0.0:
        # the coarse meshes inherit the fine mesh's distorted vertices,
        # strided (stfem_tpu/stmg/gmg.py:441-445)
        meshes = [mesh_fine]
        while meshes[0].refinement > 0:
            meshes.insert(0, meshes[0].coarsened())
    else:
        meshes = [StructuredMesh(mesh_fine.subdivisions, mesh_fine.lower,
                                 mesh_fine.upper, refinement=r)
                  for r in range(n_sp_lvl)]
    poly_time = get_poly_mg_sequence(fe_degree, fe_degree_min,
                                     poly_coarsening)
    poly_space = get_poly_mg_sequence(space_degree, space_degree_min,
                                      poly_coarsening)
    mg_type_level = get_mg_sequence(
        n_sp_lvl, poly_time, poly_space, n_timesteps_at_once,
        n_timesteps_at_once_min, MGType.tau, coarsening_type,
        time_before_space, use_pmg, space_time_level_first)
    precond_seq = get_precondition_stmg_types(
        mg_type_level, coarsening_type, time_before_space,
        space_time_level_first, params.smoother)
    if params.smooth_all_levels:
        precond_seq = [params.smoother] * len(precond_seq)
    table_seq = (get_fe_time_weights_wave_sequence
                 if problem == ProblemType.wave
                 else get_fe_time_weights_sequence)
    fetw = table_seq(type_, time_step, n_timesteps_at_once, mg_type_level,
                     poly_time)

    # walk the level state from fine to coarse
    n_levels = len(mg_type_level) + 1
    mesh_idx, spd_idx = [0] * n_levels, [0] * n_levels
    n_at_once, ntd_idx = [0] * n_levels, [0] * n_levels
    mi, si, na, ti = (n_sp_lvl - 1, len(poly_space) - 1,
                      n_timesteps_at_once, len(poly_time) - 1)
    for l in range(n_levels - 1, -1, -1):
        mesh_idx[l], spd_idx[l], n_at_once[l], ntd_idx[l] = mi, si, na, ti
        if l > 0:
            mgt = mg_type_level[l - 1]
            if mgt == MGType.h:
                mi -= 1
            elif mgt == MGType.p:
                si -= 1
            elif mgt == MGType.k:
                ti -= 1
            elif mgt == MGType.tau:
                na //= 2
    dg = type_ == TimeStepType.DG
    direct = params.coarse_grid_smoother_type == "Direct"

    def ops(mesh_, deg_, coefficient):
        return (LaplaceMassOperator(mesh_, deg_, deg_ + 1, 0.0, 1.0,
                                    dtype=dtype, device=device,
                                    coefficient=coefficient),
                LaplaceMassOperator(mesh_, deg_, deg_ + 1, 1.0, 0.0,
                                    dtype=dtype, device=device))

    bases = {}          # cell-local patch eigenbases, one per (K, M)
    storage = torch.bfloat16 if params.vanka_bf16 else None
    cache = estimate_cache or EstimateCache(cache_path())

    def vanka(K, M, A, B, n_steps):
        basis = None
        if not separable(K, M):
            if id(K) not in bases:
                bases[id(K)] = cell_eigenbasis(K, M)
            basis = bases[id(K)]
        return PreconditionVanka(
            K, M, A, B, dtype=dtype, n_steps=n_steps, eigenbasis=basis,
            storage_dtype=storage)

    def estimate(matrix, v, K, mesh_l, deg_l, Alpha_l, Beta_l, n_steps,
                 shape):
        """The EigInfo of P A (None if the estimate failed), on a proxy
        when the level is a large coefficient-free one; through the disk
        cache where the estimated level is uniform and coefficient-free."""
        m_est, v_est, K_e, mask = matrix, v, K, K.mask_np
        A_e, B_e, s_e = Alpha_l, Beta_l, n_steps
        p = params.eig_proxy_cells
        if (p > 0 and laplace_coefficient is None and mesh_l.uniform
                and all(int(c) > p for c in mesh_l.cells)):
            pm = StructuredMesh([p] * mesh_l.dim, [0.0] * mesh_l.dim,
                                [p * float(h) for h in mesh_l.h])
            K_e, Mp = ops(pm, deg_l, None)
            two = _two_step_tables(Alpha_l, Beta_l)
            if two is not None and s_e > 2:
                (A_e, B_e), s_e = two, 2
            m_est = SystemMatrix(K_e, Mp, A_e, B_e, precision=None)
            v_est = vanka(K_e, Mp, A_e, B_e, s_e)
            mask = K_e.mask_np
            shape = (np.asarray(A_e).shape[0],) + pm.dof_shape(deg_l)
        method = ("arnoldi" if params.eig_exact
                  and int(np.prod(shape)) <= params.eig_exact_max_n
                  else "power")
        n_it, safety = (params.smoothing_eig_cg_n_iterations,
                        params.eig_safety_factor)
        key = estimate_key(K_e, A_e, B_e, shape, dtype, storage, s_e, n_it,
                           safety, method, device)
        return _usable(cache.estimate(key, lambda: estimate_eigenvalues(
            m_est, v_est, shape, mask, device=device, method=method,
            n_iterations=n_it, safety_factor=safety)))

    levels, ops_cache = [], {}

    def build_level(l):
        mesh_l = meshes[mesh_idx[l]]
        deg_l = poly_space[spd_idx[l]]
        if (mesh_idx[l], deg_l) not in ops_cache:
            ops_cache[(mesh_idx[l], deg_l)] = ops(mesh_l, deg_l,
                                                  laplace_coefficient)
        K, M = ops_cache[(mesh_idx[l], deg_l)]
        Alpha_l, Beta_l = fetw[l][0], fetw[l][1]
        matrix = SystemMatrix(K, M, Alpha_l, Beta_l, precision=None)
        rt = poly_time[ntd_idx[l]]
        n_blocks = (rt + 1 if dg else rt) * n_at_once[l]
        lvl = _Level(matrix=matrix, smoother=IdentitySmoother(),
                     n_blocks=n_blocks, dof_shape=mesh_l.dof_shape(deg_l))
        levels.append(lvl)
        # a directly solved level 0 never runs its smoother
        if (precond_seq[l] == SupportedSmoothers.Identity
                or (l == 0 and direct)):
            return
        with span(f"stmg.build.vanka.L{l}"):
            v = vanka(K, M, Alpha_l, Beta_l, n_at_once[l])
        info = None     # also on a degenerate level: every dof constrained
        if ((params.relaxation == 0.0
             or precond_seq[l] == SupportedSmoothers.Chebyshev)
                and np.sum(K.mask_np) != 0):
            with span(f"stmg.build.estimate.L{l}"):
                info = estimate(matrix, v, K, mesh_l, deg_l, Alpha_l, Beta_l,
                                n_at_once[l],
                                (n_blocks,) + tuple(lvl.dof_shape))
        lvl.smoother = _level_smoother(precond_seq[l], matrix, v, info,
                                       params)

    for l in range(n_levels):
        with span(f"stmg.build.level.L{l}"):
            build_level(l)

    transfers = []
    for l in range(1, n_levels):
        mgt = mg_type_level[l - 1]
        mesh_hi, mesh_lo = meshes[mesh_idx[l]], meshes[mesh_idx[l - 1]]
        deg_hi, deg_lo = poly_space[spd_idx[l]], poly_space[spd_idx[l - 1]]
        if mgt in (MGType.h, MGType.p):
            if mgt == MGType.h:
                P1ds = [h_prolongation_global_1d(mesh_lo.cells[d], deg_hi)
                        for d in range(mesh_hi.dim)]
            else:
                P1ds = [p_prolongation_global_1d(mesh_hi.cells[d], deg_lo,
                                                 deg_hi)
                        for d in range(mesh_hi.dim)]
            transfers.append(SpaceTransfer(
                P1ds, mesh_hi.boundary_dof_mask(deg_hi),
                mesh_lo.boundary_dof_mask(deg_lo), dtype, device))
        else:
            rt_hi, rt_lo = poly_time[ntd_idx[l]], poly_time[ntd_idx[l - 1]]
            transfers.append(TimeTransfer(
                type_, mgt, rt_hi + 1 if dg else rt_hi,
                rt_lo + 1 if dg else rt_lo, n_at_once[l],
                params.restrict_is_transpose_prolongate, dtype, device))

    gmg = GMG(levels, transfers, dtype, precond_seq,
              coarse=params.coarse_grid_smoother_type,
              coarse_pinv=params.coarse_direct_pinv,
              **_cycle_options(params))
    gmg.mg_type_level = mg_type_level
    gmg.estimates = {"computed": cache.computed, "read": cache.read}
    gmg.estimate_entries = dict(cache.taken)
    return gmg


def build_stmg_stokes(mesh_fine: StructuredMesh, fe_degree: int,
                      type_: TimeStepType, n_timesteps_at_once: int,
                      time_step: float, viscosity: float = 1.0,
                      params: GMGParams | None = None, dtype=torch.float32,
                      coarsening_type: CoarseningType =
                      CoarseningType.space_and_time,
                      time_before_space: bool = False,
                      space_time_level_first: bool = False,
                      use_pmg: bool = True,
                      fe_degree_min: int | None = None,
                      fe_degree_min_space: int | None = None,
                      n_timesteps_at_once_min: int | None = None,
                      poly_coarsening=PolynomialCoarseningSequenceType.bisect,
                      weak_faces=(), free_faces=(), dg_pressure: bool = True,
                      weak_obstacle: bool = False, device="cuda") -> GMG:
    """STMG hierarchy for the Stokes slab system on the flat
    [T, n_u + n_p] layout (stfem_tpu/stmg/gmg.py::build_stmg_stokes, with
    its signature and defaults): velocity Q_{k+1} x DGP(k) pressure per
    level, the space p-ladder on the pressure degree down to
    fe_degree_min_space (velocity is always pressure + 1, so it never drops
    below Q2), the time k-ladder down to fe_degree_min, the tau ladder down
    to n_timesteps_at_once_min, ordered by get_mg_sequence; block Vanka
    with the per-step factorization (and the weak_faces' and, with
    weak_obstacle, the obstacle's Nitsche terms, on every level's
    coarsened mask) on every Relaxation or Chebyshev level, omega or
    (theta, delta) from the 20-step power estimate on the flat mask and
    params.smoothing_range;
    params' smoothing steps, `variable` smoothing and Identity levels.
    The coarse level is solved by the assembled FP64 pseudo-inverse
    whenever it has at most GMG.DIRECT_COARSE_MAX unknowns, else by
    params' coarse solve (Smoother, Direct, or GMRES); either way, unless
    the flow has a free (do-nothing) face, the per-block constant pressure
    (the enclosed flow's nullspace) is projected out of the coarse defect
    and solution.  The mesh ladder
    keeps the fine mesh's cell mask (strided), base axis steps and vertex
    map.  The level operators take StokesSystemMatrix's "element" route.
    dg_pressure=False builds the Taylor-Hood pair Q_{k+1}/Q_k with the
    continuous nodal pressure on every level (the pressure degree never
    drops below Q1): FE_Q Vanka patches, the nodal pressure transfers
    under the pressure masks, and the masked nodal pressure as the coarse
    nullspace (stfem_tpu gmg.py:850-854, 911-925, 961-972)."""
    from ..blocks import BlockSlice
    from ..ops.stokes import StokesOperator
    from ..system_stokes import StokesSystemMatrix
    from ..time.tables import get_fe_time_weights_stokes
    from .stokes_level import StokesSpaceTransfer, StokesVanka

    params = params or GMGParams()
    device = torch.device(device)
    if fe_degree_min is None:
        fe_degree_min = max(fe_degree - 1, 1)
    if fe_degree_min_space is None:
        fe_degree_min_space = fe_degree_min
    if n_timesteps_at_once_min is None:
        n_timesteps_at_once_min = max(n_timesteps_at_once // 2, 1)
    u_degree = fe_degree + 1
    n_sp_lvl = mesh_fine.refinement + 1
    meshes = []
    for r in range(n_sp_lvl):
        cm = mesh_fine.cell_mask
        if cm is not None:
            stride = 2 ** (mesh_fine.refinement - r)
            cm = cm[(slice(None, None, stride),) * mesh_fine.dim]
        meshes.append(StructuredMesh(
            mesh_fine.subdivisions, mesh_fine.lower, mesh_fine.upper,
            refinement=r, cell_mask=cm,
            axis_steps=mesh_fine.base_axis_steps(),
            vertex_map=mesh_fine.vertex_map, map_exact=mesh_fine.map_exact))
    poly_time = get_poly_mg_sequence(fe_degree, fe_degree_min,
                                     poly_coarsening)
    poly_space = [p + 1 for p in get_poly_mg_sequence(
        u_degree - 1, max(int(fe_degree_min_space), 1), poly_coarsening)]
    mg_type_level = get_mg_sequence(
        n_sp_lvl, poly_time, poly_space, n_timesteps_at_once,
        n_timesteps_at_once_min, MGType.tau, coarsening_type,
        time_before_space, use_pmg, space_time_level_first)
    precond_seq = get_precondition_stmg_types(
        mg_type_level, coarsening_type, time_before_space,
        space_time_level_first, params.smoother)
    if params.smooth_all_levels:
        precond_seq = [params.smoother] * len(precond_seq)
    fetw = get_fe_time_weights_sequence(
        type_, time_step, n_timesteps_at_once, mg_type_level, poly_time)
    fetw_stokes = get_fe_time_weights_sequence(
        type_, time_step, n_timesteps_at_once, mg_type_level, poly_time,
        weight_fn=get_fe_time_weights_stokes)

    n_levels = len(mg_type_level) + 1
    mesh_idx, spd_idx = [0] * n_levels, [0] * n_levels
    n_at_once, ntd_idx = [0] * n_levels, [0] * n_levels
    mi, si, na, ti = (n_sp_lvl - 1, len(poly_space) - 1,
                      n_timesteps_at_once, len(poly_time) - 1)
    for l in range(n_levels - 1, -1, -1):
        mesh_idx[l], spd_idx[l], n_at_once[l], ntd_idx[l] = mi, si, na, ti
        if l > 0:
            mgt = mg_type_level[l - 1]
            if mgt == MGType.h:
                mi -= 1
            elif mgt == MGType.p:
                si -= 1
            elif mgt == MGType.k:
                ti -= 1
            elif mgt == MGType.tau:
                na //= 2
    dg = type_ == TimeStepType.DG

    def n_blocks(l):
        rt = poly_time[ntd_idx[l]]
        return n_at_once[l] * (rt + 1 if dg else rt)

    sops = {}

    def ops(l):
        key = (mesh_idx[l], poly_space[spd_idx[l]])
        if key not in sops:
            u_deg = key[1]
            S = StokesOperator(meshes[key[0]], u_deg, u_deg - 1, u_deg + 1,
                               viscosity, dtype=dtype, device=device,
                               weak_faces=weak_faces, free_faces=free_faces,
                               dg_pressure=dg_pressure,
                               weak_obstacle=weak_obstacle)
            Mu = LaplaceMassOperator(meshes[key[0]], u_deg, u_deg + 1, 1.0,
                                     0.0, dtype=dtype, device=device,
                                     mask=S.mask_u_np)
            sops[key] = (S, Mu)
        return sops[key]

    # the coarse system is solved by the pseudo-inverse (stfem_tpu
    # gmg.py:937-957) whenever it fits, unless coarse_direct_pinv asks for
    # params' own coarse solve: a Direct level 0's Vanka never runs
    S0 = ops(0)[0]
    coarse = ("Direct" if n_blocks(0) * (S0.n_u + S0.n_p)
              <= GMG.DIRECT_COARSE_MAX and not params.coarse_direct_pinv
              else params.coarse_grid_smoother_type)
    levels = []
    for l in range(n_levels):
        S, Mu = ops(l)
        matrix = StokesSystemMatrix(S, Mu, fetw[l][0], fetw[l][1],
                                    type_=type_, precision=None,
                                    route="element")
        T_l = n_blocks(l)
        lvl = _Level(matrix=matrix, smoother=IdentitySmoother(),
                     n_blocks=T_l, dof_shape=(S.n_u + S.n_p,))
        levels.append(lvl)
        if (precond_seq[l] == SupportedSmoothers.Identity
                or (l == 0 and coarse == "Direct")):
            continue
        nt_l = T_l // n_at_once[l]
        vanka = StokesVanka(S, Mu, fetw_stokes[l][0], fetw_stokes[l][1],
                            BlockSlice(n_at_once[l], 2, nt_l), dtype=dtype)
        info = None     # also on a degenerate level: no free velocity dof
        if ((params.relaxation == 0.0
             or precond_seq[l] == SupportedSmoothers.Chebyshev)
                and np.sum(S.mask_u_np) != 0):
            # Stokes keeps deal.II's power estimate (the saddle-point P A
            # spectrum is complex; stfem_tpu gmg.py:856-870)
            flat_mask = np.concatenate(
                [np.tile(S.mask_u_np.reshape(-1), S.dim),
                 np.ones(S.n_p) if dg_pressure else S.mask_p_np.reshape(-1)])
            info = _usable(estimate_eigenvalues(
                matrix, vanka, (T_l, S.n_u + S.n_p), flat_mask,
                device=device, method="power",
                n_iterations=params.smoothing_eig_cg_n_iterations,
                safety_factor=params.eig_safety_factor))
        lvl.smoother = _level_smoother(precond_seq[l], matrix, vanka, info,
                                       params)

    transfers = []
    for l in range(1, n_levels):
        mgt = mg_type_level[l - 1]
        deg_hi, deg_lo = poly_space[spd_idx[l]], poly_space[spd_idx[l - 1]]
        S_hi, S_lo = ops(l)[0], ops(l - 1)[0]
        mesh_hi, mesh_lo = meshes[mesh_idx[l]], meshes[mesh_idx[l - 1]]
        if mgt in (MGType.h, MGType.p):
            if mgt == MGType.h:
                P1ds = [h_prolongation_global_1d(mesh_lo.cells[d], deg_hi)
                        for d in range(mesh_hi.dim)]
            else:
                P1ds = [p_prolongation_global_1d(mesh_hi.cells[d], deg_lo,
                                                 deg_hi)
                        for d in range(mesh_hi.dim)]
            ut = SpaceTransfer(P1ds, S_hi.mask_u_np, S_lo.mask_u_np, dtype,
                               device)
            pt = None
            if not dg_pressure:
                # the nodal pressure transfer, one degree below the velocity
                kp_hi, kp_lo = deg_hi - 1, deg_lo - 1
                P1ds_p = ([h_prolongation_global_1d(mesh_lo.cells[d], kp_hi)
                           for d in range(mesh_hi.dim)] if mgt == MGType.h
                          else [p_prolongation_global_1d(mesh_hi.cells[d],
                                                         kp_lo, kp_hi)
                                for d in range(mesh_hi.dim)])
                pt = SpaceTransfer(P1ds_p, S_hi.mask_p_np, S_lo.mask_p_np,
                                   dtype, device)
            transfers.append(StokesSpaceTransfer(
                S_hi, S_lo, ut, "h" if mgt == MGType.h else "p", dtype,
                p_transfer=pt))
        else:
            rt_hi, rt_lo = poly_time[ntd_idx[l]], poly_time[ntd_idx[l - 1]]
            # the dense time matrix acts on the whole flat [T, n_u + n_p]
            # vector, as stfem_tpu's StokesTimeTransfer applies it
            transfers.append(TimeTransfer(
                type_, mgt, rt_hi + 1 if dg else rt_hi,
                rt_lo + 1 if dg else rt_lo, n_at_once[l],
                params.restrict_is_transpose_prolongate, dtype, device))

    # the enclosed flow's coarse system is singular along the per-block
    # constant pressure: projected out of the coarse defect and solution;
    # a do-nothing face determines the pressure, and nothing is projected
    # (stfem_tpu gmg.py:958-973).  The Direct coarse solve is the
    # pseudo-inverse either way (stfem_tpu gmg.py:944-957)
    coarse_null = None
    if not free_faces:
        if dg_pressure:
            zp = np.zeros((int(np.prod(S0.cells)), S0.n_ploc_cell))
            zp[:, 0] = 1.0       # DGP mode 0 = constant
        else:
            zp = S0.mask_p_np    # the constant on the active nodes
        z = np.concatenate([np.zeros(S0.n_u), zp.reshape(-1)])
        coarse_null = torch.as_tensor(z / np.linalg.norm(z), dtype=dtype,
                                      device=device)
    gmg = GMG(levels, transfers, dtype, precond_seq, coarse_null=coarse_null,
              coarse=coarse, coarse_pinv=True, **_cycle_options(params))
    gmg.mg_type_level = mg_type_level
    return gmg

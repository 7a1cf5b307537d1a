"""JSON configuration compatible with the reference's parameter files
(counterpart of stfem_tpu/config.py::Parameters).

Same key names as the reference's ParameterHandler schema (parameters.h:
92-144), so the reference's tests/json/*.json parse verbatim.  Derived-
default clamping mirrors parameters.h:162-175, and the golden-era
time_before_space inversion is stfem_tpu's.  The multigrid keys fill
GMGParams as stfem_tpu's parser fills them (smoothingDegree and the
coarse-grid tolerances are read by nothing, there as here); keys with no
field are ignored.  StokesParameters is the tp_03stokes block, parsed
from the same file.
"""
from __future__ import annotations

import json
from dataclasses import dataclass, field

from .stmg.gmg import GMGParams
from .types import (STR_TO_COARSENING_TYPE, STR_TO_NONLINEAR_EXTRAPOLATION,
                    STR_TO_NONLINEAR_TREATMENT, STR_TO_POLY_COARSENING,
                    STR_TO_PROBLEM_TYPE, STR_TO_SMOOTHER, STR_TO_TIME_TYPE,
                    CoarseningType, NonlinearExtrapolation,
                    NonlinearTreatment, PolynomialCoarseningSequenceType,
                    ProblemType, TimeStepType)


def _to_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).strip().lower() in ("true", "1", "yes")


@dataclass
class Parameters:
    dim: int = 2
    do_output: bool = False
    print_timing: bool = False
    space_time_mg: bool = True
    time_before_space: bool = False
    type: TimeStepType = TimeStepType.CGP
    problem: ProblemType = ProblemType.wave
    nonlinear_treatment: NonlinearTreatment = NonlinearTreatment.Implicit
    nonlinear_extrapolation: NonlinearExtrapolation = \
        NonlinearExtrapolation.Auto
    coarsening_type: CoarseningType = CoarseningType.space_or_time
    # NOTE deliberate deviation from the CURRENT reference default (true,
    # parameters.h:49): the committed goldens (tests/tp_01.output) predate
    # the spaceTimeLevelFirst parameter and are only reproducible with the
    # time-levels-deep ladder ordering (zip_from_back=false), which is also
    # the h-robust one -- with tau levels near the fine end the iteration
    # counts GROW with refinement (measured: 9/12/17/27 vs flat 9/9/8/7.94
    # over tf01 refs 2-5; scripts/h_growth_lab.py).  Set the JSON key
    # explicitly to override.
    space_time_level_first: bool = False
    use_pmg: bool = False
    poly_coarsening: PolynomialCoarseningSequenceType = \
        PolynomialCoarseningSequenceType.bisect
    n_timesteps_at_once: int = 1
    n_timesteps_at_once_min: int = -1
    fe_degree: int = 1
    fe_degree_min: int = -1
    fe_degree_min_space: int = -1
    n_deg_cycles: int = 1
    n_ref_cycles: int = 1
    frequency: float = 1.0
    rel_tol: float = 1.0e-12
    refinement: int = 2
    time_refine_offset: int = 1
    space_time_conv_test: bool = True
    extrapolate: bool = True
    colorize_boundary: bool = False
    nitsche_boundary: bool = False
    functional_file: str = "functionals.txt"
    grid_descriptor: str = "hyperRectangle"
    additional_file: str = ""
    hyperrect_lower_left: tuple = None
    hyperrect_upper_right: tuple = None
    subdivisions: tuple = None
    distort_grid: float = 0.0
    distort_coeff: float = 0.0
    source: tuple = None
    end_time: float = 1.0
    delta_time: float = 0.0
    mg_data: GMGParams = field(default_factory=GMGParams)

    @classmethod
    def parse(cls, file_name: str, dim: int = 2) -> "Parameters":
        with open(file_name) as f:
            raw = json.load(f)
        p = cls(dim=dim)
        key_map = {
            "doOutput": ("do_output", _to_bool),
            "printTiming": ("print_timing", _to_bool),
            "spaceTimeMg": ("space_time_mg", _to_bool),
            "mgTimeBeforeSpace": ("time_before_space", _to_bool),
            "timeType": ("type", STR_TO_TIME_TYPE.get),
            "problemType": ("problem", STR_TO_PROBLEM_TYPE.get),
            "nonlinearTreatment": ("nonlinear_treatment",
                                   STR_TO_NONLINEAR_TREATMENT.get),
            "nonlinearExtrapolation": ("nonlinear_extrapolation",
                                       STR_TO_NONLINEAR_EXTRAPOLATION.get),
            "pMgType": ("poly_coarsening", STR_TO_POLY_COARSENING.get),
            "coarseningType": ("coarsening_type",
                               STR_TO_COARSENING_TYPE.get),
            "spaceTimeLevelFirst": ("space_time_level_first", _to_bool),
            "usePMg": ("use_pmg", _to_bool),
            "nTimestepsAtOnce": ("n_timesteps_at_once", int),
            "nTimestepsAtOnceMin": ("n_timesteps_at_once_min", int),
            "feDegree": ("fe_degree", int),
            "feDegreeMin": ("fe_degree_min", int),
            "feDegreeMinSpace": ("fe_degree_min_space", int),
            "nDegCycles": ("n_deg_cycles", int),
            "nRefCycles": ("n_ref_cycles", int),
            "frequency": ("frequency", float),
            "relativeTolerance": ("rel_tol", float),
            "refinement": ("refinement", int),
            "timeRefineOffset": ("time_refine_offset", int),
            "spaceTimeConvergenceTest": ("space_time_conv_test", _to_bool),
            "extrapolate": ("extrapolate", _to_bool),
            "colorizeBoundary": ("colorize_boundary", _to_bool),
            "nitscheBoundary": ("nitsche_boundary", _to_bool),
            "functionalFile": ("functional_file", str),
            "gridDescriptor": ("grid_descriptor", str),
            "additionalFile": ("additional_file", str),
            "distortGrid": ("distort_grid", float),
            "distortCoeff": ("distort_coeff", float),
            "endTime": ("end_time", float),
            "deltaTime": ("delta_time", float),
        }
        mg_map = {
            "smoother": ("smoother", STR_TO_SMOOTHER.get),
            "smoothingDegree": ("smoothing_degree", int),
            "smoothingSteps": ("smoothing_steps", int),
            "smoothingRange": ("smoothing_range", float),
            "relaxation": ("relaxation", float),
            "coarseGridSmootherType": ("coarse_grid_smoother_type", str),
            "coarseGridMaxiter": ("coarse_grid_maxiter", int),
            "coarseGridAbstol": ("coarse_grid_abstol", float),
            "coarseGridReltol": ("coarse_grid_reltol", float),
            "restrictIsTransposeProlongate":
                ("restrict_is_transpose_prolongate", _to_bool),
            "variable": ("variable", _to_bool),
        }
        for key, value in raw.items():
            if key in key_map:
                attr, conv = key_map[key]
                setattr(p, attr, conv(value))
            elif key in mg_map:
                attr, conv = mg_map[key]
                setattr(p.mg_data, attr, conv(value))
            elif key in ("hyperRectLowerLeft", "hyperRectUpperRight",
                         "subdivisions", "sourcePoint"):
                vals = [float(x) for x in str(value).split(",")]
                tgt = {"hyperRectLowerLeft": "hyperrect_lower_left",
                       "hyperRectUpperRight": "hyperrect_upper_right",
                       "subdivisions": "subdivisions",
                       "sourcePoint": "source"}[key]
                setattr(p, tgt, tuple(vals))
            # unknown keys ignored (forward compatible)
        if p.hyperrect_lower_left is None:
            p.hyperrect_lower_left = (0.0,) * dim
        if p.hyperrect_upper_right is None:
            p.hyperrect_upper_right = (1.0,) * dim
        if p.subdivisions is None:
            p.subdivisions = (1,) * dim
        else:
            p.subdivisions = tuple(int(s) for s in p.subdivisions)

        # derived defaults (reference parameters.h:162-175)
        if p.n_timesteps_at_once_min == -1:
            p.n_timesteps_at_once_min = p.n_timesteps_at_once // 2
        p.n_timesteps_at_once_min = max(
            1, min(p.n_timesteps_at_once_min, p.n_timesteps_at_once))
        lowest = 0 if p.type == TimeStepType.DG else 1
        if p.fe_degree_min == -1:
            p.fe_degree_min = p.fe_degree - 1
        p.fe_degree_min = max(lowest, min(p.fe_degree_min, p.fe_degree))
        if p.fe_degree_min_space == -1:
            p.fe_degree_min_space = p.fe_degree_min
        # Golden-convention mapping (deliberate deviation from HEAD, like
        # space_time_level_first above): for space_or_time coarsening the
        # committed goldens are only reproducible with the TIME levels at the
        # COARSE end of the ladder, which in the current get_mg_sequence
        # composition means time_before_space INVERTED relative to the JSON
        # key.  Measured (tf02/tf04/tf06, refs 2-4): time-at-fine-end runs
        # 16.5/20.4/28.2 vs goldens 10/11/10.75 and the tau two-grid
        # contraction degrades with h (scripts/tau_twogrid_lab.py); flipped,
        # all three are h-flat at 11/10.5/10.  Time-at-coarse-end is also
        # the h-robust choice: the problematic spatially-smooth x
        # inter-step-jump modes never reach a time transfer on a fine mesh.
        if p.coarsening_type == CoarseningType.space_or_time:
            p.time_before_space = not p.time_before_space
        return p


@dataclass
class StokesParameters:
    """Stokes-specific parameter block (counterpart of
    stfem_tpu/config.py::StokesParameters; reference stokes::Parameters,
    stokes.h:12-34 / stokes.cc:6-27), parsed from the same JSON file as
    Parameters with the reference's key names."""
    compute_drag_lift: bool = True
    rho: float = 1.0
    characteristic_diameter: float = 0.1
    u_mean: float = 1.0
    viscosity: float = 1.0
    delta0: float = 0.0
    delta1: float = 0.0
    penalty1: float = 20.0
    penalty2: float = 10.0
    outflow_penalty: float = 0.0
    mean_pressure: bool = True
    dg_pressure: bool = True
    dfg_benchmark: int = 0
    height: float = 0.41

    @classmethod
    def parse(cls, file_name: str) -> "StokesParameters":
        with open(file_name) as f:
            raw = json.load(f)
        p = cls()
        key_map = {
            "computeDragLift": ("compute_drag_lift", _to_bool),
            "rho": ("rho", float),
            "characteristicDiam": ("characteristic_diameter", float),
            "uMean": ("u_mean", float),
            "viscosity": ("viscosity", float),
            "delta0": ("delta0", float),
            "delta1": ("delta1", float),
            "penalty1": ("penalty1", float),
            "penalty2": ("penalty2", float),
            "outflowPenalty": ("outflow_penalty", float),
            "meanPressure": ("mean_pressure", _to_bool),
            "dGPressure": ("dg_pressure", _to_bool),
            "dfgBenchmark": ("dfg_benchmark", int),
        }
        for key, value in raw.items():
            if key in key_map:
                attr, conv = key_map[key]
                setattr(p, attr, conv(value))
        return p

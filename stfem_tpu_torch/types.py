"""Enums and string maps mirroring the reference's config vocabulary
(reference: include/types.h:84-175, include/fe_time.h:18-35)."""
from __future__ import annotations

import enum


class TimeStepType(enum.Enum):
    CGP = 1
    DG = 2
    GCC = 3  # enum exists in the reference but has no implementation; kept for
    # config parity only (reference include/fe_time.h:22).


class ProblemType(enum.Enum):
    heat = 1
    wave = 2
    stokes = 3
    maxwell = 4  # config-only in the reference (no implementation)
    cdr = 5      # config-only in the reference (no implementation)


class CoarseningType(enum.Enum):
    space_or_time = 1
    space_and_time = 2


class MGType(enum.Enum):
    tau = "t"  # halve the number of timesteps in the slab (double tau)
    k = "k"    # lower the time polynomial degree
    h = "h"    # coarsen the spatial mesh
    p = "p"    # lower the space polynomial degree

    def __str__(self) -> str:  # convenient printing: 'h t h k p'
        return self.value


class SupportedSmoothers(enum.Enum):
    Identity = 0
    Relaxation = 1
    Chebyshev = 2


class NonlinearTreatment(enum.Enum):
    none = 0
    Implicit = 1
    Explicit = 2


class NonlinearExtrapolation(enum.Enum):
    Auto = 0
    Constant = 1
    Polynomial = 2
    LeastSquares = 3  # enum-only in the reference (no implementation)


class PolynomialCoarseningSequenceType(enum.Enum):
    bisect = 1
    decrease_by_one = 2
    go_to_one = 3


STR_TO_TIME_TYPE = {"CGP": TimeStepType.CGP, "DG": TimeStepType.DG,
                    "GCC": TimeStepType.GCC}
STR_TO_PROBLEM_TYPE = {"heat": ProblemType.heat, "wave": ProblemType.wave,
                       "stokes": ProblemType.stokes,
                       "maxwell": ProblemType.maxwell, "cdr": ProblemType.cdr}
STR_TO_COARSENING_TYPE = {"space_or_time": CoarseningType.space_or_time,
                          "space_and_time": CoarseningType.space_and_time}
STR_TO_SMOOTHER = {"identity": SupportedSmoothers.Identity,
                   "relaxation": SupportedSmoothers.Relaxation,
                   "chebyshev": SupportedSmoothers.Chebyshev}
STR_TO_NONLINEAR_TREATMENT = {"none": NonlinearTreatment.none,
                              "implicit": NonlinearTreatment.Implicit,
                              "explicit": NonlinearTreatment.Explicit}
STR_TO_NONLINEAR_EXTRAPOLATION = {
    "auto": NonlinearExtrapolation.Auto,
    "constant": NonlinearExtrapolation.Constant,
    "polynomial": NonlinearExtrapolation.Polynomial,
    "leastSquares": NonlinearExtrapolation.LeastSquares,
}
STR_TO_POLY_COARSENING = {
    "bisect": PolynomialCoarseningSequenceType.bisect,
    "decreasebyone": PolynomialCoarseningSequenceType.decrease_by_one,
    "decrease_by_one": PolynomialCoarseningSequenceType.decrease_by_one,
    "gotoone": PolynomialCoarseningSequenceType.go_to_one,
    "go_to_one": PolynomialCoarseningSequenceType.go_to_one,
}

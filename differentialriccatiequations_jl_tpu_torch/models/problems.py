"""Problem and algorithm types (port of the JAX package's
``models/problems.py``).

* `GALEProblem`  — ``AᵀXE + EᵀXA = −C``,
* `GDREProblem`  — ``EᵀẊE = CᵀC + AᵀXE + EᵀXA − EᵀXBBᵀXE`` on ``tspan``,
* `GAREProblem`  — ``Q + AᵀXE + EᵀXA − EᵀXGXE = 0``,
* `DRESolution`  — the trajectory of states ``X`` and feedbacks ``K = BᵀXE``.

Algorithm configs are frozen (hashable) dataclasses with the JAX package's
fields and defaults.  The low-rank or dense path is selected by the type of
the data (`LowRank` or a dense tensor).  A problem's dense data follow its
operators' device; the solvers run where the tensors are.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..lowrank import LowRank
from ..ops.operators import as_operator


def _on(x, op):
    """``x`` as a tensor on the device of operator ``op``."""
    return torch.as_tensor(x, device=getattr(op, "device", None))


def _dense_on(x, op):
    """Dense data on the device of operator ``op`` (the same tensor when it
    is there already); a `LowRank` or ``None`` as it is."""
    return x if x is None or isinstance(x, LowRank) else _on(x, op)


class GALEProblem:
    """Generalized algebraic Lyapunov equation ``AᵀXE + EᵀXA = −C``."""

    def __init__(self, E, A, C):
        self.E = as_operator(E)
        self.A = as_operator(A)
        self.C = _dense_on(C, self.E)  # LowRank or dense

    @property
    def n(self) -> int:
        return self.E.shape[0]

    @property
    def is_lowrank(self) -> bool:
        return isinstance(self.C, LowRank)


class GDREProblem:
    """Generalized differential Riccati equation."""

    def __init__(self, E, A, B, C, X0, tspan):
        self.E = as_operator(E)
        self.A = as_operator(A)
        self.B = _on(B, self.E)
        self.C = _on(C, self.E)
        self.X0 = _dense_on(X0, self.E)  # LowRank or dense (n, n)
        self.tspan = (float(tspan[0]), float(tspan[1]))

    @property
    def n(self) -> int:
        """The global size, also where the operands are row shards."""
        return self.E.shape[0]

    @property
    def is_lowrank(self) -> bool:
        return isinstance(self.X0, LowRank)


class GAREProblem:
    """Generalized continuous-time algebraic Riccati equation.

    ``G`` and ``Q`` are `LowRank` factorizations (``G = B Bᵀ`` scaled,
    ``Q = Cᵀ C``)."""

    def __init__(self, E, A, G: LowRank, Q: LowRank):
        self.E = as_operator(E)
        self.A = as_operator(A)
        self.G = G
        self.Q = Q

    @property
    def n(self) -> int:
        """The global size, also where the operands are row shards."""
        return self.E.shape[0]


class DRESolution:
    """GDRE trajectory: states `X`, feedbacks `K = BᵀXE`, times `t`.  From a
    row-sharded sweep each rank holds its rows of every ``X`` and its
    columns of every ``K``."""

    def __init__(self, X, K, t):
        self.X = X
        self.K = K
        self.t = t


# --- time integrators ----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Ros1:
    """First-order Rosenbrock (implicit Euler)."""

    inner_alg: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class Ros2:
    """Second-order Rosenbrock."""

    inner_alg: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class Ros3:
    pass


@dataclasses.dataclass(frozen=True)
class Ros4:
    pass


@dataclasses.dataclass(frozen=True)
class Parareal:
    """Parareal-in-time around the compiled Ros1 fine propagator (the JAX
    package's ``models/parareal.py`` config; the solver is
    `models.parareal.solve_gdre_parareal`).

    ``plateau_factor``: additionally stop once the boundary update stops
    shrinking (``delta_k > plateau_factor · delta_{k-1}`` on **two
    consecutive** iterations) — the detector for the arithmetic noise floor
    of the low-rank combine.  ``None`` disables it.  A plateau stop below
    the requested ``reltol`` is recorded as
    ``parareal_info["stopped_by"] == "plateau"`` and warns."""

    slabs: int = 4
    max_iters: int | None = None
    reltol: float = 1e-8
    plateau_factor: float | None = 0.5


# --- Lyapunov solvers -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ADI:
    """Low-rank ADI.  ``shifts`` is a strategy from `models.shifts`
    (default ``Projection(2)``); ``inner_alg=None`` routes the shifted
    solves by operator kind (dense LU, SMW, Krylov) through
    `ops.shifted.default_inner_alg`."""

    maxiters: int = 100
    reltol: Optional[float] = None
    abstol: Optional[float] = None
    shifts: object = None  # default Projection(2), set in __post_init__
    ignore_initial_guess: bool = False
    inner_alg: Optional[object] = None
    compression_interval: int = 10
    compression: bool = True
    warn_convergence: bool = True
    capacity: Optional[int] = None  # storage width of X (auto if None)

    def __post_init__(self):
        if self.shifts is None:
            from .shifts import Projection

            object.__setattr__(self, "shifts", Projection(2))


@dataclasses.dataclass(frozen=True)
class BartelsStewart:
    """Dense GALE solve: the sign-function iteration on the tensors' device
    (`models.lyapunov_dense.solve_gale_dense`, ``maxiters`` steps), or with
    ``host=True`` SciPy's Bartels–Stewart on the host CPU (the oracle)."""

    maxiters: int = 40
    host: bool = False


@dataclasses.dataclass(frozen=True)
class GMRES:
    """Matrix-valued (F)GMRES on the Lyapunov operator
    (`models.gmres.solve_gale_gmres`): ``maxiters`` Arnoldi steps a cycle,
    ``maxrestarts`` restarts; ``preconditioner`` an `ADI` config (or a
    prepared callable), applied to each Krylov vector."""

    maxiters: int = 3
    maxrestarts: int = 0
    reltol: Optional[float] = None
    abstol: Optional[float] = None
    ignore_initial_guess: bool = False
    compression: bool = True
    preconditioner: Optional[object] = None
    warn_convergence: bool = True


@dataclasses.dataclass(frozen=True)
class Kronecker:
    """Naive n² × n² dense Kronecker solve, for tests."""


# --- algebraic Riccati -----------------------------------------------------------


def superlinear_forcing(i: int, _res) -> float:
    """η = 1/(i³+1)."""
    return 1.0 / (i**3 + 1)


def quadratic_forcing(_i, residual_norm: float) -> float:
    """η = min(0.1, 0.9‖res‖)."""
    return min(0.1, 0.9 * float(residual_norm))


@dataclasses.dataclass(frozen=True)
class Newton:
    """(Inexact) Kleinman–Newton with line search.  ``inner_alg`` comes
    first, as in ``Newton(ADI(...))``; default ``ADI()``."""

    inner_alg: object = None  # default ADI()
    maxiters: int = 5
    reltol: Optional[float] = None
    abstol: Optional[float] = None
    inexact: bool = True
    inexact_hybrid: bool = True
    inexact_forcing: object = quadratic_forcing
    linesearch: bool = True

    def __post_init__(self):
        if self.inner_alg is None:
            object.__setattr__(self, "inner_alg", ADI())

"""Solver dispatch: the `solve` / `init` verbs (port of the JAX package's
``models/__init__.py``), and the solvers behind them.

Ported branches: GALE by the host ADI or by (F)GMRES (low-rank
right-hand side), by the dense sign-function solver or the SciPy oracle
(`BartelsStewart`) and by the Kronecker solve; low-rank GDRE by Ros1 and
Ros2 or by parareal around the compiled Ros1 (`Parareal`), dense GDRE by
Ros1–4; GARE by Kleinman–Newton with an ADI or GMRES inner solver.  A
problem and algorithm that do not fit raise `TypeError` as in the JAX
package.
"""

from __future__ import annotations

from ..lowrank import LowRank, lowrank, lr_compress
from . import shifts
from .adi import ADISolver, solve_gale_adi
from .gmres import solve_gale_gmres
from .lyapunov_dense import (
    _dense, sign_function_cache, solve_gale_dense, solve_gale_host, solve_gale_kronecker)
from .newton import solve_gare_newton
from .parareal import solve_gdre_parareal
from .problems import (
    ADI, BartelsStewart, DRESolution, GALEProblem, GAREProblem, GDREProblem, GMRES,
    Kronecker, Newton, Parareal, Ros1, Ros2, Ros3, Ros4, quadratic_forcing,
    superlinear_forcing)
from .residuals import residual
from .rosenbrock_dense import solve_gdre_dense
from .rosenbrock_lowrank import (
    feedback_K, solve_gdre_lowrank_ros1, solve_gdre_lowrank_ros2)


def solve(prob, alg, **kwargs):
    """``solve(prob, alg; kwargs...)`` — dispatch on problem, algorithm and
    data (low-rank or dense)."""
    if isinstance(prob, GALEProblem):
        if isinstance(alg, ADI):
            return solve_gale_adi(prob, alg, **kwargs)
        if isinstance(alg, GMRES):
            return solve_gale_gmres(prob, alg, **kwargs)
        if isinstance(alg, BartelsStewart):
            kwargs.pop("observer", None)
            if alg.host:
                return solve_gale_host(prob.E, prob.A, prob.C)
            return solve_gale_dense(prob.E, prob.A, prob.C, alg.maxiters)
        if isinstance(alg, Kronecker):
            kwargs.pop("observer", None)
            return solve_gale_kronecker(prob.E.to_dense(), prob.A.to_dense(),
                                        _dense(prob.C))
        raise TypeError(f"no GALE solver for {alg!r}")
    if isinstance(prob, GAREProblem):
        if isinstance(alg, Newton):
            return solve_gare_newton(prob, alg, **kwargs)
        raise TypeError(f"no GARE solver for {alg!r}")
    if isinstance(prob, GDREProblem):
        if prob.is_lowrank:
            if isinstance(alg, Parareal):
                return solve_gdre_parareal(prob, alg=alg, **kwargs)
            if isinstance(alg, Ros1):
                return solve_gdre_lowrank_ros1(prob, alg, **kwargs)
            if isinstance(alg, Ros2):
                return solve_gdre_lowrank_ros2(prob, alg, **kwargs)
            raise TypeError(
                f"low-rank GDRE supports Ros1/Ros2 (README.md:130-132), got {alg!r}")
        if isinstance(alg, (Ros1, Ros2, Ros3, Ros4)):
            return solve_gdre_dense(prob, alg, **kwargs)
        raise TypeError(f"no GDRE integrator for {alg!r}")
    raise TypeError(f"no solver for problem {type(prob)}")


def init(prob, alg, **kwargs):
    """``init(prob, alg)`` — a resumable solver object (ADI on a GALE)."""
    if isinstance(prob, GALEProblem) and isinstance(alg, ADI):
        return ADISolver(prob, alg, **kwargs)
    raise TypeError(f"init not supported for ({type(prob)}, {type(alg)})")


__all__ = [
    "GALEProblem", "GDREProblem", "GAREProblem", "DRESolution",
    "ADI", "BartelsStewart", "GMRES", "Kronecker", "Newton", "Parareal",
    "Ros1", "Ros2", "Ros3", "Ros4", "quadratic_forcing", "superlinear_forcing",
    "residual", "solve", "init", "ADISolver", "solve_gale_adi", "solve_gale_gmres",
    "solve_gare_newton", "solve_gdre_parareal",
    "solve_gdre_lowrank_ros1", "solve_gdre_lowrank_ros2", "feedback_K", "shifts",
    "solve_gale_dense", "solve_gale_host", "solve_gale_kronecker",
    "sign_function_cache", "solve_gdre_dense", "LowRank", "lowrank", "lr_compress",
]

"""Dense Rosenbrock integrators of orders 1–4 for GDRE problems (port of
the JAX package's ``models/rosenbrock_dense.py``, the reference's
``dense_ros{1..4}.jl``).

The reference computes one generalized Schur decomposition per time step
and solves every stage in Schur coordinates (``dense_ros2.jl:38-57``).
Here each step builds one `SignFunctionCache` (`lyapunov_dense`) and every
stage replays its cached inverse sequence: the same one factorization per
step.  The time loop runs on the host; the steps read nothing back.
"""

from __future__ import annotations

import math

import torch

from ..utils.callbacks import notify
from .lyapunov_dense import sign_function_cache
from .problems import BartelsStewart, DRESolution, GDREProblem, Ros1, Ros2, Ros3, Ros4
from .rosenbrock_lowrank import time_grid

# Ros3 tableau constants (dense_ros3.jl:28-35).
_ROS3 = dict(
    gamma=7.886751345948129e-1,
    a21=1.267949192431123,
    c21=-1.607695154586736,
    c31=-3.464101615137755,
    c32=-1.732050807568877,
    m1=2.0,
    m2=5.773502691896258e-1,
    m3=4.226497308103742e-1,
)


def _sym(R: torch.Tensor) -> torch.Tensor:
    return 0.5 * (R + R.T)


def _ros1_step(Ed, Ad, B, CtC, X, K, tau, sign_iters=40):
    """Implicit Euler step (dense_ros1.jl:30-49)."""
    F = (Ad - B @ K) - Ed / (2.0 * tau)
    R = _sym(CtC + K.T @ K + (1.0 / tau) * (Ed.T @ X @ Ed))
    X_new = sign_function_cache(Ed, F, sign_iters).solve(R)
    return X_new, (B.T @ X_new) @ Ed


def _ros2_step(Ed, Ad, B, CtC, X, K, tau, sign_iters=40):
    """2nd-order Rosenbrock step (dense_ros2.jl:34-64)."""
    gamma = 1.0 + 1.0 / math.sqrt(2.0)
    gF = gamma * tau * (Ad - B @ K) - Ed / 2.0
    cache = sign_function_cache(Ed, gF, sign_iters)

    AXE = (Ad.T @ X) @ Ed
    K1 = cache.solve(_sym(CtC + AXE + AXE.T - K.T @ K))

    BK1E = (B.T @ K1) @ Ed
    R2 = _sym(-(tau**2) * (BK1E.T @ BK1E) - (2.0 - 1.0 / gamma) * (Ed.T @ K1 @ Ed))
    K2 = cache.solve(R2) + (4.0 - 1.0 / gamma) * K1

    X_new = X + (tau / 2.0) * K2
    return X_new, (B.T @ X_new) @ Ed


def _ros3_step(Ed, Ad, B, CtC, X, K, tau, sign_iters=40):
    """3rd-order Rosenbrock step (dense_ros3.jl:37-72)."""
    c = _ROS3
    gF = (Ad - B @ K) - Ed / (2.0 * c["gamma"] * tau)
    cache = sign_function_cache(Ed, gF, sign_iters)

    AXE = (Ad.T @ X) @ Ed
    K1 = cache.solve(_sym(CtC + AXE + AXE.T - K.T @ K))

    RX = (Ad.T @ K1 - K.T @ (B.T @ K1)) @ Ed
    R23 = c["a21"] * (RX + RX.T)
    K21 = cache.solve(_sym(R23 + (c["c21"] / tau) * (Ed.T @ K1 @ Ed)))

    R3 = _sym(R23 + Ed.T @ (((c["c31"] + c["c32"]) / tau) * K1
                            + (c["c32"] / tau) * K21) @ Ed)
    K31 = cache.solve(R3)

    X_new = X + (c["m1"] + c["m2"] + c["m3"]) * K1 + c["m2"] * K21 + c["m3"] * K31
    return X_new, (B.T @ X_new) @ Ed


def _ros4_step(Ed, Ad, B, CtC, X, K, tau, sign_iters=40):
    """4th-order Rosenbrock step (dense_ros4.jl:29-90)."""
    gF = (tau * (Ad - B @ K) - Ed) / 2.0
    cache = sign_function_cache(Ed, gF, sign_iters)

    AXE = (Ad.T @ X) @ Ed
    K1 = cache.solve(_sym(CtC + AXE + AXE.T - K.T @ K))

    EK1E = Ed.T @ K1 @ Ed
    EK1B = Ed.T @ (K1 @ B)
    K2 = cache.solve(_sym(-(tau**2) * (EK1B @ EK1B.T) - 2.0 * EK1E)) - K1

    alpha = (24.0 / 25.0) * tau
    beta = (3.0 / 25.0) * tau
    EK2E = Ed.T @ K2 @ Ed
    EK2B = Ed.T @ (K2 @ B)
    TMP = EK2B @ EK1B.T
    R3 = _sym(
        (245.0 / 25.0) * EK1E
        + (36.0 / 25.0) * EK2E
        - (426.0 / 625.0) * (tau**2) * (EK1B @ EK1B.T)
        - beta**2 * (EK2B @ EK2B.T)
        - alpha * beta * (TMP + TMP.T)
    )
    K3 = cache.solve(R3) - (17.0 / 25.0) * K1

    R4 = _sym(-(981.0 / 125.0) * EK1E - (177.0 / 125.0) * EK2E
              - (1.0 / 5.0) * (Ed.T @ K3 @ Ed))
    K4 = cache.solve(R4) + K3

    X_new = X + tau * ((19.0 / 18.0) * K1 + 0.25 * K2 + (25.0 / 216.0) * K3
                       + (125.0 / 216.0) * K4)
    return X_new, (B.T @ X_new) @ Ed


_STEPPERS = {Ros1: _ros1_step, Ros2: _ros2_step, Ros3: _ros3_step, Ros4: _ros4_step}


def solve_gdre_dense(prob: GDREProblem, alg, *, dt: float,
                     save_state: bool = False, observer=None) -> DRESolution:
    """Dense GDRE sweep by ``alg`` (`Ros1` … `Ros4`) with fixed steps
    ``dt``, on the device of the problem's tensors.  Keeps the boundary
    states only unless ``save_state``; ``sol.X[0]`` is ``prob.X0``."""
    # The stages solve through the shared sign-function cache; another inner
    # algorithm cannot be honoured (dense_ros2.jl:10-11).
    inner = getattr(alg, "inner_alg", None)
    if inner is not None and not isinstance(inner, BartelsStewart):
        raise NotImplementedError(
            f"dense Rosenbrock supports only BartelsStewart inner solves, "
            f"got {inner!r} (dense_ros2.jl:10-11)")
    notify(observer, "gdre_start", prob, alg)
    Ed = prob.E.to_dense()
    Ad = prob.A.to_dense()
    B, C = prob.B, prob.C
    CtC = C.T @ C
    X = prob.X0
    tstops = time_grid(prob.tspan, dt)
    step = _STEPPERS[type(alg)]

    Xs = [prob.X0]
    K = (B.T @ X) @ Ed
    Ks = [K]
    notify(observer, "gdre_step", float(tstops[0]), X, K)
    for i in range(1, len(tstops)):
        tau = float(tstops[i - 1] - tstops[i])
        X, K = step(Ed, Ad, B, CtC, X, K, tau)
        if save_state:
            Xs.append(X)
        Ks.append(K)
        notify(observer, "gdre_step", float(tstops[i]), X, K)
    if not save_state:
        Xs.append(X)
    notify(observer, "gdre_done")
    return DRESolution(Xs, Ks, tstops)

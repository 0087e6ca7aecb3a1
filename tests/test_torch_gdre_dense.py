"""The dense GDRE integrators Ros1–4 and the compiled LRSIF steps on dense
cores: the port against the JAX package on the same numpy inputs, f64 on
the CPU, and the reference's ``rail.jl:52-70`` check inside the port (on
the dense pencil, as the JAX package's ``tests/test_rail371.py``).

Tolerances: dense ``X`` and ``K`` within 1e-10 relative of the JAX
package's (``tests/test_gdre.py:52-76``, n = 40); the port's low-rank Ros1
and Ros2 ``K`` against its dense ``K`` within ``‖K‖·n·eps·100`` (n = 371);
the compiled Ros1 step and Ros2 sweep on `DenseOp` cores through
`ShiftLUs` within 1e-10 of the JAX package's with equal ADI counts
(``tests/test_compiled.py:35-97``).
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import differentialriccatiequations_jl_tpu as J  # noqa: E402
import differentialriccatiequations_jl_tpu_torch as T  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.lowrank import (  # noqa: E402
    lowrank, lr_to_dense, lr_with_capacity)
from differentialriccatiequations_jl_tpu_torch.models import compiled as tcomp  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models.rosenbrock_dense import _ROS3  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops.dia import dia_pencil  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops.operators import DenseOp, lin_comb, scale_op  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils.callbacks import Observer  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils.testmat import (  # noqa: E402
    rail_surrogate, rail_surrogate_dense)

jcomp = importlib.import_module("differentialriccatiequations_jl_tpu.models.compiled")
jrd = importlib.import_module("differentialriccatiequations_jl_tpu.models.rosenbrock_dense")
jlr = importlib.import_module("differentialriccatiequations_jl_tpu.lowrank")
jops = importlib.import_module("differentialriccatiequations_jl_tpu.ops.operators")
jshifts = importlib.import_module("differentialriccatiequations_jl_tpu.models.shifts")

N = 40
TSPAN = (4500.0, 4400.0)
ALGS = ("Ros1", "Ros2", "Ros3", "Ros4")
EPS = float(np.finfo(np.float64).eps)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _dense_problem(n, device="cpu"):
    """The reference's dense GDRE: X0 = E⁻¹Cᵀ·0.01·C E⁻ᵀ, tspan (4500,
    4400).  Returns the port's problem and the numpy inputs."""
    E, A, B, C = rail_surrogate_dense(n, device=device)
    L0 = torch.linalg.solve(E, C.T)
    X0 = L0 @ (0.01 * torch.eye(C.shape[0], dtype=torch.float64, device=device)) @ L0.T
    return T.GDREProblem(E, A, B, C, X0, TSPAN), [x.cpu().numpy() for x in (E, A, B, C, X0)]


@pytest.fixture(scope="module")
def jax_dense():
    """The JAX package's dense sweeps at n = 40, 5 steps of dt = −20."""
    _, (E, A, B, C, X0) = _dense_problem(N)
    prob = J.GDREProblem(E, A, B, C, X0, TSPAN)
    return {alg: J.solve(prob, getattr(J, alg)(), dt=-20.0) for alg in ALGS}


@pytest.mark.parametrize("alg", ALGS)
def test_dense_rosenbrock_matches_jax(alg, jax_dense):
    prob, _ = _dense_problem(N)
    sol = T.solve(prob, getattr(T, alg)(), dt=-20.0)
    ref = jax_dense[alg]
    assert len(sol.X) == 2 and len(sol.K) == 6
    assert sol.X[0] is prob.X0
    assert np.allclose(sol.t, np.asarray(ref.t))
    assert _rel(sol.X[-1], ref.X[-1]) < 1e-10
    for K, Kj in zip(sol.K, ref.K):
        assert _rel(K, Kj) < 1e-10


@pytest.mark.parametrize("alg", ALGS)
def test_dense_rosenbrock_smoke(alg):
    """``rail.jl:36-50``: save_state semantics, aliasing, time direction,
    observer events."""

    class Rec(Observer):
        def __init__(self):
            self.events = []

        def observe_gdre_start(self, prob, alg):
            self.events.append("start")

        def observe_gdre_step(self, t, X, K):
            self.events.append(t)

        def observe_gdre_done(self):
            self.events.append("done")

    prob, _ = _dense_problem(N)
    rec = Rec()
    sol = T.solve(prob, getattr(T, alg)(), dt=-50.0, save_state=True, observer=rec)
    assert len(sol.t) == len(sol.X) == len(sol.K) == 3
    assert sol.X[0] is prob.X0 and sol.t[0] > sol.t[-1]
    assert rec.events == ["start", 4500.0, 4450.0, 4400.0, "done"]
    assert all(bool(torch.isfinite(X).all()) for X in sol.X)


def test_dense_rosenbrock_rejects_other_inner_alg():
    prob, _ = _dense_problem(N)
    with pytest.raises(NotImplementedError, match="BartelsStewart"):
        T.solve(prob, T.Ros1(inner_alg=T.ADI()), dt=-20.0)
    sol = T.solve(prob, T.Ros2(inner_alg=T.BartelsStewart()), dt=-50.0)
    assert len(sol.K) == 3


def test_problem_moves_dense_data_to_operators_device():
    prob, (E, A, B, C, X0) = _dense_problem(N)
    moved = T.GDREProblem(prob.E, prob.A, B, C, X0, TSPAN)
    assert isinstance(moved.X0, torch.Tensor) and moved.X0.device == prob.E.device
    gale = T.GALEProblem(prob.E, prob.A, C.T @ C)
    assert isinstance(gale.C, torch.Tensor)
    assert _ROS3["m1"] == jrd._ROS3["m1"] and _ROS3 == jrd._ROS3


@pytest.mark.parametrize("alg", ["Ros1", "Ros2"])
def test_lowrank_matches_dense_rail371(alg):
    """``rail.jl:52-70`` in the port: the LRSIF feedback against the dense
    solver's at n = 371, 4 steps of dt = −25, within ``‖K‖·n·eps·100``."""
    n = 371
    prob_d, (Ed, _, B, C, _) = _dense_problem(n)
    L0 = torch.as_tensor(np.linalg.solve(Ed, C.T))
    X0 = lowrank(L0, 0.01 * torch.eye(C.shape[0], dtype=torch.float64))
    prob_lr = T.GDREProblem(prob_d.E, prob_d.A, prob_d.B, prob_d.C, X0, TSPAN)
    ref = T.solve(prob_d, getattr(T, alg)(), dt=-25.0)
    sol = T.solve(prob_lr, getattr(T, alg)(), dt=-25.0)
    tol = float(torch.linalg.norm(ref.K[-1])) * n * EPS * 100
    assert float(torch.linalg.norm(ref.K[-1] - sol.K[-1])) < tol


def _compiled_inputs(n=48, cap=64):
    E, A, B, C = (x.numpy() for x in rail_surrogate_dense(n, device="cpu"))
    L0 = np.linalg.solve(E, C.T)
    return E, A, B, C, L0, cap


def test_ros1_step_compiled_dense_cores_match_jax():
    """One compiled Ros1 step on `DenseOp` cores through `ShiftLUs`, against
    the JAX package's on its own `ShiftLUs`, with the Penzl shifts of the
    JAX test (``tests/test_compiled.py:70-97``)."""
    E, A, B, C, L0, cap = _compiled_inputs()
    tau, q = 20.0, C.shape[0]
    sv = tcomp.heuristic_shifts_host(E, A, 10, 10, 10)
    shifts = np.asarray([s.real for s in sv])
    cfg = tcomp.CompiledConfig(maxiters=60, compression_interval=10, r_res=24)
    Eo, Ao = DenseOp(torch.as_tensor(E)), DenseOp(torch.as_tensor(A))
    lus = tcomp.build_step_shift_solvers(Eo, lin_comb(Ao, -1.0 / (2 * tau), Eo), shifts)
    assert isinstance(lus, tcomp.ShiftLUs) and lus.lu.dtype == torch.float64
    X0 = lr_with_capacity(lowrank(torch.as_tensor(L0), 0.01 * torch.eye(q, dtype=torch.float64)), cap)
    X1, K1, iters, _ = tcomp.ros1_step_compiled(
        Eo, Ao, torch.as_tensor(B), torch.as_tensor(C), X0, tau, shifts, 1e-12, cfg, lus)

    Ej, Aj = jops.DenseOp(jnp.asarray(E)), jops.DenseOp(jnp.asarray(A))
    lus_j = jcomp.build_step_shift_solvers(Ej, jops.lin_comb(Aj, -1.0 / (2 * tau), Ej),
                                           jnp.asarray(shifts))
    X0j = jlr.lr_with_capacity(jlr.lowrank(jnp.asarray(L0), 0.01 * jnp.eye(q)), cap)
    cfg_j = jcomp.CompiledConfig(maxiters=60, compression_interval=10, r_res=24)
    X1j, K1j, it_j, _ = jcomp.ros1_step_compiled(
        Ej, Aj, jnp.asarray(B), jnp.asarray(C), X0j, jnp.asarray(tau), jnp.asarray(shifts),
        jnp.asarray(1e-12), cfg_j, lus_j)
    assert iters == int(it_j)
    assert _rel(K1, K1j) < 1e-10
    assert _rel(lr_to_dense(X1), jlr.lr_to_dense(X1j)) < 1e-10


def test_ros2_sweep_compiled_dense_cores_match_jax():
    """The compiled Ros2 sweep on `DenseOp` cores (3 steps of τ = 10),
    against the JAX package's at every stop."""
    E, A, B, C, L0, cap = _compiled_inputs()
    tau, q, nsteps = 10.0, C.shape[0], 3
    gt = tcomp._ROS2_GAMMA * tau
    sv = tcomp.heuristic_shifts_host(E, gt * A - 0.5 * E, 10, 10, 10)
    shifts = np.asarray([s.real for s in sv])
    tspan = (4500.0, 4500.0 - nsteps * tau)
    cfg = tcomp.CompiledConfig(maxiters=80, compression_interval=10, r_res=24)
    Eo, Ao = DenseOp(torch.as_tensor(E)), DenseOp(torch.as_tensor(A))
    assert isinstance(tcomp.build_step_shift_solvers(
        Eo, lin_comb(scale_op(Ao, gt), -0.5, Eo), shifts), tcomp.ShiftLUs)
    X0 = lr_with_capacity(lowrank(torch.as_tensor(L0), 0.01 * torch.eye(q, dtype=torch.float64)), cap)
    prob = T.GDREProblem(Eo, Ao, torch.as_tensor(B), torch.as_tensor(C), X0, tspan)
    sol = tcomp.solve_gdre_ros2_compiled(prob, dt=-tau, shifts=shifts, cfg=cfg,
                                         capacity=cap, abstol=1e-12)

    X0j = jlr.lr_with_capacity(jlr.lowrank(jnp.asarray(L0), 0.01 * jnp.eye(q)), cap)
    probj = J.GDREProblem(jops.DenseOp(jnp.asarray(E)), jops.DenseOp(jnp.asarray(A)),
                          jnp.asarray(B), jnp.asarray(C), X0j, tspan)
    cfg_j = jcomp.CompiledConfig(maxiters=80, compression_interval=10, r_res=24)
    ref = jcomp.solve_gdre_ros2_compiled(probj, dt=-tau, shifts=jnp.asarray(shifts),
                                         cfg=cfg_j, capacity=cap, abstol=1e-12)
    assert sol.adi_iters == int(ref.adi_iters)
    assert len(sol.K) == len(ref.K) == nsteps + 1
    for K, Kj in zip(sol.K, ref.K):
        assert _rel(K, Kj) < 1e-10

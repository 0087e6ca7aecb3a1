"""The host ADI through the public API: the port's `solve(GALEProblem,
ADI(...))` against the JAX package's on the same numpy inputs, f64 on the
CPU, and the resumable solver object (`init` / `step` / `done`).

Tolerances: equal iteration counts and shift sequences; ``LDLᵀ`` within
1e-9 relative (the same factorizations and Krylov iterations, rounding
only; the Krylov tolerance 1e-12 amplified by the ADI); the ADI's own
residual under the reference's stopping tolerance n·eps·‖C‖ and the
residual of the returned ``X`` under 1e-10·‖C‖ (the reference's
``tiny_random.jl`` bound).  Shifts agree to 1e-10 relative where they were
drawn while the ADI's relative residual was above 1e-6; below that the
residual factor carries its own rounding error (about eps·‖W₀‖/‖W‖
relative) into the projected pencil, so only the count and the real/complex
pattern are held equal.  A conjugate pair's order is the eigensolver's (the
double step does not depend on it) and is compared as a pair.

The Penzl cases on sparse operators run their Arnoldi with
``alg_E = alg_A = Backslash()`` (the JAX API's own knob): with the default
Krylov inverse the JAX package compiles a new BiCGStab loop for each of its
40 Arnoldi steps (20 s at n = 371).  The nonsymmetric case keeps the
default Krylov Arnoldi, at (6, 8, 8).
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import differentialriccatiequations_jl_tpu as J  # noqa: E402
import differentialriccatiequations_jl_tpu_torch as T  # noqa: E402
from differentialriccatiequations_jl_tpu.ops import dia as jdia  # noqa: E402
from differentialriccatiequations_jl_tpu.ops import sparse as jsparse  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.convert import (  # noqa: E402
    config_from, gale_problem_from_numpy)
from differentialriccatiequations_jl_tpu_torch.utils import callbacks as tcb  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils.testmat import (  # noqa: E402
    conv_diff_surrogate, rail_surrogate, random_pencil, random_rhs_lowrank)

jcb = importlib.import_module("differentialriccatiequations_jl_tpu.utils.callbacks")
JS = J.Shifts
EPS = float(np.finfo(np.float64).eps)
SHIFT_TOL, SHIFT_GATE = 1e-10, 1e-6


def _recorder(mod):
    class Rec(mod.Observer):
        def __init__(self):
            self.shifts, self.gates, self.events = [], [], []
            self.rn0 = self.rn = None

        def observe_gale_start(self, prob, alg):
            self.events.append("start")

        def observe_gale_step(self, it, X, res, rn):
            self.events.append("step")
            if it == 0:
                self.rn0 = rn
            self.rn = rn

        def observe_gale_metadata(self, desc, mu):
            assert desc == "ADI shifts"
            self.shifts.append(complex(mu))
            self.gates.append(self.rn / self.rn0 if self.rn0 else 0.0)

        def observe_gale_done(self, iters, X, res, rn):
            self.events.append("done")

        def observe_gale_failed(self):
            self.events.append("failed")

    return Rec()


def _canon(shifts):
    out, i = [], 0
    while i < len(shifts):
        v = shifts[i]
        if (v.imag != 0 and i + 1 < len(shifts)
                and abs(shifts[i + 1] - v.conjugate()) <= 1e-8 * abs(v)):
            out += sorted(shifts[i:i + 2], key=lambda z: -z.imag)
            i += 2
        else:
            out.append(v)
            i += 1
    return out


def assert_same_shifts(jr, tr):
    assert len(jr.shifts) == len(tr.shifts)
    a, b = _canon(jr.shifts), _canon(tr.shifts)
    assert [z.imag != 0 for z in a] == [z.imag != 0 for z in b]
    for x, y, g in zip(a, b, jr.gates):
        if g >= SHIFT_GATE:
            assert abs(x - y) <= SHIFT_TOL * abs(x), (x, y, g)


def _lr(X):
    return np.asarray(X.L), np.asarray(X.D), int(X.k)


def _dia(op):
    return dict(data=np.asarray(op.data), data_t=np.asarray(op.data_t), offsets=op.offsets,
                n=op.n, nnz=op.nnz_, symmetric=op.symmetric)


def _bell(op):
    return dict(cols=np.asarray(op.cols), data=np.asarray(op.data),
                cols_t=np.asarray(op.cols_t), data_t=np.asarray(op.data_t),
                diag=np.asarray(op.diag_), n=op.n, bs=op.bs)


def _compare(jprob, tprob, jalg):
    """Both packages' solves; returns the port's solver and both recorders."""
    jr, tr = _recorder(jcb), _recorder(tcb)
    Xj = J.solve(jprob, jalg, observer=jr)
    solver = T.init(tprob, config_from(jalg), observer=tr)
    Xt = solver.solve()
    assert_same_shifts(jr, tr)
    Dj = np.asarray(J.lr_to_dense(Xj))
    Dt = T.lr_to_dense(Xt).numpy()
    assert np.linalg.norm(Dt - Dj) <= 1e-9 * np.linalg.norm(Dj)
    nC = float(T.lr_norm(tprob.C))
    assert solver.residual_norm <= tprob.n * EPS * nC
    assert float(T.lr_norm(T.residual(tprob, Xt))) < 1e-10 * nC
    return solver, jr, tr


GRID = [(True, True), (True, False), (False, True), (False, False)]


@pytest.mark.parametrize("symE,symA", GRID)
def test_dense_projection_matches_jax(symE, symA):
    """`random_pencil(50)` in the four symmetry combinations, default
    `ADI()` (Projection(2)), dense LU shifted solves."""
    seed = 10 + symE * 2 + symA
    E, A = random_pencil(50, symmetric_E=symE, symmetric_A=symA, seed=seed)
    G, S = random_rhs_lowrank(50, 4, seed=seed + 100)
    jprob = J.GALEProblem(E, A, J.lowrank(G, S))
    _compare(jprob, gale_problem_from_numpy(E, A, _lr(jprob.C), device="cpu"), J.ADI())


PENZL = JS.Cyclic(JS.Heuristic(10, 20, 20, alg_E=J.Backslash(), alg_A=J.Backslash()))


def test_rail_dia_penzl_matches_jax():
    """The Rail surrogate at n = 371 on DIA operators, Penzl shifts; the
    shifted solves are BiCGStab with the diagonal Jacobi preconditioner."""
    E, A, _, C = rail_surrogate(371)
    jE, jA = jdia.dia_pencil(E, A)
    jprob = J.GALEProblem(jE, jA, J.lowrank(np.asarray(C).T.copy()))
    tprob = gale_problem_from_numpy(_dia(jE), _dia(jA), _lr(jprob.C), device="cpu")
    solver, _, _ = _compare(jprob, tprob, J.ADI(shifts=PENZL, maxiters=200))
    assert all(mu.imag == 0 for mu in solver.shifts)


def test_rail_bell_penzl_matches_jax():
    """The Rail surrogate at n = 512 on block-ELL operators (bs = 128;
    n % bs == 0, as the JAX package's padding needs: ROADMAP Queue 3)."""
    E, A, _, C = rail_surrogate(512)
    jE, jA = jsparse.bell_pencil(E, A, bs=128)
    jprob = J.GALEProblem(jE, jA, J.lowrank(np.asarray(C).T.copy()))
    tprob = gale_problem_from_numpy(_bell(jE), _bell(jA), _lr(jprob.C), device="cpu")
    _compare(jprob, tprob, J.ADI(shifts=PENZL, maxiters=200))


@pytest.mark.parametrize("shifts", [None, JS.Cyclic(JS.Heuristic(6, 8, 8))],
                         ids=["projection", "penzl-krylov"])
def test_complex_double_steps_match_jax(shifts):
    """A nonsymmetric convection–diffusion DIA pencil: conjugate shift
    pairs, so complex double steps whose shifted operators are complex
    (complex BiCGStab through the complex product route)."""
    E, A, _, C = conv_diff_surrogate(256)
    jE, jA = jdia.dia_pencil(E, A)
    jprob = J.GALEProblem(jE, jA, J.lowrank(np.asarray(C).T.copy()))
    tprob = gale_problem_from_numpy(_dia(jE), _dia(jA), _lr(jprob.C), device="cpu")
    solver, _, _ = _compare(jprob, tprob, J.ADI(shifts=shifts))
    assert any(mu.imag != 0 for mu in solver.shifts)


def _dense_problem(seed):
    E, A = random_pencil(50, seed=seed)
    G, S = random_rhs_lowrank(50, 4, seed=seed + 100)
    return T.GALEProblem(torch.as_tensor(E), torch.as_tensor(A),
                         T.lowrank(torch.as_tensor(G), torch.as_tensor(S)))


def test_stepwise_iteration_matches_solve():
    """`init` / `step` / `done`: one or two iterations per step, the same
    ``X`` as `solve`."""
    prob = _dense_problem(40)
    solver = T.init(prob, T.ADI())
    prev = 0
    while not solver.done:
        solver.step()
        assert prev + 1 <= solver.iters <= prev + 2
        prev = solver.iters
    if solver.last_compression > 0:
        solver.compress()
    Dl = T.lr_to_dense(solver.X)
    Dd = T.lr_to_dense(T.solve(prob, T.ADI()))
    assert torch.linalg.norm(Dl - Dd) < 1e-12 * torch.linalg.norm(Dd)


def test_warm_start_and_observer_events():
    """Warm-started from its own solution the ADI stops at once; the
    observer sees start, steps and done in order."""
    prob = _dense_problem(50)
    X1 = T.solve(prob, T.ADI())
    rec = _recorder(tcb)
    X2 = T.solve(prob, T.ADI(), initial_guess=X1, observer=rec)
    assert rec.events[0] == "start" and rec.events[-1] == "done"
    assert rec.events.count("step") <= 2
    nC = float(T.lr_norm(prob.C))
    assert float(T.lr_norm(T.residual(prob, X2))) < 1e-10 * nC
    rec = _recorder(tcb)
    with pytest.warns(UserWarning, match="ADI did not converge"):
        T.solve(prob, T.ADI(maxiters=1), observer=rec)
    assert "failed" in rec.events

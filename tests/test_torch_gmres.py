"""The GMRES slice against the JAX package on the same numpy inputs, f64
on the CPU: `Krylov(method="gmres")` (the block solver), the matrix-valued
FGMRES GALE solver `solve_gale_gmres` with and without restarts, the
compiled Newton with inner FGMRES under the capped compiled-ADI
preconditioner, the host Newton with a GMRES inner solver, and
`convert.config_from` for `GMRES` and `CappedADI`.

Tolerances, from the gaps measured here (the largest gap × 10):

* `Krylov(method="gmres")`: 1e-10 relative (measured ≤ 1.5e-15: the same
  Arnoldi, Gram–Schmidt pass and normal equations in both packages).
* `solve_gale_gmres` on ``random_pencil(50, seed=7)``: equal ``gale_step``
  events (cycle, m) and LDLᵀ within 1e-9 (measured ≤ 3.3e-14), residual
  histories within 1e-6 relative (measured 6.5e-9: the residuals below
  1e-8 of β are Gram-form norms at their rounding floor); the errors
  against the SciPy oracle `solve_gale_host` at the sizes measured for the
  JAX package: GMRES(2, maxrestarts 0 / 1 / 3) 2.9e-4 / 1.9e-7 /
  6.6e-12, GMRES(5) 4.6e-9.
* FGMRES with an ADI preconditioner: LDLᵀ within 1e-9 and both within
  1e-10 of the oracle (``tests/test_lyapunov.py``).  Its ``gale_step``
  sequence is not compared: its preconditioner is almost exact, so the
  first Hessenberg entry ``h₂₁`` is a Gram-form norm ``√tr((D·LᵀL)²)`` of a
  factor that cancels to rounding; the trace comes out positive in one
  package (``h₂₁`` ≈ √eps, another Arnoldi step) and negative in the other
  (clamped to 0: a happy breakdown).  Both end at the same ``X``.
* Compiled Newton + FGMRES (n = 128, ``tests/test_compiled.py``'s
  configuration): equal Newton steps, shift rebuilds and ``converged``;
  the residual history within 3e-4 relative or 1e-11 of the initial
  residual.  The first 12 steps agree to 4e-14; from step 12 on, inner
  solves whose breakdowns and compression cuts rounding decides (as
  above) move the history by up to 1.1e-6 relative with torch's default
  threads and 3.0e-5 on one thread, and the last residual, below
  FGMRES's 1e-8 floor, by 6.2e-13 of the initial.  ``X`` within 1e-10
  (measured 2.1e-12).
"""

import dataclasses
import importlib
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import differentialriccatiequations_jl_tpu as J  # noqa: E402
import differentialriccatiequations_jl_tpu_torch as T  # noqa: E402
from differentialriccatiequations_jl_tpu.ops import blocklinear as jbl  # noqa: E402
from differentialriccatiequations_jl_tpu.ops import dia as jdia  # noqa: E402
from differentialriccatiequations_jl_tpu.utils.testmat import (  # noqa: E402
    random_pencil, random_rhs_lowrank)
from differentialriccatiequations_jl_tpu_torch import convert  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models import compiled as tcomp  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models import gmres as tgmres  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops import blocklinear as tbl  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils import callbacks as tcb  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate  # noqa: E402

jcomp = importlib.import_module("differentialriccatiequations_jl_tpu.models.compiled")
jcb = importlib.import_module("differentialriccatiequations_jl_tpu.utils.callbacks")
jlr = importlib.import_module("differentialriccatiequations_jl_tpu.lowrank")
JS = J.Shifts


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _dia(op):
    return dict(data=np.asarray(op.data), data_t=np.asarray(op.data_t), offsets=op.offsets,
                n=op.n, nnz=op.nnz_, symmetric=op.symmetric)


def _lr(X):
    return np.asarray(X.L), np.asarray(X.D), int(X.k)


# --- Krylov(method="gmres") ------------------------------------------------------


@pytest.fixture(scope="module")
def operators():
    rng = np.random.default_rng(0)
    n = 30
    M = rng.standard_normal((n, n)) + n * np.eye(n)  # nonsymmetric
    E, A, _, _ = rail_surrogate(200)
    jE, jA = jdia.dia_pencil(E, A)
    F = jdia.shifted_dia(jE, jA, -0.7)  # lane-major (q, N), N > n
    return {
        "dense": (J.DenseOp(jnp.asarray(M)), T.DenseOp(torch.as_tensor(M)),
                  rng.standard_normal((n, 3)), {}),
        "dia": (F, convert.dia_op_from_numpy(**_dia(F), device="cpu"),
                rng.standard_normal((200, 4)),
                dict(negate=True, preconditioner="block_jacobi")),
    }


@pytest.mark.parametrize("maxiter", [1, 4])
@pytest.mark.parametrize("restart", [3, 40])
@pytest.mark.parametrize("kind", ["dense", "dia"])
def test_krylov_gmres_matches_jax(operators, kind, restart, maxiter):
    jop, top, B, kw = operators[kind]
    cfg = dict(method="gmres", restart=restart, maxiter=maxiter, tol=1e-12, **kw)
    xj = jbl.prepare(jop, J.Krylov(**cfg)).solve(jnp.asarray(B))
    solver = tbl.prepare(top, T.Krylov(**cfg))
    assert isinstance(solver, tbl.KrylovSolver)
    before = tbl.krylov_iterations
    xt = solver.solve(torch.as_tensor(B))
    assert tbl.krylov_iterations > before
    assert _rel(xt, xj) <= 1e-10


def test_krylov_gmres_breakdown():
    """A right-hand side in an invariant subspace breaks the Arnoldi down
    at its first step exactly (``restart`` 40 ≥ n·q = 4 is cut to 4); the
    solution is exact and the restart loop stops."""
    d = np.diag(np.arange(1.0, 5.0))
    b = np.zeros((4, 1))
    b[0] = 3.0
    cfg = dict(method="gmres", restart=40, maxiter=4)
    xj = jbl.prepare(J.DenseOp(jnp.asarray(d)), J.Krylov(**cfg)).solve(jnp.asarray(b))
    before = tbl.krylov_iterations
    xt = tbl.prepare(T.DenseOp(torch.as_tensor(d)), T.Krylov(**cfg)).solve(torch.as_tensor(b))
    # one restart test that passes, one Arnoldi step, one that stops
    assert tbl.krylov_iterations - before == 2
    assert _rel(xt, xj) <= 1e-10
    assert np.allclose(xt.numpy().ravel(), [3.0, 0.0, 0.0, 0.0], rtol=0, atol=1e-15)


# --- solve_gale_gmres ------------------------------------------------------------


def _recorder(mod):
    class Rec(mod.Observer):
        def __init__(self):
            self.steps, self.done, self.failed, self.ends = [], [], 0, []
            self.cut = []  # len(steps) after each cycle
            self.depth = 0  # nested ADI solves of a preconditioner

        def observe_gale_start(self, prob, alg):
            self.depth += 1

        def observe_gale_step(self, it, X, res, rn):
            if self.depth == 1:
                self.steps.append((it, rn))
                if X is not None and res is None:  # the end of a cycle
                    self.ends.append(np.asarray(X.to_dense()))
                    self.cut.append(len(self.steps))

        def observe_gale_failed(self):
            if self.depth == 1:
                self.failed += 1

        def observe_gale_done(self, iters, X, res, rn):
            if self.depth == 1:
                self.done.append(iters)
            self.depth -= 1

    return Rec()


@pytest.fixture(scope="module")
def gale():
    """``random_pencil(50, seed=7)``, ``C = random_rhs_lowrank(50, 4)``, the
    JAX solves (recorded) and the oracle."""
    E, A = random_pencil(50, seed=7)
    Gm, S = random_rhs_lowrank(50, 4)
    jprob = J.GALEProblem(E, A, J.lowrank(Gm, S))
    tprob = convert.gale_problem_from_numpy(E, A, _lr(jprob.C), device="cpu")
    X_ref = T.solve_gale_host(tprob.E, tprob.A, tprob.C.to_dense()).numpy()
    runs = {}
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        for name, alg in {
            "restarts": J.GMRES(maxiters=2, maxrestarts=3, reltol=1e-10,
                                warn_convergence=False),
            "fgmres": J.GMRES(maxiters=3, maxrestarts=0, reltol=1e-10, preconditioner=J.ADI(
                maxiters=10, shifts=JS.Cyclic(JS.Heuristic(10, 10, 10)),
                compression_interval=20, warn_convergence=False)),
        }.items():
            rec = _recorder(jcb)
            X = J.solve(jprob, alg, observer=rec)
            runs[name] = (alg, np.asarray(J.lr_to_dense(X)), rec)
    return jprob, tprob, X_ref, runs


def _solve_port(tprob, alg):
    rec = _recorder(tcb)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        X = T.solve(tprob, convert.config_from(alg), observer=rec)
    return T.lr_to_dense(X).numpy(), rec


# Errors against the oracle, measured for the JAX package (the port within
# 10 % of them): GMRES(maxiters, maxrestarts) → relative error.
ORACLE = {(2, 0): 2.9e-4, (2, 1): 1.9e-7, (2, 3): 6.6e-12, (5, 0): 4.6e-9}


@pytest.mark.parametrize("maxrestarts", [0, 1, 3])
def test_gale_gmres_restarts_match_jax(gale, maxrestarts):
    """The restart loop: the port with ``maxrestarts`` cycles − 1 against
    the JAX run with 3 restarts, cut after the same cycle (its events and
    the ``X`` at that cycle's end)."""
    _, tprob, X_ref, runs = gale
    jalg, _, jrec = runs["restarts"]
    alg = dataclasses.replace(jalg, maxrestarts=maxrestarts)
    Xt, trec = _solve_port(tprob, alg)
    # Each cycle: its start (0, β), its inner steps, its end (m, ‖R‖).
    assert len(jrec.cut) == 4
    jsteps = jrec.steps[:jrec.cut[maxrestarts]]
    assert [s[0] for s in trec.steps] == [s[0] for s in jsteps]
    for (_, a), (_, b) in zip(trec.steps, jsteps):
        assert abs(a - b) <= 1e-6 * abs(b)
    Xj = jrec.ends[maxrestarts]
    assert _rel(Xt, Xj) <= 1e-9
    err_t, err_j = _rel(Xt, X_ref), _rel(Xj, X_ref)
    assert err_j <= 1.1 * ORACLE[(2, maxrestarts)]
    assert err_t <= 1.1 * ORACLE[(2, maxrestarts)]
    assert trec.done == [2 * maxrestarts + trec.steps[-1][0]]
    assert trec.failed == (1 if maxrestarts < 3 else jrec.failed)


def test_gale_gmres_unpreconditioned(gale):
    """``tests/test_lyapunov.py``'s GMRES(maxiters=5, reltol=1e-8), held to
    the oracle at the JAX package's error (its run against the port is the
    restart test's first cycle: the same code path at another depth)."""
    _, tprob, X_ref, _ = gale
    Xt, trec = _solve_port(tprob, J.GMRES(maxiters=5, reltol=1e-8))
    assert [s[0] for s in trec.steps] == [0, 1, 2, 3, 4, 5]
    assert trec.done == [5] and trec.failed == 0
    assert _rel(Xt, X_ref) <= 1.1 * ORACLE[(5, 0)]
    E, A, C = (M.numpy() for M in (tprob.E.M, tprob.A.M, tprob.C.to_dense()))
    R = A.T @ Xt @ E + E.T @ Xt @ A + C
    assert np.linalg.norm(R) <= 1e-8 * np.linalg.norm(C)


def test_fgmres_adi_preconditioned_matches_jax(gale):
    """``tests/test_lyapunov.py``'s FGMRES with an ADI(Cyclic(Heuristic))
    preconditioner; both within 1e-10 of the oracle."""
    _, tprob, X_ref, runs = gale
    alg, Xj, jrec = runs["fgmres"]
    Xt, trec = _solve_port(tprob, alg)
    assert trec.failed == jrec.failed == 0
    assert _rel(Xt, Xj) <= 1e-9
    assert _rel(Xt, X_ref) <= 1e-10 and _rel(Xj, X_ref) <= 1e-10
    assert trec.steps[0] == pytest.approx(jrec.steps[0], rel=1e-12)


def test_gmres_timers_events_and_warning(gale):
    """The timers ``gmres.preconditioner`` and ``gmres.lyapunov_op``, the
    observer events and the JAX package's warning text."""
    from differentialriccatiequations_jl_tpu_torch.utils import timers

    _, tprob, _, runs = gale
    timers.reset()
    timers.enable(True)
    try:
        T.solve(tprob, convert.config_from(runs["fgmres"][0]))
    finally:
        timers.enable(False)
    rep = timers.report()
    assert rep["gmres.preconditioner"][1] == rep["gmres.lyapunov_op"][1] >= 1
    with pytest.warns(UserWarning, match=r"GMRES did not converge: residual=.* "
                      r"abstol=.* maxrestarts=0 maxiters=2"):
        T.solve(tprob, T.GMRES(maxiters=2, reltol=1e-10))


def test_specialize_shares_one_oracle():
    """`specialize` initializes a preconditioner's cyclic shifts once per
    problem: every application of the preconditioner draws from the same
    oracle, which keeps its position."""
    E, A = random_pencil(20, seed=3)
    G, S = random_rhs_lowrank(20, 2)
    prob = convert.gale_problem_from_numpy(E, A, (G, S, 2), device="cpu")
    alg = T.GMRES(preconditioner=T.ADI(shifts=T.Shifts.Cyclic((-1.0, -2.0, -3.0))))
    spec = tgmres.specialize(alg, prob)
    oracle = spec.preconditioner.shifts
    assert isinstance(oracle, T.Shifts.ShiftOracle)
    assert [oracle.take() for _ in range(4)] == [-1.0, -2.0, -3.0, -1.0]
    assert tgmres.specialize(spec, prob).preconditioner.shifts is oracle
    assert tgmres.specialize(None, prob) is None


# --- the compiled Newton with inner FGMRES ---------------------------------------


N_NEWTON = 128


def _gare_problems():
    E, A, B, C = rail_surrogate(N_NEWTON)
    jE, jA = jdia.dia_pencil(E, A)
    jp = J.GAREProblem(jE, jA, jlr.lowrank(jnp.asarray(1000.0 * B)), jlr.lowrank(jnp.asarray(C.T)))
    tp = convert.gare_problem_from_numpy(_dia(jE), _dia(jA), _lr(jp.G), _lr(jp.Q), device="cpu")
    return jp, tp


FGMRES = dict(maxiters=5, maxrestarts=0, ignore_initial_guess=True, warn_convergence=False)


@pytest.fixture(scope="module")
def newton_fgmres():
    jp, tp = _gare_problems()
    gm = J.GMRES(**FGMRES, preconditioner=jcomp.CappedADI(maxiters=10, r_in=48, capacity=160))
    kw = dict(capacity=128, reltol=1e-8)
    Xj, ij = jcomp.solve_gare_newton_compiled(
        jp, shifts=jcomp.PerStepHeuristic(10, 12, 12),
        cfg=jcomp.CompiledConfig(maxiters=60, r_res=32), inner_gmres=gm, **kw)
    Xt, it = tcomp.solve_gare_newton_compiled(
        tp, shifts=tcomp.PerStepHeuristic(10, 12, 12),
        cfg=tcomp.CompiledConfig(maxiters=60, r_res=32),
        inner_gmres=convert.config_from(gm), **kw)
    return (np.asarray(J.lr_to_dense(Xj)), ij), (Xt, it), tp


def test_newton_fgmres_compiled_matches_jax(newton_fgmres):
    (Xj, ij), (Xt_lr, it), tp = newton_fgmres
    Xt = T.lr_to_dense(Xt_lr).numpy()
    for key in ("newton_steps", "shift_rebuilds", "converged", "adi_iters"):
        assert ij[key] == it[key], key
    assert np.allclose(it["thetas"], ij["thetas"], rtol=1e-12, atol=0)
    assert it["converged"] and set(it["adi_iters"]) == {-1}
    hj, ht = np.asarray(ij["residuals"]), np.asarray(it["residuals"])
    assert hj.shape == ht.shape
    assert np.all(np.abs(ht - hj) <= 3e-4 * hj + 1e-11 * hj[0])
    assert _rel(Xt, Xj) <= 1e-10
    nQ = float(T.lr_norm(tp.Q))
    assert float(T.lr_norm(T.residual(tp, Xt_lr))) <= 1e-8 * nQ


def test_compiled_adi_preconditioner_matches_jax():
    """`make_compiled_adi_preconditioner` on the same shifted cores, for an
    incoming vector narrower and one wider than ``r_in`` (cut to ``r_in``
    columns by `lr_with_capacity`, as in the JAX package); exactly
    ``maxiters`` ADI iterations."""
    E, A, _, _ = rail_surrogate(N_NEWTON)
    jE, jA = jdia.dia_pencil(E, A)
    shifts = np.asarray([-0.5, -1.0, -2.0, -4.0])
    jops = jcomp.build_dia_shift_ops(jE, jA, jnp.asarray(shifts))
    tops = convert.dia_shift_ops_from_numpy(
        np.asarray(jops.data), np.asarray(jops.data_t), np.asarray(jops.prec_inv),
        jops.offsets, jops.n, jops.nnz_, jops.cfg, device="cpu")
    tE, tA = (convert.dia_op_from_numpy(**_dia(op), device="cpu") for op in (jE, jA))
    rng = np.random.default_rng(4)
    kw = dict(maxiters=6, r_in=8, capacity=48)
    pj = jcomp.make_compiled_adi_preconditioner(jE, jA, jops, jnp.asarray(shifts), **kw)
    pt = tcomp.make_compiled_adi_preconditioner(tE, tA, tops, shifts, **kw)
    calls = []
    real_adi = tcomp.adi_compiled

    def counting(*a, **k):
        out = real_adi(*a, **k)
        calls.append(out[2])
        return out

    tcomp.adi_compiled = counting
    try:
        for k in (5, 12):  # narrower and wider than r_in
            L = rng.standard_normal((N_NEWTON, k))
            D = np.diag(rng.standard_normal(k))
            Zj = pj(J.GALEProblem(jE, jA, jlr.lowrank(jnp.asarray(L), jnp.asarray(D))))
            Zt = pt(T.GALEProblem(tE, tA, T.lowrank(torch.as_tensor(L), torch.as_tensor(D))))
            assert Zt.r == 48
            assert _rel(T.lr_to_dense(Zt), np.asarray(J.lr_to_dense(Zj))) <= 1e-10
    finally:
        tcomp.adi_compiled = real_adi
    assert calls == [6, 6]


# --- the host Newton with a GMRES inner solver ------------------------------------


def test_host_newton_gmres_matches_jax():
    """``tests/test_newton.py``'s Newton+FGMRES(ADI) on the dense n = 40
    Rail surrogate.  The Newton residuals agree within 1e-9 relative while
    they are above 1e-7 of the first (measured 3.0e-11); below, near
    FGMRES's floor, the inner solves' happy breakdowns follow the sign of
    rounding (see the module docstring) and the two trajectories part
    (the JAX package converges in 7 steps, the port in 8).  Both reach
    1e-10·‖Q‖; ``X`` within 1e-9 (measured 9.9e-11)."""
    E, A, B, C = rail_surrogate(40)
    Ed, Ad = E.toarray(), A.toarray()
    jprob = J.GAREProblem(Ed, Ad, J.lowrank(np.asarray(B)), J.lowrank(np.asarray(C).T))
    tprob = convert.gare_problem_from_numpy(Ed, Ad, _lr(jprob.G), _lr(jprob.Q), device="cpu")
    t = 8
    gm = J.GMRES(maxiters=5, maxrestarts=0, ignore_initial_guess=True, warn_convergence=False,
                 preconditioner=J.ADI(maxiters=t, shifts=JS.Cyclic(JS.Heuristic(t, t, t)),
                                      compression_interval=2 * t, warn_convergence=False))
    alg = J.Newton(gm, maxiters=12, reltol=1e-10)

    class Steps:
        def __init__(self, mod):
            self.norms = []
            base = mod.Observer

            class O(base):
                def observe_gare_step(_, i, X, res, rn):
                    self.norms.append(rn)

            self.obs = O()

    js, ts = Steps(jcb), Steps(tcb)
    Xj = J.solve(jprob, alg, observer=js.obs)
    Xt = T.solve(tprob, convert.config_from(alg), observer=ts.obs)
    above = [i for i, r in enumerate(js.norms) if r > 1e-7 * js.norms[0]]
    assert len(above) >= 4
    for i in above:
        assert abs(ts.norms[i] - js.norms[i]) <= 1e-9 * js.norms[i]
    nQ = float(T.lr_norm(tprob.Q))
    assert js.norms[-1] < 1e-10 * nQ and ts.norms[-1] < 1e-10 * nQ
    assert float(T.lr_norm(T.residual(tprob, Xt))) < 1e-10 * nQ
    assert _rel(T.lr_to_dense(Xt), np.asarray(J.lr_to_dense(Xj))) <= 1e-9


def test_config_from_gmres_and_capped_adi():
    adi = J.ADI(maxiters=7, shifts=JS.Cyclic(JS.Heuristic(4, 5, 6)), compression_interval=14)
    got = convert.config_from(J.GMRES(maxiters=4, maxrestarts=2, reltol=1e-9, abstol=1e-3,
                                      ignore_initial_guess=True, compression=False,
                                      preconditioner=adi, warn_convergence=False))
    assert got == T.GMRES(maxiters=4, maxrestarts=2, reltol=1e-9, abstol=1e-3,
                          ignore_initial_guess=True, compression=False,
                          preconditioner=convert.config_from(adi), warn_convergence=False)
    assert got.preconditioner.shifts == T.Shifts.Cyclic(T.Shifts.Heuristic(4, 5, 6))
    assert convert.config_from(jcomp.CappedADI(15, 64, 192)) == tcomp.CappedADI(15, 64, 192)
    assert convert.config_from(J.GMRES()).preconditioner is None


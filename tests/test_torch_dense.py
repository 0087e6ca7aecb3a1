"""The dense GALE solvers, the dense residuals and the dense shifted cores
of the compiled ADI: the port against the JAX package on the same numpy
inputs, f64 on the CPU; and the two repairs of the port's ``lr_add`` and
``prepare``.

Tolerances: the reference's ``tiny_random.jl`` residual 1e-10 (Kronecker
1e-8); port vs JAX ``X`` within 1e-10 relative (the same LUs and GEMMs in
another summation order, amplified by the 40-step iteration); a carried
sign-function cache replays within 1e-12; the scales ``c_k`` agree within
1e-12 (the port reads ``log|det M_k|`` off the LU it inverts with, the JAX
package off a second LU of the same matrix); residuals low-rank vs dense
within 1e-10 (``tests/test_residuals.py``); the compiled ADI on dense cores
within 1e-10 of the JAX package's with equal iteration counts.
"""

import importlib
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import differentialriccatiequations_jl_tpu as J  # noqa: E402
import differentialriccatiequations_jl_tpu_torch as T  # noqa: E402
from differentialriccatiequations_jl_tpu.utils import testmat as jtm  # noqa: E402
from differentialriccatiequations_jl_tpu_torch import convert  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.lowrank import (  # noqa: E402
    lowrank, lr_append, lr_to_dense, lr_zero)
from differentialriccatiequations_jl_tpu_torch.models import compiled as tcomp  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models import lyapunov_dense as tld  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models.residuals import (  # noqa: E402
    residual_gale_dense, residual_gare_dense)
from differentialriccatiequations_jl_tpu_torch.ops.blocklinear import (  # noqa: E402
    Krylov, KrylovSolver, prepare)
from differentialriccatiequations_jl_tpu_torch.ops import blocklinear  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops.dia import dia_pencil  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops.operators import DenseOp  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils import testmat as ttm  # noqa: E402

jld = importlib.import_module("differentialriccatiequations_jl_tpu.models.lyapunov_dense")
jres = importlib.import_module("differentialriccatiequations_jl_tpu.models.residuals")
jcomp = importlib.import_module("differentialriccatiequations_jl_tpu.models.compiled")
jlr = importlib.import_module("differentialriccatiequations_jl_tpu.lowrank")
jops = importlib.import_module("differentialriccatiequations_jl_tpu.ops.operators")

N, G = 50, 4
GRID = [(True, True), (True, False), (False, True), (False, False)]


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _t(x):
    return torch.as_tensor(np.asarray(x))


def _pencil(symE, symA):
    seed = symE * 2 + symA
    E, A = ttm.random_pencil(N, symmetric_E=symE, symmetric_A=symA, seed=seed)
    Gm, S = ttm.random_rhs_lowrank(N, G, seed=seed + 100)
    return E, A, Gm, S


def test_testmat_helpers_match_jax():
    for symE, symA in GRID:
        for a, b in zip(ttm.random_pencil(N, symmetric_E=symE, symmetric_A=symA, seed=3),
                        jtm.random_pencil(N, symmetric_E=symE, symmetric_A=symA, seed=3)):
            assert np.array_equal(a, b)
    for a, b in zip(ttm.random_rhs_lowrank(N, 3, seed=4), jtm.random_rhs_lowrank(N, 3, seed=4)):
        assert np.array_equal(a, b)
    for a, b in zip(ttm.conv_diff_surrogate(96), jtm.conv_diff_surrogate(96)):
        a, b = (m.toarray() if hasattr(m, "toarray") else m for m in (a, b))
        assert np.array_equal(a, b)
    got = ttm.rail_surrogate_dense(40, device="cpu")
    for a, b in zip(got, jtm.rail_surrogate_dense(40)):
        assert a.dtype == torch.float64 and a.device.type == "cpu"
        assert np.array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("symE,symA", GRID)
def test_gale_solvers_match_jax(symE, symA):
    """Sign function vs SciPy oracle vs Kronecker through `solve`, with
    their residuals, and the port's sign-function X against the JAX
    package's (``tests/test_lyapunov.py:57-84``)."""
    E, A, Gm, S = _pencil(symE, symA)
    Cd = Gm @ S @ Gm.T
    prob = T.GALEProblem(_t(E), _t(A), lowrank(_t(Gm), _t(S)))
    X_sign = T.solve(prob, T.BartelsStewart())
    X_host = T.solve(prob, T.BartelsStewart(host=True))
    X_kron = T.solve(prob, T.Kronecker())
    res0 = np.linalg.norm(Cd)
    for X, tol in ((X_sign, 1e-10), (X_host, 1e-10), (X_kron, 1e-8)):
        assert float(torch.linalg.norm(T.residual(prob, X))) / res0 < tol
    assert _rel(X_sign, X_host) < 1e-10
    assert _rel(X_kron, X_host) < 1e-8

    jprob = J.GALEProblem(E, A, J.lowrank(Gm, S))
    assert _rel(X_sign, J.solve(jprob, J.BartelsStewart())) < 1e-10
    assert _rel(X_host, J.solve(jprob, J.BartelsStewart(host=True))) < 1e-10
    assert _rel(X_kron, J.solve(jprob, J.Kronecker())) < 1e-10


@pytest.mark.parametrize("symE,symA", [(True, True), (False, False)])
def test_sign_cache_matches_jax(symE, symA):
    """The scales and inverses against the JAX package's; its cache carried
    across by `convert` (0-based pivots made 1-based) replays one
    right-hand side as the port's own cache does.  The unsymmetric ``E``
    is where a wrong transpose in ``E⁻ᵀ C E⁻¹`` would show."""
    E, A, Gm, S = _pencil(symE, symA)
    jc = jld.sign_function_cache(E, A)
    tc = tld.sign_function_cache(_t(E), _t(A))
    cs_j = np.asarray(jc.cs)
    assert np.abs(tc.cs.numpy() - cs_j).max() <= 1e-12 * np.abs(cs_j).max()
    assert _rel(tc.Minvs, jc.Minvs) < 1e-12
    carried = convert.sign_cache_from_numpy(jc.E_lu, jc.E_piv, jc.Minvs, jc.cs, device="cpu")
    assert carried.E_piv.dtype == tc.E_piv.dtype
    assert torch.equal(carried.E_piv, tc.E_piv)
    C = Gm @ S @ Gm.T + np.diag(np.arange(N, dtype=float))
    X_ref = np.asarray(jc.solve(C))
    assert _rel(carried.solve(_t(C)), X_ref) < 1e-12
    assert _rel(tc.solve(_t(C)), X_ref) < 1e-12


def test_sign_iteration_runs_all_iterations():
    """No early exit: every slot holds an inverse and a scale; the tail
    replays as fixed points (``c_k = 1``, ``M_k⁻¹ = −I``)."""
    E, A, _, _ = _pencil(True, True)
    c = tld.sign_function_cache(_t(E), _t(A), maxiters=12)
    assert c.Minvs.shape == (12, N, N) and c.cs.shape == (12,)
    assert torch.allclose(c.cs[-1], torch.tensor(1.0, dtype=torch.float64), atol=1e-14)
    eye = torch.eye(N, dtype=torch.float64)
    assert float(torch.linalg.norm(c.Minvs[-1] + eye)) < 1e-12


@pytest.mark.parametrize("kind", ["definite", "indefinite"])
def test_dense_residuals_match_lowrank_and_jax(kind):
    """Dense GALE and GARE residuals against the low-rank ones and the JAX
    package's dense ones (``tests/test_residuals.py:43-80``)."""
    rng = np.random.default_rng(1)
    n = 20
    E = rng.standard_normal((n, n)) * (rng.random((n, n)) < 1.0 / n) + np.eye(n)
    A = rng.standard_normal((n, n)) * (rng.random((n, n)) < 1.0 / n) - np.eye(n)
    Z = rng.standard_normal((n, 2))
    Dz = 2.0 * (np.eye(2)[:, ::-1] if kind == "indefinite" else np.eye(2))
    Cg = np.random.default_rng(5).standard_normal((n, 4))
    Qg = np.random.default_rng(7).standard_normal((n, 3))
    Xd = Z @ Dz @ Z.T

    C, X = lowrank(_t(Cg), torch.eye(4, dtype=torch.float64)), lowrank(_t(Z), _t(Dz))
    Q = lowrank(_t(Qg), torch.eye(3, dtype=torch.float64))
    gale = T.GALEProblem(_t(E), _t(A), C)
    res_d = T.residual(gale, _t(Xd))
    assert np.allclose(lr_to_dense(T.residual(gale, X)).numpy(), res_d.numpy(), atol=1e-10)
    res_j = jres.residual_gale_dense(E, A, J.lowrank(Cg, np.eye(4)), Xd)
    assert _rel(res_d, res_j) < 1e-13
    assert _rel(residual_gale_dense(_t(E), _t(A), lr_to_dense(C), _t(Xd)), res_j) < 1e-13

    gare = T.GAREProblem(_t(E), _t(A), C, Q)
    res_d = T.residual(gare, _t(Xd))
    assert np.allclose(lr_to_dense(T.residual(gare, X)).numpy(), res_d.numpy(), atol=1e-10)
    res_j = jres.residual_gare_dense(E, A, J.lowrank(Cg, np.eye(4)),
                                     J.lowrank(Qg, np.eye(3)), Xd)
    assert _rel(res_d, res_j) < 1e-13
    assert _rel(residual_gare_dense(_t(E), _t(A), C, lr_to_dense(Q), _t(Xd)), res_j) < 1e-13


def test_shift_lus_pivots_round_trip():
    """The JAX package's batched shifted LUs carried across by `convert`
    solve as the port's own: pivots 0-based there, 1-based here."""
    E, A, _, _ = _pencil(False, False)
    shifts = np.asarray([-40.0, -55.0 + 7.0j, -55.0 - 7.0j])
    jl = jcomp.build_shift_lus(jops.DenseOp(jnp.asarray(E)), jops.DenseOp(jnp.asarray(A)),
                               jnp.asarray(shifts))
    tl = tcomp.build_shift_lus(DenseOp(_t(E)), DenseOp(_t(A)), shifts)
    carried = convert.shift_lus_from_numpy(jl.lu, jl.piv, device="cpu")
    assert tl.lu.dtype == torch.complex128 and tl.lu.shape == (3, N, N)
    assert torch.equal(carried.piv, tl.piv)
    assert np.array_equal(carried.piv.numpy() - 1, np.asarray(jl.piv))
    W = np.random.default_rng(0).standard_normal((N, 3))
    for s, mu in enumerate(shifts):
        x_ref = np.linalg.solve(A.T + mu * E.T, W)
        assert _rel(carried.core_solver(s).solve(_t(W)), x_ref) < 1e-12
        assert _rel(tl.core_solver(s).solve(_t(W)), x_ref) < 1e-12


def test_adi_compiled_dense_odd_complex_buffer():
    """The compiled ADI on dense cores with an odd-length complex shift
    buffer on the nonsymmetric conv-diff pencil (the JAX package's
    ``tests/test_compiled.py:406``): complex batched LUs, whole conjugate
    pairs across the cyclic wrap, and the JAX package's iterate."""
    n, q = 96, 3
    E, A, _, _ = ttm.conv_diff_surrogate(n)
    Ed, Ad = E.toarray(), A.toarray()
    Gm, S = ttm.random_rhs_lowrank(n, q, seed=7)
    sv = np.asarray(tcomp.heuristic_shifts_host(E, A, 9, 12, 12))
    assert np.iscomplexobj(sv) and np.any(np.abs(sv.imag) > 0)
    shifts = tcomp._shift_buffer(sv, torch.float64, 9)
    tcomp.check_shift_pairing(shifts)
    abstol = 1e-11 * float(np.linalg.norm(Gm @ S @ Gm.T))

    cfg = tcomp.CompiledConfig(maxiters=80, compression_interval=10, r_res=q)
    Eo, Ao = DenseOp(_t(Ed)), DenseOp(_t(Ad))
    lus = tcomp.build_step_shift_solvers(Eo, Ao, shifts)
    assert isinstance(lus, tcomp.ShiftLUs) and lus.lu.is_complex()
    X, _, iters, res = tcomp.adi_compiled(Eo, Ao, _t(Gm), _t(S), q,
                                          lr_zero(n, 64, torch.float64, device="cpu"), shifts,
                                          abstol, cfg, lus)
    assert float(res) <= abstol
    prob = T.GALEProblem(Eo, Ao, lowrank(_t(Gm), _t(S)))
    assert float(T.lr_norm(T.residual(prob, X))) / float(T.lr_norm(prob.C)) < 1e-10

    cfg_j = jcomp.CompiledConfig(maxiters=80, compression_interval=10, r_res=q)
    Ej, Aj = jops.DenseOp(jnp.asarray(Ed)), jops.DenseOp(jnp.asarray(Ad))
    sj = jnp.asarray(shifts)
    Xj, _, it_j, _ = jcomp.adi_compiled(Ej, Aj, jnp.asarray(Gm), jnp.asarray(S), jnp.int32(q),
                                        jlr.lr_zero(n, 64, jnp.float64), sj, abstol, cfg_j,
                                        jcomp.build_shift_lus(Ej, Aj, sj))
    assert iters == int(it_j)
    assert _rel(lr_to_dense(X), jlr.lr_to_dense(Xj)) < 1e-10


def test_dense_pair_encoded_conjugates_raise():
    E, A, _, _ = _pencil(True, True)
    with pytest.raises(ValueError):
        tcomp.build_step_shift_solvers(DenseOp(_t(E)), DenseOp(_t(A)),
                                       np.asarray([[-40.0, 3.0], [-50.0, 0.0]]))


def test_lr_add_warns_on_truncation_like_jax():
    """`lr_add` warns as the JAX package does on eager paths when the
    combined rank passes the output capacity; `lr_append`, the compiled
    paths' sum, drops the same columns silently."""
    rng = np.random.default_rng(0)
    L = rng.standard_normal((10, 3))
    X, Y = lowrank(_t(L), torch.eye(3, dtype=torch.float64)), lowrank(_t(2 * L), torch.eye(3, dtype=torch.float64))
    with pytest.warns(RuntimeWarning, match="exceeds output capacity") as got:
        Z = T.lr_add(X, Y, r_out=4)
    with pytest.warns(RuntimeWarning) as want:
        Zj = jlr.lr_add(J.lowrank(L, np.eye(3)), J.lowrank(2 * L, np.eye(3)), r_out=4)
    assert str(got[0].message) == str(want[0].message)
    assert Z.k == int(Zj.k) == 4
    assert np.allclose(lr_to_dense(Z).numpy(), np.asarray(jlr.lr_to_dense(Zj)), atol=1e-13)
    with pytest.warns(RuntimeWarning):
        T.lr_sub(X, Y, r_out=5)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        assert torch.equal(lr_append(X, Y, r_out=4).L, Z.L)
        T.lr_add(X, Y, r_out=6)


def test_adi_compiled_drops_columns_silently(monkeypatch):
    """A capacity the increments overflow: the compiled ADI drops columns
    without a warning, as the JAX package's compiled ADI does (with
    `lr_add` in its place, the same run warns)."""
    E, A, Gm, S = _pencil(True, True)
    shifts = np.asarray([-40.0, -60.0])
    Eo, Ao = DenseOp(_t(E)), DenseOp(_t(A))
    cfg = tcomp.CompiledConfig(maxiters=6, compression_interval=100, r_res=G)
    lus = tcomp.build_shift_lus(Eo, Ao, shifts)

    def run():
        return tcomp.adi_compiled(Eo, Ao, _t(Gm), _t(S), G,
                                  lr_zero(N, 2 * G + 1, torch.float64, device="cpu"), shifts,
                                  0.0, cfg, lus)

    with warnings.catch_warnings():
        warnings.simplefilter("error")
        X, _, iters, _ = run()
    assert iters == 6 and X.k == X.r
    monkeypatch.setattr(tcomp, "lr_append", T.lr_add)
    with pytest.warns(RuntimeWarning, match="exceeds output capacity"):
        run()


def test_krylov_solve_dtype_equal_to_operator_runs_plain_krylov():
    """A `Krylov(solve_dtype="float64")` carried across from the JAX
    package solves f64 operators as plain Krylov, with the iteration count
    of ``solve_dtype=None``; another dtype runs the refined mixed-precision
    solver."""
    from differentialriccatiequations_jl_tpu.ops.blocklinear import Krylov as JKrylov

    E, A, _, _ = ttm.rail_surrogate(128)
    _, Fo = dia_pencil(E, A, device="cpu")
    B = torch.as_tensor(np.random.default_rng(2).standard_normal((128, 3)))
    cfg = convert.krylov_from(JKrylov(method="bicgstab", tol=1e-12, solve_dtype="float64"))
    assert cfg.solve_dtype == "float64"
    outs = []
    for alg in (cfg, Krylov(method="bicgstab", tol=1e-12)):
        before = blocklinear.krylov_iterations
        solver = prepare(Fo, alg)
        assert isinstance(solver, KrylovSolver)
        outs.append((solver.solve(B), blocklinear.krylov_iterations - before))
    assert outs[0][1] == outs[1][1] > 0
    assert torch.equal(outs[0][0], outs[1][0])
    assert float(torch.linalg.norm(Fo.mm(outs[0][0]) - B) / torch.linalg.norm(B)) < 1e-10
    refined = prepare(Fo, Krylov(method="bicgstab", tol=1e-12, solve_dtype="float32"))
    assert isinstance(refined, blocklinear.RefinedKrylovSolver)
    assert refined.inner.op.dtype == torch.float32
    x = refined.solve(B)
    assert x.dtype == torch.float64
    assert float(torch.linalg.norm(Fo.mm(x) - B) / torch.linalg.norm(B)) < 1e-10

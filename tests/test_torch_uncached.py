"""The compiled ADI and Ros1 step without precomputed shift solvers (the
uncached route, ``shift_lus`` omitted) and banded cores built from a 1-D
complex shift buffer, against the JAX package on the same numpy inputs,
f64 on the CPU.

Ported from the JAX package's ``tests/test_compiled.py:35-58`` (a dense
pencil with 1-D complex Penzl shifts), ``:70-93`` (a Ros1 step against the
host solver) and ``:406-443`` (an odd complex buffer on the nonsymmetric
convection–diffusion pencil), and ``tests/test_pair_shifts.py:70-95`` (the
complex DIA cores against the pair encoding), at n ≤ 96.  Tolerances: the
JAX tests' own (ADI residual ≤ abstol, relative GALE residual < 1e-10,
``X`` against the SciPy oracle within 1e-9, the Ros1 step's ``K`` against
the host solver within 1e-8); port against JAX: ``X`` and ``K`` within
1e-10 with equal ADI counts (the same factorizations or Krylov solves,
rounding only).
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import differentialriccatiequations_jl_tpu as J  # noqa: E402
import differentialriccatiequations_jl_tpu_torch as T  # noqa: E402
from differentialriccatiequations_jl_tpu.ops import dia as jdia  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.lowrank import lr_to_dense, lr_zero  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models import compiled as tcomp  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models.lyapunov_dense import solve_gale_host  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.convert import config_from  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops.blocklinear import Backslash, Krylov  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops.dia import dia_pencil  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops.operators import DenseOp  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops.sparse import bell_pencil  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils.testmat import (  # noqa: E402
    conv_diff_surrogate, rail_surrogate_dense, random_pencil, random_rhs_lowrank)

jcomp = importlib.import_module("differentialriccatiequations_jl_tpu.models.compiled")
jshifts = importlib.import_module("differentialriccatiequations_jl_tpu.models.shifts")
jlr = importlib.import_module("differentialriccatiequations_jl_tpu.lowrank")
jops = importlib.import_module("differentialriccatiequations_jl_tpu.ops")

N = 48
JAX_TOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # Beside the JAX package's CPU thread pool, torch's own pool slows the
    # small products down; never raise the count again (MKL stalls).
    torch.set_num_threads(1)


def _t(x):
    return torch.as_tensor(np.asarray(x), dtype=torch.float64)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _rel_residual(E, A, G, S, X):
    """The GALE residual of the port's ``X`` relative to ``‖C‖`` (`lr_norm`)."""
    C = T.lowrank(_t(G), _t(S))
    prob = T.GALEProblem(E, A, C)
    return float(T.lr_norm(T.residual(prob, X)) / T.lr_norm(C))


def _cfg(maxiters, inner_alg=None):
    """`CompiledConfig(maxiters, 10, 3, inner_alg)` of the JAX package
    (``inner_alg`` one of its configs) and of the port (`config_from`)."""
    jcfg = jcomp.CompiledConfig(maxiters=maxiters, compression_interval=10, r_res=3,
                                inner_alg=inner_alg)
    return config_from(jcfg), jcfg


def _adi_both(E_t, A_t, E_j, A_j, G, S, shifts, cfgs, capacity=64, **lus):
    """`adi_compiled` from X = 0 on the residual ``G S Gᵀ`` in both packages
    (``cfgs`` from `_cfg`; the port's cores ``lus["t"]``, JAX's
    ``lus["j"]``, none by default); abstol 1e-11·‖C‖.  Returns ((X, iters,
    res) of the port, of JAX, abstol)."""
    n, q = G.shape
    abstol = 1e-11 * float(T.lr_norm(T.lowrank(_t(G), _t(S))))
    got = tcomp.adi_compiled(E_t, A_t, _t(G), _t(S), q,
                             lr_zero(n, capacity, torch.float64, "cpu"), shifts, abstol,
                             cfgs[0], lus.get("t"))
    ref = jcomp.adi_compiled(E_j, A_j, jnp.asarray(G), jnp.asarray(S), jnp.int32(q),
                             jlr.lr_zero(n, capacity, jnp.float64), jnp.asarray(shifts),
                             abstol, cfgs[1], lus.get("j"))
    return ((got[0], got[2], float(got[3])), (ref[0], int(ref[2]), float(ref[3])), abstol)


def _jdense(M):
    return jops.DenseOp(jnp.asarray(M))


def _agree(got, ref):
    (X, it, _), (Xj, itj, _) = got, ref
    assert it == itj
    assert _rel(lr_to_dense(X).numpy(), jlr.lr_to_dense(Xj)) <= JAX_TOL


@pytest.mark.parametrize("inner", [None, jops.Backslash()], ids=["default", "backslash"])
def test_adi_uncached_dense_matches_host_solver_and_jax(inner):
    """``tests/test_compiled.py:35-58``: a 1-D complex Penzl buffer on a
    dense random pencil (symmetric: its values are real), solved with a
    fresh LU per iteration; the default solver of a dense pencil is
    ``Backslash``, and ``CompiledConfig(inner_alg=Backslash())`` runs the
    same solves."""
    E, A = random_pencil(N, seed=3)
    G, S = random_rhs_lowrank(N, 3, seed=4)
    jprob = J.GALEProblem(E, A, J.lowrank(G, S))
    shifts = np.asarray(jshifts.init_shifts(jshifts.Cyclic(jshifts.Heuristic(8, 8, 8)),
                                            jprob).take_many(), np.complex128)
    assert np.iscomplexobj(shifts)  # a complex buffer (of real values here)
    cfgs = _cfg(60, inner)
    assert isinstance(cfgs[0].inner_alg, Backslash) == (inner is not None)
    got, ref, abstol = _adi_both(DenseOp(_t(E)), DenseOp(_t(A)), _jdense(E), _jdense(A),
                                 G, S, shifts, cfgs)
    X, _, res = got
    assert res <= abstol
    assert _rel_residual(_t(E), _t(A), G, S, X) < 1e-10
    X_ref = solve_gale_host(_t(E), _t(A), _t(G @ S @ G.T)).numpy()
    assert _rel(lr_to_dense(X).numpy(), X_ref) < 1e-9
    _agree(got, ref)


def _ros1_inputs(n=N, cap=64):
    E, A, B, C = (M.numpy() for M in rail_surrogate_dense(n, device="cpu"))
    L0 = np.linalg.solve(E, C.T)
    X0t = T.lr_with_capacity(T.lowrank(_t(L0), 0.01 * torch.eye(C.shape[0], dtype=torch.float64)),
                             cap)
    X0j = jlr.lr_with_capacity(jlr.lowrank(L0, 0.01 * np.eye(C.shape[0])), cap)
    return E, A, B, C, X0t, X0j


def test_ros1_step_uncached_matches_host_solver_and_jax():
    """``tests/test_compiled.py:70-93``: one Ros1 step with the 1-D complex
    Penzl buffer of ``(E, A)`` and no shift solvers, against the host
    solver's Ros1 step (1e-8) and the JAX package's uncached step."""
    E, A, B, C, X0t, X0j = _ros1_inputs()
    tau = 20.0
    Eo, Ao = DenseOp(_t(E)), DenseOp(_t(A))
    adi = T.ADI(shifts=T.Shifts.Cyclic(T.Shifts.Heuristic(10, 10, 10)), maxiters=60)
    ref = T.solve(T.GDREProblem(Eo, Ao, _t(B), _t(C), X0t, (4500.0, 4500.0 - tau)),
                  T.Ros1(inner_alg=adi), dt=-tau)
    K_ref = ref.K[-1].numpy()
    jgale = J.GALEProblem(_jdense(E), _jdense(A), J.lowrank(np.asarray(C).T))
    shifts = np.asarray(jshifts.init_shifts(jshifts.Cyclic(jshifts.Heuristic(10, 10, 10)),
                                            jgale).take_many(), np.complex128)
    cfg = tcomp.CompiledConfig(maxiters=60, compression_interval=10, r_res=24)
    X1, K1, it, res = tcomp.ros1_step_compiled(Eo, Ao, _t(B), _t(C), X0t, tau, shifts, 1e-12,
                                               cfg)
    assert _rel(K1.numpy(), K_ref) < 1e-8
    jcfg = jcomp.CompiledConfig(maxiters=60, compression_interval=10, r_res=24)
    Xj, Kj, itj, _ = jcomp.ros1_step_compiled(
        _jdense(E), _jdense(A), jnp.asarray(B),
        jnp.asarray(C), X0j, jnp.asarray(tau), jnp.asarray(shifts), jnp.asarray(1e-12), jcfg)
    assert it == int(itj)
    assert _rel(K1.numpy(), Kj) <= JAX_TOL
    assert _rel(lr_to_dense(X1).numpy(), jlr.lr_to_dense(Xj)) <= JAX_TOL


@pytest.fixture(scope="module")
def conv_diff():
    """``tests/test_compiled.py:406-443``'s n = 96 convection–diffusion GALE
    and its odd 9-slot complex Penzl buffer."""
    n = 96
    E, A, _, _ = conv_diff_surrogate(n)
    G, S = random_rhs_lowrank(n, 3, seed=7)
    sv = np.asarray(jshifts.heuristic_shifts_host(E, A, 9, 12, 12))
    assert np.iscomplexobj(sv) and np.any(np.abs(sv.imag) > 0)  # pairs exercised
    shifts = tcomp._shift_buffer(sv, torch.float64, 9)
    np.testing.assert_array_equal(shifts, np.asarray(jcomp._shift_buffer(sv, jnp.float64, 9)))
    tcomp.check_shift_pairing(shifts)
    return E, A, G, S, shifts


def test_adi_uncached_odd_complex_buffer_conv_diff(conv_diff):
    """The odd complex buffer's double steps consume whole conjugate pairs
    across the cyclic wrap, on dense operators, as in the JAX package."""
    E, A, G, S, shifts = conv_diff
    Ed, Ad = E.toarray(), A.toarray()
    got, ref, abstol = _adi_both(DenseOp(_t(Ed)), DenseOp(_t(Ad)), _jdense(Ed), _jdense(Ad),
                                 G, S, shifts, _cfg(80))
    assert got[2] <= abstol
    assert _rel_residual(_t(Ed), _t(Ad), G, S, got[0]) < 1e-10
    _agree(got, ref)


KRYLOV = jops.Krylov(method="bicgstab", tol=1e-13, maxiter=400, preconditioner="block_jacobi")


@pytest.mark.parametrize("fmt", ["dia", "bell"])
def test_adi_uncached_complex_buffer_on_sparse_operators(conv_diff, fmt):
    """The same buffer on banded (`shifted_dia`) and block-ELL (the shifted
    `BellOp`) operators: each iteration builds the complex shifted operator
    and solves by BiCGStab (``CompiledConfig(inner_alg=Krylov(...))``);
    the ADI reaches abstol with the dense route's count, and its ``X``
    within 1e-9 of it (Krylov to 1e-13).  The DIA run is held to the JAX
    package's uncached DIA route with the same ``inner_alg``."""
    E, A, G, S, shifts = conv_diff
    cfgs = _cfg(80, KRYLOV)
    assert isinstance(cfgs[0].inner_alg, Krylov)
    ops = (dia_pencil(E, A, device="cpu") if fmt == "dia"
           else bell_pencil(E, A, bs=16, device="cpu"))
    q = G.shape[1]
    abstol = 1e-11 * float(T.lr_norm(T.lowrank(_t(G), _t(S))))
    X, _, it, res = tcomp.adi_compiled(*ops, _t(G), _t(S), q,
                                       lr_zero(E.shape[0], 64, torch.float64, "cpu"), shifts,
                                       abstol, cfgs[0])
    Xd, _, itd, _ = tcomp.adi_compiled(
        DenseOp(_t(E.toarray())), DenseOp(_t(A.toarray())), _t(G), _t(S), q,
        lr_zero(E.shape[0], 64, torch.float64, "cpu"), shifts, abstol,
        _cfg(80)[0])
    assert float(res) <= abstol and it == itd
    assert _rel(lr_to_dense(X).numpy(), lr_to_dense(Xd).numpy()) < 1e-9
    if fmt == "dia":
        _, ref, _ = _adi_both(*ops, *jdia.dia_pencil(E, A), G, S, shifts, cfgs)
        _agree((X, it, float(res)), ref)


def test_complex_dia_cores_match_pair_encoding_and_jax(conv_diff):
    """``tests/test_pair_shifts.py:70-95`` at n = 96: banded cores built from
    the 1-D complex buffer (complex per-slot DIA data, BiCGStab) take as
    many ADI iterations as the pair encoding's stacked double step and
    reach the same iterate; the complex cores agree with the JAX package's
    CPU complex path."""
    E, A, G, S, _ = conv_diff
    sv = np.asarray(jshifts.heuristic_shifts_host(E, A, 8, 14, 14))
    E_t, A_t = dia_pencil(E, A, device="cpu")
    E_j, A_j = jdia.dia_pencil(E, A)
    cfgs = _cfg(80)
    shifts_c = tcomp._shift_buffer(sv, torch.float64, len(sv))
    assert np.iscomplexobj(shifts_c)
    lus_c = tcomp.build_dia_shift_ops(E_t, A_t, shifts_c)
    assert lus_c.data.is_complex() and lus_c.prec_inv.is_complex()
    assert lus_c.cfg.method == "bicgstab"
    jlus_c = jcomp.build_dia_shift_ops(E_j, A_j, jnp.asarray(shifts_c))
    np.testing.assert_allclose(lus_c.data.numpy(), np.asarray(jlus_c.data), rtol=0, atol=0)
    got_c, ref_c, abstol = _adi_both(E_t, A_t, E_j, A_j, G, S, shifts_c, cfgs,
                                     t=lus_c, j=jlus_c)
    _agree(got_c, ref_c)

    shifts_p = tcomp._shift_buffer(sv, torch.float64, len(sv), pair_encode=True)
    lus_p = tcomp.build_dia_shift_ops(E_t, A_t, shifts_p)
    assert lus_p.et_data is not None
    Xp, _, it_p, res_p = tcomp.adi_compiled(E_t, A_t, _t(G), _t(S), G.shape[1],
                                            lr_zero(E.shape[0], 64, torch.float64, "cpu"),
                                            shifts_p, abstol, cfgs[0], lus_p)
    Xc, it_c, _ = got_c
    assert float(res_p) <= abstol and it_p == it_c
    assert _rel_residual(E_t, A_t, G, S, Xc) < 1e-10
    assert _rel(lr_to_dense(Xp).numpy(), lr_to_dense(Xc).numpy()) < 1e-8
    X_ref = solve_gale_host(_t(E.toarray()), _t(A.toarray()), _t(G @ S @ G.T)).numpy()
    assert _rel(lr_to_dense(Xc).numpy(), X_ref) < 1e-8


def test_uncached_route_keeps_the_pair_raise(conv_diff):
    """A pair-encoded conjugate pair needs pair tables, which only banded
    cores have: without cores it raises, as without them before; a complex
    buffer on block-ELL cores raises and names the uncached route."""
    E, A, G, S, shifts = conv_diff
    cfg = tcomp.CompiledConfig(maxiters=4, compression_interval=10, r_res=3)
    W0, T0 = _t(G), _t(S)
    X0 = lr_zero(E.shape[0], 16, torch.float64, "cpu")
    pair = tcomp.pair_encode_shifts(shifts)
    ops = dia_pencil(E, A, device="cpu")
    with pytest.raises(ValueError, match="pair tables"):
        tcomp.adi_compiled(*ops, W0, T0, 3, X0, pair, 0.0, cfg)
    bE, bA = bell_pencil(E, A, bs=16, device="cpu")
    with pytest.raises(ValueError, match="real shifts only"):
        tcomp.build_sparse_shift_ops(bE, bA, shifts)
    lus = tcomp.build_sparse_shift_ops(bE, bA, np.asarray([-1.0]))
    with pytest.raises(ValueError, match="shift_lus=None"):
        tcomp.adi_compiled(bE, bA, W0, T0, 3, X0, shifts, 0.0, cfg, lus)

"""The slice as a whole: the port's Penzl shifts, Ros2 step and Ros1/Ros2
sweeps on a block-ELL pencil against the JAX package's
``models/compiled.py`` on the same numpy inputs, f64 on the CPU.

Each package builds its own operators and shift tables from the same scipy
matrices.  Tolerance: 1e-9 relative for ``L D Lᵀ`` and ``K`` at every stop
(the Krylov tolerance 10·eps amplified by the ADI), equal ADI iteration
counts.  The comparisons use n = 96 with bs = 16 (n % bs == 0): at
n % bs ≠ 0 the JAX block-ELL preconditioner is singular (see the last
test).
"""

import importlib

import numpy as np
import pytest
import scipy.linalg as sla
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from differentialriccatiequations_jl_tpu.ops import dia as jdia  # noqa: E402
from differentialriccatiequations_jl_tpu.ops import sparse as jsparse  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.convert import sparse_shift_ops_from_numpy  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.kernels import bell_spmm as k2  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.lowrank import (  # noqa: E402
    LowRank, lowrank, lr_with_capacity)
from differentialriccatiequations_jl_tpu_torch.models import compiled as tcomp  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models import shifts as tshifts  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models.problems import GDREProblem  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops import dia as tdia  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops import sparse as tsparse  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops.operators import lin_comb, scale_op  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate  # noqa: E402

jcomp = importlib.import_module("differentialriccatiequations_jl_tpu.models.compiled")
jshifts = importlib.import_module("differentialriccatiequations_jl_tpu.models.shifts")
jprob = importlib.import_module("differentialriccatiequations_jl_tpu.models.problems")
jlr = importlib.import_module("differentialriccatiequations_jl_tpu.lowrank")
jopers = importlib.import_module("differentialriccatiequations_jl_tpu.ops.operators")

RTOL = 1e-9
N, BS, TAU, NSTEPS, CAP = 96, 16, 10.0, 3, 64
TSPAN = (4500.0, 4500.0 - NSTEPS * TAU)
CFG = tcomp.CompiledConfig(maxiters=60, compression_interval=10, r_res=16)
CFG_J = jcomp.CompiledConfig(maxiters=CFG.maxiters,
                             compression_interval=CFG.compression_interval,
                             r_res=CFG.r_res)
GAMMA = tcomp._ROS2_GAMMA


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _real_shifts(E, F, nshifts):
    return np.asarray([s.real for s in tshifts.heuristic_shifts_host(E, F, nshifts, 20, 20)])


@pytest.fixture(scope="module")
def rail():
    E, A, B, C = rail_surrogate(N)
    L0 = spla.splu(E.tocsc()).solve(C.T.copy())
    return E, A, B, C, L0


def _x0_port(L0, q):
    return lr_with_capacity(lowrank(torch.as_tensor(L0), 0.01 * torch.eye(q, dtype=torch.float64)), CAP)


def _x0_jax(L0, q):
    return jlr.lr_with_capacity(jlr.lowrank(jnp.asarray(L0), 0.01 * jnp.eye(q)), CAP)


def _check_stop(X, K, Xj, Kj):
    assert X.k == int(Xj.k)
    assert _rel(X.to_dense().numpy(), jlr.lr_to_dense(Xj)) <= RTOL
    assert _rel(K.numpy(), Kj) <= RTOL


def test_heuristic_shifts_match_jax(rail):
    E, A, B, _, _ = rail
    F = sp.csr_matrix(GAMMA * TAU * A - 0.5 * E)
    K = np.random.default_rng(5).standard_normal((B.shape[1], N)) * 1e-3
    t_cache, j_cache = {}, {}
    for kw in ({}, {"B": B, "K": K}):
        got = np.asarray(tshifts.heuristic_shifts_host(E, F, 8, 20, 20, **kw))
        ref = np.asarray(jshifts.heuristic_shifts_host(E, F, 8, 20, 20, **kw))
        np.testing.assert_allclose(got, ref, rtol=1e-10)
        # cached LUs, then a warm-started half-depth rebuild
        for warm, depth in ((False, 20), (True, 10)):
            got = np.asarray(tshifts.heuristic_shifts_host(
                E, F, 8, depth, depth, lu_cache=t_cache, warm_start=warm, **kw))
            ref = np.asarray(jshifts.heuristic_shifts_host(
                E, F, 8, depth, depth, lu_cache=j_cache, warm_start=warm, **kw))
            np.testing.assert_allclose(got, ref, rtol=1e-10)
    assert np.all(got.real < 0)


@pytest.fixture(scope="module")
def ros2_sweeps(rail):
    """Both packages' Ros2 sweeps on the block-ELL pencil, with states."""
    E, A, B, C, L0 = rail
    shifts = _real_shifts(E, sp.csr_matrix(GAMMA * TAU * A - 0.5 * E), 8)
    tE, tA = tsparse.bell_pencil(E, A, bs=BS, device="cpu")
    jE, jA = jsparse.bell_pencil(E, A, bs=BS)
    tprob = GDREProblem(tE, tA, B, C, _x0_port(L0, C.shape[0]), TSPAN)
    jp = jprob.GDREProblem(jE, jA, B, C, _x0_jax(L0, C.shape[0]), TSPAN)
    steps = []
    tsol = tcomp.solve_gdre_ros2_compiled(
        tprob, dt=-TAU, shifts=shifts, cfg=CFG, capacity=CAP, save_state=True,
        observer=lambda i, X, K, iters, res: steps.append((iters, res)))
    jsol = jcomp.solve_gdre_ros2_compiled(jp, dt=-TAU, shifts=jnp.asarray(shifts),
                                          cfg=CFG_J, capacity=CAP, save_state=True)
    return shifts, (tE, tA), (jE, jA), tsol, jsol, steps


def test_ros2_sweep_block_ell_matches_jax(ros2_sweeps):
    _, _, _, tsol, jsol, steps = ros2_sweeps
    assert len(tsol.X) == len(jsol.X) == NSTEPS + 1
    np.testing.assert_array_equal(tsol.t, jsol.t)
    for X, K, Xj, Kj in zip(tsol.X, tsol.K, jsol.X, jsol.K):
        _check_stop(X, K, Xj, Kj)
    assert tsol.adi_iters == jsol.adi_iters
    assert steps[0] == (0, None) and len(steps) == NSTEPS + 1
    assert sum(it for it, _ in steps) == tsol.adi_iters
    np.testing.assert_allclose(tsol.adi_res_max, jsol.adi_res_max, rtol=1e-6)


def test_ros2_step_block_ell_matches_jax(rail, ros2_sweeps):
    """One step from the sweep's start, per-step iterations and residual."""
    _, _, B, C, _ = rail
    shifts, (tE, tA), (jE, jA), tsol, jsol, steps = ros2_sweeps
    F_t = lin_comb(scale_op(tA, GAMMA * TAU), -0.5, tE)
    F_j = jopers.lin_comb(jopers.scale_op(jA, GAMMA * TAU), -0.5, jE)
    t_ops = tcomp.build_step_shift_solvers(tE, F_t, shifts)
    j_ops = jcomp.build_step_shift_solvers(jE, F_j, jnp.asarray(shifts))
    assert isinstance(t_ops, tcomp.SparseShiftOps) and t_ops.cfg.method == "cg"
    np.testing.assert_allclose(t_ops.prec_inv.numpy(), np.asarray(j_ops.prec_inv),
                               rtol=1e-10, atol=1e-14)
    abstol = tcomp._abstol_default(GDREProblem(tE, tA, B, C, None, TSPAN))
    before = k2.launches
    X, K, iters, res = tcomp.ros2_step_compiled(
        tE, tA, torch.as_tensor(B), torch.as_tensor(C), tsol.X[0], TAU, shifts,
        abstol, CFG, t_ops)
    assert k2.launches == before
    # argument types as the sweep passes them, so the compiled step is reused
    Xj, Kj, it_j, res_j = jcomp.ros2_step_compiled(
        jE, jA, jnp.asarray(B), jnp.asarray(C), jsol.X[0], jnp.asarray(TAU, jnp.float64),
        jnp.asarray(shifts), jnp.asarray(abstol, jnp.float64), CFG_J, j_ops)
    assert iters == int(it_j) == steps[1][0]
    _check_stop(X, K, Xj, Kj)
    np.testing.assert_allclose(float(res), float(res_j), rtol=1e-6)
    assert float(res) == float(steps[1][1])
    # the same step on the JAX package's shift tables
    shared = sparse_shift_ops_from_numpy(
        j_ops.cols, j_ops.data, j_ops.diag_, j_ops.prec_inv, j_ops.n, j_ops.bs, j_ops.cfg,
        device="cpu")
    X2, K2, iters2, _ = tcomp.ros2_step_compiled(
        tE, tA, torch.as_tensor(B), torch.as_tensor(C), tsol.X[0], TAU, shifts,
        abstol, CFG, shared)
    assert iters2 == iters
    _check_stop(X2, K2, Xj, Kj)


def test_ros2_step_dia_matches_jax(rail):
    E, A, B, C, L0 = rail
    shifts = _real_shifts(E, sp.csr_matrix(GAMMA * TAU * A - 0.5 * E), 8)
    tE, tA = tdia.dia_pencil(E, A, device="cpu")
    jE, jA = jdia.dia_pencil(E, A)
    t_ops = tcomp.build_step_shift_solvers(
        tE, lin_comb(scale_op(tA, GAMMA * TAU), -0.5, tE), shifts)
    j_ops = jcomp.build_step_shift_solvers(
        jE, jopers.lin_comb(jopers.scale_op(jA, GAMMA * TAU), -0.5, jE), jnp.asarray(shifts))
    X, K, iters, res = tcomp.ros2_step_compiled(
        tE, tA, torch.as_tensor(B), torch.as_tensor(C), _x0_port(L0, C.shape[0]), TAU,
        shifts, 1e-12, CFG, t_ops)
    Xj, Kj, it_j, res_j = jcomp.ros2_step_compiled(
        jE, jA, jnp.asarray(B), jnp.asarray(C), _x0_jax(L0, C.shape[0]), jnp.asarray(TAU),
        jnp.asarray(shifts), jnp.asarray(1e-12), CFG_J, j_ops)
    assert iters == int(it_j)
    _check_stop(X, K, Xj, Kj)


def test_ros1_sweep_block_ell_matches_jax(rail):
    E, A, B, C, L0 = rail
    shifts = _real_shifts(E, sp.csr_matrix(A - E / (2.0 * TAU)), 8)
    tE, tA = tsparse.bell_pencil(E, A, bs=BS, device="cpu")
    jE, jA = jsparse.bell_pencil(E, A, bs=BS)
    tsol = tcomp.solve_gdre_ros1_compiled(
        GDREProblem(tE, tA, B, C, _x0_port(L0, C.shape[0]), TSPAN),
        dt=-TAU, shifts=shifts, cfg=CFG, capacity=CAP, save_state=True, fused=True)
    jsol = jcomp.solve_gdre_ros1_compiled(
        jprob.GDREProblem(jE, jA, B, C, _x0_jax(L0, C.shape[0]), TSPAN),
        dt=-TAU, shifts=jnp.asarray(shifts), cfg=CFG_J, capacity=CAP, save_state=True)
    for X, K, Xj, Kj in zip(tsol.X, tsol.K, jsol.X, jsol.K):
        _check_stop(X, K, Xj, Kj)
    assert tsol.adi_iters == jsol.adi_iters


def test_adi_sparse_shift_ops_where_bs_does_not_divide_n():
    """n = 100, bs = 16: the port's identity-padded block-Jacobi keeps the
    ADI finite and it converges to the dense solution of
    ``AᵀXE + EᵀXA = −CᵀC``; the JAX package's preconditioner is ``inf``
    there, so its ADI returns NaN."""
    n = 100
    E, A, _, C = rail_surrogate(n)
    shifts = _real_shifts(E, A, 8)
    tE, tA = tsparse.bell_pencil(E, A, bs=16, device="cpu")
    ops = tcomp.build_sparse_shift_ops(tE, tA, shifts)
    assert torch.isfinite(ops.prec_inv).all()
    jE, jA = jsparse.bell_pencil(E, A, bs=16)
    assert not np.isfinite(np.asarray(jcomp.build_sparse_shift_ops(jE, jA, shifts).prec_inv)).all()

    q, cap = C.shape[0], 96  # the solution's numerical rank is 62
    X0 = LowRank(L=torch.zeros((n, cap), dtype=torch.float64),
                 D=torch.zeros((cap, cap), dtype=torch.float64), k=0)
    cfg = tcomp.CompiledConfig(maxiters=80, compression_interval=10, r_res=q)
    X, _, iters, res = tcomp.adi_compiled(
        tE, tA, torch.as_tensor(C.T.copy()), torch.eye(q, dtype=torch.float64), q,
        X0, shifts, 1e-12 * np.linalg.norm(C @ C.T), cfg, ops)
    assert torch.isfinite(X.L).all() and iters < cfg.maxiters
    Ed, Ad = E.toarray(), A.toarray()
    # Y = EᵀXE solves (E⁻¹A)ᵀY + Y(E⁻¹A) = −CᵀC
    Ah = np.linalg.solve(Ed, Ad)
    Y = sla.solve_continuous_lyapunov(Ah.T, -C.T @ C)
    X_ref = np.linalg.solve(Ed.T, np.linalg.solve(Ed.T, Y).T).T
    assert _rel(X.to_dense().numpy(), X_ref) <= 1e-9

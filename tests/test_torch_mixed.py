"""The mixed-precision route against the JAX package on the same numpy
inputs, on the CPU: `RefinedKrylovSolver` (``Krylov(solve_dtype="float32",
refine_iters=k)``) on dense and DIA operators, real and complex; the
compiled shifted cores with an f32 Krylov core (`DiaShiftOps.core_solver`
and `pair_solver`, the f32 block inverses of `build_dia_shift_ops`); the
compiled GALE at n = 371 with the f32 core (``bench.py``'s
``substage_gale_mixed`` configuration); the compiled Newton with
``inner_solve_dtype="float32"`` at n = 128.

The f32 cores round differently in each package (other summation orders
in f32).  Tolerances, from the gaps measured here:

* A bare f32 core (``refine_iters=0``): 2e-6 relative (measured 1.5e-7,
  f32 rounding; × 10, rounded up).  After 2 or 3 refinement sweeps both
  packages reach the f64 solution: 1e-14 (measured ≤ 3.3e-16; 10× would
  sit at a few ulps, where summation order alone moves the result).
* The f32 block inverses: 1e-6 relative (measured 9.8e-8).  Solves
  through the shifted cores with 3 refinements: 1e-14 (measured
  ≤ 1.3e-16).
* The compiled GALE: equal ADI iterations; the true relative residual
  within 1e-4 relative of the JAX package's (measured 1.0e-5 with the f32
  core and 6.1e-6 with the f64 core: the residual, 2.5e-11 of ‖C‖, is a
  Gram-form norm at its rounding floor).
* The compiled Newton: equal Newton steps, ADI iterations and shift
  rebuilds, ``converged``; residual history within 1e-3 relative
  (measured 6.8e-5, at the last step, 1.1e-11 of the first) and
  ``X`` within 2e-12 (measured 1.3e-13).
"""

import dataclasses
import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import differentialriccatiequations_jl_tpu as J  # noqa: E402
import differentialriccatiequations_jl_tpu_torch as T  # noqa: E402
from differentialriccatiequations_jl_tpu.ops import blocklinear as jbl  # noqa: E402
from differentialriccatiequations_jl_tpu.ops import dia as jdia  # noqa: E402
from differentialriccatiequations_jl_tpu.ops import operators as jopers  # noqa: E402
from differentialriccatiequations_jl_tpu_torch import convert  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.entry import SHIFTS, TAU  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.lowrank import _mask_cols  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models import compiled as tcomp  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models.residuals import (  # noqa: E402
    residual_gale_lowrank)
from differentialriccatiequations_jl_tpu_torch.models.shifts import heuristic_shifts_host  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops import blocklinear as tbl  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops import dia as tdia  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops import operators as topers  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate  # noqa: E402

jcomp = importlib.import_module("differentialriccatiequations_jl_tpu.models.compiled")
jlr = importlib.import_module("differentialriccatiequations_jl_tpu.lowrank")
jres = importlib.import_module("differentialriccatiequations_jl_tpu.models.residuals")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _dia(op):
    return dict(data=np.asarray(op.data), data_t=np.asarray(op.data_t), offsets=op.offsets,
                n=op.n, nnz=op.nnz_, symmetric=op.symmetric)


@pytest.fixture(scope="module")
def operators():
    rng = np.random.default_rng(0)
    n = 30
    M = rng.standard_normal((n, n)) + n * np.eye(n)
    Mc = M + 0.3j * rng.standard_normal((n, n))
    E, A, _, _ = rail_surrogate(200)
    jE, jA = jdia.dia_pencil(E, A)
    out = {
        "dense": (J.DenseOp(jnp.asarray(M)), T.DenseOp(torch.as_tensor(M)),
                  rng.standard_normal((n, 3)), {}),
        "dense-complex": (J.DenseOp(jnp.asarray(Mc)), T.DenseOp(torch.as_tensor(Mc)),
                          rng.standard_normal((n, 3)) + 1j * rng.standard_normal((n, 3)), {}),
    }
    for name, mu, kw in (("dia", -0.7, dict(method="cg", negate=True)),
                         ("dia-complex", -0.6 + 0.3j, {})):
        F = jdia.shifted_dia(jE, jA, mu)
        out[name] = (F, convert.dia_op_from_numpy(**_dia(F), device="cpu"),
                     rng.standard_normal((200, 4)),
                     dict(preconditioner="block_jacobi", **kw))
    return out


@pytest.mark.parametrize("iters", [0, 2, 3])
@pytest.mark.parametrize("kind", ["dense", "dense-complex", "dia", "dia-complex"])
def test_refined_krylov_matches_jax(operators, kind, iters):
    jop, top, B, kw = operators[kind]
    cfg = dict(solve_dtype="float32", refine_iters=iters, tol=1e-12, **kw)
    xj = jbl.prepare(jop, J.Krylov(**cfg)).solve(jnp.asarray(B))
    solver = tbl.prepare(top, T.Krylov(**cfg))
    assert isinstance(solver, tbl.RefinedKrylovSolver) and solver.iters == iters
    lo = torch.complex64 if top.dtype.is_complex else torch.float32
    assert solver.inner.op.dtype == lo and solver.op_hi.dtype == top.dtype
    xt = solver.solve(torch.as_tensor(B))
    assert xt.dtype == top.dtype
    assert _rel(xt, xj) <= (2e-6 if iters == 0 else 1e-14)


def test_refinement_residual_runs_in_full_precision(operators, monkeypatch):
    """The refinement's residual ``B − A_hi·x`` is an f64 product on f64
    data; the core's products are f32 on f32 data (no operand of the other
    dtype reaches a kernel's wrapper)."""
    from differentialriccatiequations_jl_tpu_torch.kernels import dia_spmm as k1

    _, top, B, kw = operators["dia"]
    seen = []
    for name in ("dia_mm", "dia_mm_t"):
        real = getattr(k1, name)

        def spy(data, offsets, X, *a, _real=real, _name=name, **k):
            seen.append((_name, data.dtype, X.dtype))
            return _real(data, offsets, X, *a, **k)

        monkeypatch.setattr(k1, name, spy)
    tbl.prepare(top, T.Krylov(solve_dtype="float32", refine_iters=2, **kw)).solve(
        torch.as_tensor(B))
    assert {(d, x) for _, d, x in seen} == {(torch.float64, torch.float64),
                                          (torch.float32, torch.float32)}
    assert {n for n, d, _ in seen if d == torch.float64} == {"dia_mm"}  # A_hi·x, twice
    assert sum(d == torch.float64 for _, d, _ in seen) == 2


@pytest.fixture(scope="module")
def shift_ops():
    """The pair-encoded shift buffer of the n = 256 Ros1 step under an f32
    core: the JAX package's `DiaShiftOps`, carried into the port, and the
    port's own."""
    E, A, _, _ = rail_surrogate(256)
    jE, jA = jdia.dia_pencil(E, A)
    tE, tA = tdia.dia_pencil(E, A, device="cpu")
    jF0 = jopers.lin_comb(jA, -1.0 / (2.0 * TAU), jE)
    tF0 = topers.lin_comb(tA, -1.0 / (2.0 * TAU), tE)
    buf = tcomp.pair_encode_shifts(SHIFTS)
    kj = dataclasses.replace(jcomp.default_dia_krylov(jnp.float64, jnp.complex64),
                             solve_dtype="float32", refine_iters=3)
    kt = dataclasses.replace(tcomp.default_dia_krylov(torch.float64, True),
                             solve_dtype="float32", refine_iters=3)
    j = jcomp.build_dia_shift_ops(jE, jF0, jnp.asarray(buf), krylov_cfg=kj)
    opt = {k: np.asarray(getattr(j, k)) for k in
           ("et_data", "et_data_t", "pair_prec_re", "pair_prec_im", "pair_index")}
    carried = convert.dia_shift_ops_from_numpy(
        np.asarray(j.data), np.asarray(j.data_t), np.asarray(j.prec_inv), j.offsets, j.n,
        j.nnz_, j.cfg, pair_cfg=j.pair_cfg, **opt, device="cpu")
    own = tcomp.build_dia_shift_ops(tE, tF0, buf, krylov_cfg=kt)
    return j, carried, own, buf


def test_f32_block_inverses_match_jax(shift_ops):
    j, _, own, _ = shift_ops
    assert own.data.dtype == torch.float64
    for name in ("prec_inv", "pair_prec_re", "pair_prec_im"):
        got = getattr(own, name)
        assert got.dtype == torch.float32, name
        assert _rel(got, getattr(j, name)) <= 1e-6, name


def test_f32_core_and_pair_solvers_match_jax(shift_ops):
    j, carried, own, buf = shift_ops
    W = np.random.default_rng(1).standard_normal((256, 6))
    Ws = np.concatenate([W, np.zeros_like(W)], axis=1)
    for idx, (_, b) in enumerate(buf):
        if b == 0:
            xj = j.core_solver(idx).solve(jnp.asarray(W))
            solvers = [s.core_solver(idx) for s in (carried, own)]
            rhs = W
        else:
            xj = j.pair_solver(idx, b).solve(jnp.asarray(Ws))
            solvers = [s.pair_solver(idx, b) for s in (carried, own)]
            rhs = Ws
        for s in solvers:
            assert isinstance(s, tbl.RefinedKrylovSolver) and s.iters == 3
            assert s.inner.op.dtype == torch.float32
            assert _rel(s.solve(torch.as_tensor(rhs)), xj) <= 1e-14


@pytest.mark.parametrize("solve_dtype", [None, "float32"])
def test_compiled_gale_mixed_matches_jax(solve_dtype):
    """``substage_gale_mixed`` at n = 371: 16 Penzl shifts, the f32 core
    with 3 refinements (and the f64 core beside it), ``CompiledConfig(120,
    10, 32)``, capacity 160, abstol 1e-10·‖C‖."""
    n = 371
    E, A, _, C = rail_surrogate(n)
    shifts = np.asarray([s.real for s in heuristic_shifts_host(E, A, 16, 20, 20)])
    jE, jA = jdia.dia_pencil(E, A, dtype=np.float64)
    kj = dataclasses.replace(jcomp.default_dia_krylov(jnp.float64, jnp.float64),
                             solve_dtype=solve_dtype, refine_iters=3)
    lus = jcomp.build_dia_shift_ops(jE, jA, jnp.asarray(shifts), krylov_cfg=kj)
    Cj = jlr.lowrank(jnp.asarray(C.T))
    norm_c = float(jlr.lr_norm(Cj))
    cfg_j = jcomp.CompiledConfig(maxiters=120, compression_interval=10, r_res=32)
    X0 = jlr.lr_zero(n, 160, jnp.float64)
    r0 = jres.residual_gale_lowrank(jE, jA, Cj, X0, r_out=32)
    Xj, _, it_j, _ = jcomp.adi_compiled(jE, jA, jcomp._masked_cols(r0.L, r0.k), r0.D, r0.k,
                                        X0, jnp.asarray(shifts), jnp.asarray(1e-10 * norm_c),
                                        cfg_j, lus)
    res_j = float(jlr.lr_norm(jres.residual_gale_lowrank(jE, jA, Cj, Xj, r_out=64))) / norm_c

    tE, tA = tdia.dia_pencil(E, A, device="cpu")
    kt = dataclasses.replace(tcomp.default_dia_krylov(torch.float64, False),
                             solve_dtype=solve_dtype, refine_iters=3)
    tl = tcomp.build_dia_shift_ops(tE, tA, shifts, krylov_cfg=kt)
    Ct = T.lowrank(torch.as_tensor(C.T.copy()))
    X0 = T.lr_zero(n, 160, torch.float64, device="cpu")
    r0 = residual_gale_lowrank(tE, tA, Ct, X0, r_out=32)
    Xt, _, it_t, _ = tcomp.adi_compiled(tE, tA, _mask_cols(r0.L, r0.k), r0.D, r0.k, X0, shifts,
                                        1e-10 * norm_c, tcomp.CompiledConfig(120, 10, 32), tl)
    res_t = float(T.lr_norm(residual_gale_lowrank(tE, tA, Ct, Xt, r_out=64))) / norm_c
    assert it_t == int(it_j) == 15
    assert res_t <= 1e-10 and abs(res_t - res_j) <= 1e-4 * res_j


def test_newton_f32_inner_solves_match_jax():
    """The compiled Newton with ``inner_solve_dtype="float32"`` on the
    n = 128 Rail GARE (``G = lowrank(1000·B)``, ``PerStepHeuristic(10, 12,
    12)``, capacity 128, reltol 1e-10), step for step."""
    n = 128
    E, A, B, C = rail_surrogate(n)
    jE, jA = jdia.dia_pencil(E, A)
    jp = J.GAREProblem(jE, jA, jlr.lowrank(jnp.asarray(1000.0 * B)),
                       jlr.lowrank(jnp.asarray(C.T)))

    def lr(X):
        return np.asarray(X.L), np.asarray(X.D), int(X.k)

    tp = convert.gare_problem_from_numpy(_dia(jE), _dia(jA), lr(jp.G), lr(jp.Q), device="cpu")
    kw = dict(capacity=128, reltol=1e-10, inner_solve_dtype="float32")
    Xj, ij = jcomp.solve_gare_newton_compiled(
        jp, shifts=jcomp.PerStepHeuristic(10, 12, 12),
        cfg=jcomp.CompiledConfig(maxiters=120, r_res=32), **kw)
    Xt, it = tcomp.solve_gare_newton_compiled(
        tp, shifts=tcomp.PerStepHeuristic(10, 12, 12),
        cfg=tcomp.CompiledConfig(maxiters=120, r_res=32), **kw)
    for key in ("newton_steps", "shift_rebuilds", "converged", "adi_iters"):
        assert ij[key] == it[key], key
    assert it["converged"]
    hj, ht = np.asarray(ij["residuals"]), np.asarray(it["residuals"])
    assert np.all(np.abs(ht - hj) <= 1e-3 * hj)
    assert _rel(T.lr_to_dense(Xt), np.asarray(jlr.lr_to_dense(Xj))) <= 2e-12

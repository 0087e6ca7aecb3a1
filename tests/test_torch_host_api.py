"""The host API's routing and its block linear layer: `prepare` /
`solve_blocklinear` (dense LU, SMW, Krylov with the diagonal or the block
Jacobi preconditioner, real and complex shifted operators) against the JAX
package's on the same numpy inputs, f64 on the CPU; `solve` dispatches a
low-rank GDRE with `Parareal` to the parareal solver, the GMRES and
mixed-precision branches run; the compiled
paths' Krylov configuration is unchanged by the new `Krylov` fields.

Tolerances: solutions within 1e-10 relative (the Krylov tolerance 1e-12
amplified by the operators' conditioning; dense LU to 1e-13).
"""

import dataclasses

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import differentialriccatiequations_jl_tpu as J  # noqa: E402
import differentialriccatiequations_jl_tpu_torch as T  # noqa: E402
from differentialriccatiequations_jl_tpu.models import compiled as jcomp  # noqa: E402
from differentialriccatiequations_jl_tpu.ops import blocklinear as jbl  # noqa: E402
from differentialriccatiequations_jl_tpu.ops import dia as jdia  # noqa: E402
from differentialriccatiequations_jl_tpu.ops import shifted as jsh  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.convert import (  # noqa: E402
    config_from, dia_op_from_numpy, krylov_from)
from differentialriccatiequations_jl_tpu_torch.models import compiled as tcomp  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops import blocklinear as tbl  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops.dia import shifted_dia as tshifted_dia  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops import shifted as tsh  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops.operators import (  # noqa: E402
    lr_update, operator_nnz, restrict)
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate  # noqa: E402

N = 300


def _pencils():
    E, A, B, _ = rail_surrogate(N)
    jE, jA = jdia.dia_pencil(E, A)

    def leaves(op):
        return dict(data=np.asarray(op.data), data_t=np.asarray(op.data_t),
                    offsets=op.offsets, n=op.n, nnz=op.nnz_, symmetric=op.symmetric)

    return ((jE, jA), (dia_op_from_numpy(**leaves(jE), device="cpu"),
                       dia_op_from_numpy(**leaves(jA), device="cpu")), B)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


KRYLOVS = [J.Krylov(), J.Krylov(preconditioner="block_jacobi"),
           J.Krylov(method="cg", negate=True)]


@pytest.mark.parametrize("mu", [-0.7, -0.6 + 0.3j], ids=["real", "complex"])
@pytest.mark.parametrize("kry", KRYLOVS, ids=["jacobi", "block-jacobi", "cg"])
def test_shifted_krylov_and_smw_match_jax(kry, mu):
    """``(Aᵀ + μEᵀ − (BK)ᵀ)V = W`` through SMW around a Krylov core, both
    packages, real and complex μ (complex BiCGStab/CG iterates)."""
    (jE, jA), (tE, tA), B = _pencils()
    rng = np.random.default_rng(5)
    K = 0.1 * rng.standard_normal((B.shape[1], N))
    W = rng.standard_normal((N, 4))
    Wc = W.astype(complex) if isinstance(mu, complex) else W
    jF = J.lr_update(jA, -1.0, B, K)
    tF = lr_update(tA, -1.0, torch.as_tensor(B), torch.as_tensor(K))
    alg = J.ShermanMorrisonWoodbury(outer=kry)
    Vj = jsh.prepare_shifted(jE, jF, mu, alg).solve(Wc)
    Vt = tsh.prepare_shifted(tE, tF, mu, config_from(alg)).solve(torch.as_tensor(Wc))
    assert _rel(Vt, Vj) < 1e-10
    if kry.method == "cg" and isinstance(mu, complex):
        return  # CG on a complex-symmetric (not Hermitian) operator: the
        #         same iterates in both packages, but no solution
    M = (tA.to_dense().numpy() - B @ K).T + mu * tE.to_dense().numpy().T
    assert _rel(M @ Vt.numpy(), Wc) < 1e-9


def test_dense_backslash_and_blocklinear():
    rng = np.random.default_rng(6)
    M = rng.standard_normal((40, 40)) + 40 * np.eye(40)
    b = rng.standard_normal((40, 3))
    xj = np.asarray(jbl.solve_blocklinear(M, b))
    xt = T.solve_blocklinear(torch.as_tensor(M), torch.as_tensor(b))
    assert _rel(xt, xj) < 1e-13
    v = T.solve_blocklinear(torch.as_tensor(M), torch.as_tensor(b[:, 0]), T.Backslash())
    assert v.shape == (40,) and _rel(v, xj[:, 0]) < 1e-13
    p = T.BlockLinearProblem(torch.as_tensor(M), torch.as_tensor(b))
    assert p.B.shape == (40, 3)


def test_restrict_and_nnz_match_jax():
    (jE, jA), (tE, tA), B = _pencils()
    rng = np.random.default_rng(7)
    Q = np.linalg.qr(rng.standard_normal((N, 6)))[0]
    K = rng.standard_normal((B.shape[1], N))
    jF = J.lr_update(jA, -1.0, B, K)
    tF = lr_update(tA, -1.0, torch.as_tensor(B), torch.as_tensor(K))
    from differentialriccatiequations_jl_tpu.ops.operators import operator_nnz as jnnz
    from differentialriccatiequations_jl_tpu.ops.operators import restrict as jrestrict

    assert _rel(restrict(tF, torch.as_tensor(Q)), jrestrict(jF, Q)) < 1e-13
    assert operator_nnz(tF) == jnnz(jF)


def test_krylov_fields_and_compiled_config_unchanged():
    """`Krylov` carries the JAX package's fields and defaults; the compiled
    paths still build their block-Jacobi CG/BiCGStab solvers (the new
    ``preconditioner="jacobi"`` default does not reach them)."""
    assert ({f.name: f.default for f in dataclasses.fields(T.Krylov)}
            == {f.name: f.default for f in dataclasses.fields(J.Krylov)})
    for dt, cplx in ((torch.float64, False), (torch.float64, True)):
        cfg = tcomp.default_dia_krylov(dt, cplx)
        jcfg = jcomp.default_dia_krylov(np.float64, np.complex128 if cplx else np.float64)
        assert cfg == krylov_from(jcfg)
        assert (cfg.method, cfg.maxiter, cfg.negate) == (
            ("bicgstab", 400, False) if cplx else ("cg", 400, True))
    _, (tE, tA), _ = _pencils()
    ops = tcomp.build_dia_shift_ops(tE, tA, np.asarray([-0.5, -1.0]))
    assert ops.core_solver(0).prec.dim() == 3  # block-Jacobi inverses


def test_jacobi_preconditioner_is_prepared_once():
    """`prepare` stores the diagonal's reciprocal, padded with ones to the
    operator's storage length, so that an application is one multiply in
    either layout; the solve still matches the JAX package's."""
    (jE, jA), (tE, tA), _ = _pencils()
    F = tshifted_dia(tE, tA, -0.7)
    solver = tbl.prepare(F, T.Krylov())
    pinv = 1.0 / F.diag()
    assert solver.prec.shape == (F.N,)
    torch.testing.assert_close(solver.prec[:N], pinv, rtol=0, atol=0)
    assert bool((solver.prec[N:] == 1).all())
    W = np.random.default_rng(8).standard_normal((N, 3))
    Vj = jbl.prepare(jdia.shifted_dia(jE, jA, -0.7), J.Krylov()).solve(W)
    assert _rel(solver.solve(torch.as_tensor(W)), Vj) < 1e-10
    v = solver.solve(torch.as_tensor(W[:, 0]))  # a vector: the (n,) layout
    assert _rel(v, np.asarray(Vj)[:, 0]) < 1e-10


def test_unported_branches_raise():
    _, (tE, tA), B = _pencils()
    C = torch.as_tensor(np.ones((2, N)))
    gale = T.GALEProblem(tE, tA, T.lowrank(C.T.contiguous()))
    # GMRES and the mixed-precision Krylov core are ported (ROADMAP Queue 1
    # items 6 and 4).
    X = T.solve(gale, T.GMRES(maxiters=2, warn_convergence=False))
    assert isinstance(X, T.LowRank) and X.k > 0
    assert float(T.lr_norm(T.residual(gale, X))) < float(T.lr_norm(gale.C))
    X0 = T.lowrank(C.T.contiguous())
    lr = T.GDREProblem(tE, tA, B, C, X0, (1.0, 0.0))
    # Parareal is ported (ROADMAP Queue 1 item 9): `solve` reaches
    # `solve_gdre_parareal`, whose slab check refuses 2 steps over 3 slabs.
    with pytest.raises(ValueError, match="not divisible by slabs=3"):
        T.solve(lr, T.Parareal(slabs=3), dt=-0.5, shifts=np.asarray([-1.0]),
                cfg=T.models.compiled.CompiledConfig())
    # The dense branches are ported (ROADMAP Queue 1 item 7, PR 6); the
    # dense integrators take no inner algorithm but BartelsStewart.
    dense = T.GDREProblem(tE, tA, B, C, torch.eye(N, dtype=torch.float64), (1.0, 0.0))
    for alg in (T.Ros1(inner_alg=T.ADI()), T.Ros2(inner_alg=T.ADI())):
        with pytest.raises(NotImplementedError, match="BartelsStewart inner solves"):
            T.solve(dense, alg, dt=-0.5)
    assert T.residual(gale, torch.zeros((N, N), dtype=torch.float64)).shape == (N, N)
    assert isinstance(tbl.prepare(tA, T.Krylov(method="gmres")), tbl.KrylovSolver)
    refined = tbl.prepare(tA, T.Krylov(solve_dtype="float32"))
    assert isinstance(refined, tbl.RefinedKrylovSolver)
    assert refined.inner.op.dtype == torch.float32 and refined.iters == 2
    with pytest.raises(ValueError, match="unknown Krylov method"):
        tbl.prepare(tA, T.Krylov(method="minres"))
    with pytest.raises(TypeError, match="no GALE solver"):
        T.solve(gale, T.Newton())
    with pytest.raises(TypeError, match="no GDRE integrator"):
        T.solve(dense, T.ADI())
    with pytest.raises(TypeError, match="init not supported"):
        T.init(lr, T.Ros1())

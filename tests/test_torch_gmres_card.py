"""GMRES and the mixed-precision Krylov core on the card against the same
solves on the CPU: `Krylov(method="gmres")` through K1 in f64, and the
refined solves (`Krylov(solve_dtype="float32")`) whose cores run K1 and K2
in f32 and whose residuals run them in f64.

This file imports no JAX, so its card tests run on a machine without it:
``python -m pytest --noconftest tests/test_torch_gmres_card.py -m cuda``.
Without a card the ``cuda`` tests skip; the CPU tests check that the CPU
path never reaches a kernel.  Tolerances card vs CPU: GMRES 1e-12 relative
(a fixed number of Arnoldi steps, f64 sums in another order); the refined
solves 1e-10 (the f32 cores round differently on each device; three
refinement sweeps bring both to the f64 solution, which the Krylov
tolerance 10·eps(f64) pins to about 1e-13).
"""

import numpy as np
import pytest
import torch

from differentialriccatiequations_jl_tpu_torch import Krylov
from differentialriccatiequations_jl_tpu_torch.kernels import bell_spmm as k2
from differentialriccatiequations_jl_tpu_torch.kernels import dia_spmm as k1
from differentialriccatiequations_jl_tpu_torch.ops.blocklinear import (
    KrylovSolver, RefinedKrylovSolver, prepare)
from differentialriccatiequations_jl_tpu_torch.ops.dia import dia_pencil, shifted_dia
from differentialriccatiequations_jl_tpu_torch.ops.sparse import bell_pencil, shifted_bell
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate

N = 1357
GMRES = Krylov(method="gmres", restart=20, maxiter=3, tol=1e-12, negate=True,
               preconditioner="block_jacobi")
REFINED = Krylov(method="cg", negate=True, preconditioner="block_jacobi", tol=1e-15,
                 maxiter=400, solve_dtype="float32", refine_iters=3)


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return float(torch.linalg.norm(a.cpu() - b.cpu()) / torch.linalg.norm(b.cpu()))


def _operator(fmt, n, dev):
    """``Aᵀ − Eᵀ`` of the Rail surrogate as a DIA or block-ELL operator."""
    E, A, _, _ = rail_surrogate(n)
    if fmt == "dia":
        return shifted_dia(*dia_pencil(E, A, device=dev), -1.0)
    return shifted_bell(*bell_pencil(E, A, bs=128, device=dev), -1.0)


def _rhs(n, q, dev):
    rng = np.random.default_rng(7)
    return torch.as_tensor(rng.standard_normal((n, q)), device=dev)


def _residual(F, X, B):
    return float(torch.linalg.norm(F.mm(X) - B) / torch.linalg.norm(B))


@pytest.mark.parametrize("fmt,alg", [("dia", GMRES), ("dia", REFINED), ("bell", REFINED)],
                         ids=["gmres-dia", "refined-dia", "refined-bell"])
def test_cpu_solves_never_launch(fmt, alg):
    F = _operator(fmt, 300, "cpu")
    B = _rhs(300, 3, "cpu")
    before = (k1.launches, k2.launches)
    solver = prepare(F, alg)
    assert isinstance(solver, RefinedKrylovSolver if alg.solve_dtype else KrylovSolver)
    X = solver.solve(B)
    assert (k1.launches, k2.launches) == before
    assert X.dtype == torch.float64
    assert _residual(F, X, B) < (1e-6 if alg is GMRES else 1e-11)


@pytest.mark.cuda
@pytest.mark.parametrize("fmt,alg", [("dia", GMRES), ("dia", REFINED), ("bell", REFINED)],
                         ids=["gmres-dia", "refined-dia", "refined-bell"])
def test_card_matches_cpu(fmt, alg):
    dev = _cuda()
    kern = k1 if fmt == "dia" else k2
    out = {}
    for d in (dev, "cpu"):
        F = _operator(fmt, N, d)
        before = dict(kern.launches_by_dtype)
        out[d if d == "cpu" else "cuda"] = prepare(F, alg).solve(_rhs(N, 7, d))
        if d != "cpu":
            torch.cuda.synchronize()
            launched = {dt: kern.launches_by_dtype[dt] - before[dt] for dt in before}
            assert launched[torch.float64] > 0
            if alg.solve_dtype:
                assert launched[torch.float32] > 0
    tol = 1e-12 if alg is GMRES else 1e-10
    assert _rel(out["cuda"], out["cpu"]) <= tol

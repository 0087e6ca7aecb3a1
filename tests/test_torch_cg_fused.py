"""The fused CG iteration (`ops.blocklinear._cg_fused`, `kernels.cg_fused`).

On the CPU: the plain versions of the four kernels, run through the fused
loop, reproduce the present `_cg` loop bit for bit (the same ``x`` and
iteration count), and the route is taken by real CG without a mesh only.
On the card (``cuda``): the kernels through the same solves against `_cg`.
The CPU itself takes `_cg`; the tests put a solve on the fused loop, or off
it, by patching the route's choice (`KrylovSolver._fused`).

This file imports no JAX, so its card tests run on a machine without it:
``python -m pytest --noconftest tests/test_torch_cg_fused.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from differentialriccatiequations_jl_tpu_torch.kernels import cg_fused
from differentialriccatiequations_jl_tpu_torch.ops import blocklinear
from differentialriccatiequations_jl_tpu_torch.ops.blocklinear import Krylov, prepare
from differentialriccatiequations_jl_tpu_torch.ops.dia import dia_from_scipy
from differentialriccatiequations_jl_tpu_torch.ops.operators import op_astype
from differentialriccatiequations_jl_tpu_torch.ops.sparse import bell_from_scipy
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate

N = 371
MU = -0.5


def _shifted(negate: bool):
    """``Aᵀ + μEᵀ`` (negative definite: CG with ``negate``), or its negation."""
    E, A, _, _ = rail_surrogate(N)
    F = (A.T + MU * E.T).tocsr()
    return F if negate else (-F).tocsr()


def _solver(fmt, negate, prec, dtype, device="cpu"):
    F = _shifted(negate)
    if fmt == "dia":
        op = dia_from_scipy(F, dtype=dtype, device=device)
    else:
        op = bell_from_scipy(F, bs=64 if device == "cpu" else 20, dtype=dtype, device=device)
    eps = float(torch.finfo(dtype).eps)
    cfg = Krylov(method="cg", tol=10 * eps, maxiter=400, preconditioner=prec, negate=negate)
    return prepare(op, cfg), F


def _rhs(q, dtype, device="cpu"):
    W = np.random.default_rng(q).standard_normal((N, q))
    return torch.as_tensor(W, dtype=dtype, device=device)


class _OnCard:
    """What `KrylovSolver._fused` reads of a state, as of the same state on
    the card."""

    is_cuda = True

    def __init__(self, B):
        self.dtype = B.dtype


def _counted(solve, B):
    k0, f0 = blocklinear.krylov_iterations, blocklinear.krylov_fused_iterations
    x = solve(B)
    return x, blocklinear.krylov_iterations - k0, blocklinear.krylov_fused_iterations - f0


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("q", [1, 7, 48])
@pytest.mark.parametrize("prec", ["block_jacobi", "jacobi"])
@pytest.mark.parametrize("negate", [True, False], ids=["negate", "plain"])
@pytest.mark.parametrize("fmt", ["dia", "bell"])
def test_plain_fused_iteration_matches_cg(monkeypatch, fmt, negate, prec, q, dtype):
    """DIA's lane-major (q, N) state and block-ELL's column-major (n, q)
    one: the plain versions of the four kernels give `_cg`'s ``x`` bit for
    bit, in as many iterations, every one counted as fused."""
    solver, F = _solver(fmt, negate, prec, dtype)
    B = _rhs(q, dtype)
    ref, k_ref, f_ref = _counted(solver.solve, B)
    assert f_ref == 0 and k_ref > 0
    monkeypatch.setattr(blocklinear.KrylovSolver, "_fused", lambda self, B: True)
    got, k, f = _counted(solver.solve, B)
    assert k == k_ref and f == k
    assert torch.equal(got, ref)
    if dtype == torch.float64:
        res = np.linalg.norm(F @ got.numpy() - B.numpy()) / np.linalg.norm(B.numpy())
        assert res < 1e-12


def _mesh_solve(solver, B, tmp_path):
    """``solver.solve(B)`` under a world-size-1 gloo mesh."""
    import torch.distributed as dist

    from differentialriccatiequations_jl_tpu_torch.parallel.mesh import make_mesh, use_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store", rank=0,
                            world_size=1)
    try:
        with use_mesh(make_mesh(device="cpu")):
            return solver.solve(B)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("case", ["cg", "bicgstab", "gmres", "complex", "mesh"])
def test_fused_route_is_real_cg_without_a_mesh(monkeypatch, tmp_path, case):
    """The route's choice, with the state seen as on the card: real CG
    takes the fused loop (here its plain versions), one fused iteration
    each Krylov iteration; BiCGStab, GMRES, a complex operand and an active
    mesh take the present loops, the count put."""
    choose = blocklinear.KrylovSolver._fused
    monkeypatch.setattr(blocklinear.KrylovSolver, "_fused",
                        lambda self, B: choose(self, _OnCard(B)))
    solver, _ = _solver("dia", True, "block_jacobi", torch.float64)
    B = _rhs(7, torch.float64)
    if case in ("bicgstab", "gmres"):
        solver = blocklinear.KrylovSolver(op=solver.op, prec=solver.prec, cfg=Krylov(
            method=case, tol=1e-12, maxiter=50, restart=10,
            preconditioner="block_jacobi", negate=True))
    if case == "complex":
        solver = prepare(op_astype(solver.op, torch.complex128), solver.cfg)
        B = B.to(torch.complex128) * (1 + 0.5j)
    solve = (lambda B: _mesh_solve(solver, B, tmp_path)) if case == "mesh" else solver.solve
    _, k, f = _counted(solve, B)
    assert k > 0
    assert f == (k if case == "cg" else 0)


@pytest.mark.parametrize("case", ["wide", "dtype", "device", "short"])
def test_fused_route_refuses_what_the_kernels_cannot_take(monkeypatch, case):
    """On the fused route a preconditioner the kernels cannot take raises:
    block-Jacobi blocks wider than `cg_fused.MAX_BS`, inverses of another
    dtype or device than the state's, fewer rows than the state's."""
    choose = blocklinear.KrylovSolver._fused
    monkeypatch.setattr(blocklinear.KrylovSolver, "_fused",
                        lambda self, B: choose(self, _OnCard(B)))
    if case == "wide":
        op = bell_from_scipy(_shifted(True), bs=cg_fused.MAX_BS + 32, dtype=torch.float64,
                             device="cpu")
        solver = prepare(op, Krylov(method="cg", preconditioner="block_jacobi", negate=True))
    else:
        solver, _ = _solver("dia", True, "block_jacobi", torch.float64)
        prec = {"dtype": solver.prec.to(torch.float32), "device": solver.prec.to("meta"),
                "short": solver.prec[:2]}[case]
        solver = blocklinear.KrylovSolver(op=solver.op, prec=prec, cfg=solver.cfg)
    with pytest.raises(ValueError, match="cg_fused"):
        solver.solve(_rhs(7, torch.float64))


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("q", [1, 7, 48])
@pytest.mark.parametrize("prec", ["block_jacobi", "jacobi"])
@pytest.mark.parametrize("fmt", ["dia", "bell"])
def test_kernels_match_cg_on_card(monkeypatch, fmt, prec, q, dtype):
    """The four kernels (block-ELL at bs = 20: ragged chunks of the block
    product) against `_cg` on the card: iteration counts within one, ``x``
    within the tolerance's order."""
    dev = _cuda()
    solver, _ = _solver(fmt, True, prec, dtype, device=dev)
    B = _rhs(q, dtype, device=dev)
    launches = cg_fused.launches
    got, k, f = _counted(solver.solve, B)
    assert f == k > 0 and cg_fused.launches - launches >= 4 * k
    monkeypatch.setattr(blocklinear.KrylovSolver, "_fused", lambda self, B: False)
    ref, k_ref, f_ref = _counted(solver.solve, B)
    assert f_ref == 0 and abs(k - k_ref) <= 1
    tol = 1e-10 if dtype == torch.float64 else 1e-3
    assert float(torch.linalg.norm(got - ref) / torch.linalg.norm(ref)) < tol

"""The dense path on the card against the same calls on the CPU, and the
dense entry points' device rule.

This file imports no JAX, so its card tests run on a machine without it:
``python -m pytest --noconftest tests/test_torch_dense_card.py -m cuda``.
Without a card the ``cuda`` tests skip.  Tolerance card vs CPU: 1e-12
relative (the same factorizations and f64 products, summed in another
order).
"""

import numpy as np
import pytest
import torch

from differentialriccatiequations_jl_tpu_torch import (
    BartelsStewart, GALEProblem, GDREProblem, Kronecker, Ros2, residual, solve)
from differentialriccatiequations_jl_tpu_torch.lowrank import lr_to_dense, lr_zero
from differentialriccatiequations_jl_tpu_torch.models import compiled
from differentialriccatiequations_jl_tpu_torch.ops.operators import DenseOp
from differentialriccatiequations_jl_tpu_torch.utils.testmat import (
    conv_diff_surrogate, rail_surrogate_dense, random_rhs_lowrank)

RTOL = 1e-12


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _rel(a, b):
    return float(torch.linalg.norm(a.cpu() - b.cpu()) / torch.linalg.norm(b.cpu()))


def _gale(n, dev):
    E, A, _, C = rail_surrogate_dense(n, device=dev)
    return GALEProblem(E, A, C.T @ C)


def test_dense_data_take_an_explicit_device():
    """The dense builders run where the caller says: no default device, no
    fallback from a missing card to the CPU."""
    with pytest.raises(TypeError):
        rail_surrogate_dense(8)  # device is required
    E, _, _, _ = rail_surrogate_dense(8, device="cpu")
    assert E.device.type == "cpu" and E.dtype == torch.float64
    if not torch.cuda.is_available():
        with pytest.raises((AssertionError, RuntimeError)):
            rail_surrogate_dense(8, device="cuda")


@pytest.mark.parametrize("alg", [BartelsStewart(), BartelsStewart(host=True)])
def test_dense_gale_stays_on_its_device(alg):
    """Each GALE solver returns on the device of its problem, the SciPy
    oracle included."""
    prob = _gale(30, "cpu")
    X = solve(prob, alg)
    assert X.device.type == "cpu" and X.shape == (30, 30)
    assert float(torch.linalg.norm(residual(prob, X)) / torch.linalg.norm(prob.C)) < 1e-10


@pytest.mark.cuda
def test_dense_gale_card_matches_cpu():
    dev = _cuda()
    for alg in (BartelsStewart(), BartelsStewart(host=True)):
        Xg, Xc = solve(_gale(200, dev), alg), solve(_gale(200, "cpu"), alg)
        assert Xg.device.type == "cuda"
        assert _rel(Xg, Xc) < RTOL
    assert _rel(solve(_gale(30, dev), Kronecker()), solve(_gale(30, "cpu"), Kronecker())) < RTOL


@pytest.mark.cuda
def test_dense_ros2_card_matches_cpu():
    dev = _cuda()
    sols = []
    for d in (dev, "cpu"):
        E, A, B, C = rail_surrogate_dense(200, device=d)
        L0 = torch.linalg.solve(E, C.T)
        X0 = L0 @ (0.01 * torch.eye(6, dtype=torch.float64, device=d)) @ L0.T
        sols.append(solve(GDREProblem(E, A, B, C, X0, (4500.0, 4400.0)), Ros2(), dt=-20.0))
    assert _rel(sols[0].X[-1], sols[1].X[-1]) < RTOL
    assert max(_rel(g, c) for g, c in zip(sols[0].K, sols[1].K)) < RTOL


@pytest.mark.cuda
def test_complex_shift_lus_card_matches_cpu():
    """Complex shifted LUs and the compiled ADI's complex double step on
    dense cores, card vs CPU (an odd complex buffer on the conv-diff
    pencil): equal iteration counts, the iterate within 1e-10."""
    dev = _cuda()
    n, q = 96, 3
    E, A, _, _ = conv_diff_surrogate(n)
    G, S = random_rhs_lowrank(n, q, seed=7)
    sv = np.asarray(compiled.heuristic_shifts_host(E, A, 9, 12, 12))
    shifts = compiled._shift_buffer(sv, torch.float64, 9)
    assert np.iscomplexobj(shifts)
    cfg = compiled.CompiledConfig(maxiters=80, compression_interval=10, r_res=q)
    abstol = 1e-11 * float(np.linalg.norm(G @ S @ G.T))
    outs = []
    for d in (dev, "cpu"):
        def t(x):
            return torch.as_tensor(np.asarray(x), device=d)

        Eo, Ao = DenseOp(t(E.toarray())), DenseOp(t(A.toarray()))
        lus = compiled.build_step_shift_solvers(Eo, Ao, shifts)
        assert lus.lu.is_complex() and lus.lu.device.type == torch.device(d).type
        X, _, iters, _ = compiled.adi_compiled(Eo, Ao, t(G), t(S), q,
                                               lr_zero(n, 64, torch.float64, device=d),
                                               shifts, abstol, cfg, lus)
        outs.append((lr_to_dense(X), iters))
    assert outs[0][1] == outs[1][1]
    assert _rel(outs[0][0], outs[1][0]) < 1e-10

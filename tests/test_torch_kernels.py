"""The kernels' wrappers (K1, the DIA SpMM; K2, the block-ELL SpMM): where
they route, K1 and K2 against their plain versions on the card, and the
entry point's device rule.

This file imports no JAX, so its card tests run on a machine without it:
``python -m pytest --noconftest tests/test_torch_kernels.py -m cuda`` (the
conftest imports JAX).  Without a card the ``cuda`` tests skip.
"""

import numpy as np
import pytest
import torch

from differentialriccatiequations_jl_tpu_torch import config
from differentialriccatiequations_jl_tpu_torch.kernels import bell_spmm as k2
from differentialriccatiequations_jl_tpu_torch.kernels import dia_spmm as k1
from differentialriccatiequations_jl_tpu_torch.ops import dia as tdia
from differentialriccatiequations_jl_tpu_torch.ops import sparse as tsparse
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate


def _cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def test_wrapper_routes_by_device():
    """CPU tensors take the plain version (no launch); any other device
    than CPU or CUDA raises instead of falling back."""
    E, A, _, _ = rail_surrogate(64)
    op, _ = tdia.dia_pencil(E, A)
    X = torch.ones((64, 2), dtype=torch.float64)
    before = k1.launches
    torch.testing.assert_close(op.mm(X), k1.dia_mm_plain(op.data, op.offsets, X))
    assert k1.launches == before
    meta = torch.empty((2, 64), dtype=torch.float64, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        k1.dia_mm_t(op.data.to("meta"), op.offsets, meta)


def test_k2_wrapper_routes_by_device():
    """CPU tensors take K2's plain version (no launch); other devices raise."""
    E, A, _, _ = rail_surrogate(100)
    op, _ = tsparse.bell_pencil(E, A, bs=16)
    X = torch.ones((100, 3), dtype=torch.float64)
    before = k2.launches
    ref = torch.as_tensor(E.toarray()) @ X
    torch.testing.assert_close(op.mm(X), ref)
    torch.testing.assert_close(op.tmm(X), ref)
    assert k2.launches == before
    with pytest.raises(ValueError, match="no kernel"):
        k2.bell_mm(op.cols.to("meta"), op.data.to("meta"), X.to("meta"))


def test_entry_without_a_device_raises(monkeypatch):
    """`entry()` runs on the card or raises; the CPU only when asked."""
    from differentialriccatiequations_jl_tpu_torch.entry import entry

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        config.device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    _, args = entry("cpu")
    assert args[0].device.type == "cpu"


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k1_matches_plain_on_card(dtype, tol):
    """Same summation order as the plain version, only FMA contraction
    differs: a few ulps of the largest entry."""
    dev = _cuda()
    E, A, _, _ = rail_surrogate(5177)
    tE, tA = tdia.dia_pencil(E, A, dtype=dtype, device=dev)
    F = tdia.shifted_dia(tE, tA, -1.0)
    rng = np.random.default_rng(7)
    Xt = torch.as_tensor(rng.standard_normal((12, F.N)), dtype=dtype, device=dev)
    Z = torch.as_tensor(rng.standard_normal((12, F.N)), dtype=dtype, device=dev)
    before = k1.launches
    pairs = [
        (F.mmT(Xt), k1.dia_mm_t_plain(F.data, F.offsets, Xt)),
        (F.mmT_axpby(Xt, Z, 0.37, -1.21),
         0.37 * k1.dia_mm_t_plain(F.data, F.offsets, Xt) - 1.21 * Z),
        (F.mm(Xt.T), k1.dia_mm_plain(F.data, F.offsets, Xt.T)),
        (F.tmm(Xt.T), k1.dia_mm_plain(F.data_t, tuple(-o for o in F.offsets), Xt.T)),
    ]
    assert k1.launches == before + 4
    for got, ref in pairs:
        assert float((got - ref).abs().max() / ref.abs().max()) <= tol
    with pytest.raises(TypeError):
        F.mmT(Xt.to(torch.complex128))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k2_matches_plain_on_card(dtype, tol):
    """K2 sums over slots then block columns in order; the plain einsum in
    another order: a few ulps of the largest entry.  q = 7, 48, 96 are the
    step's widths, 300 takes two launches; `tmm` on a transposed view."""
    dev = _cuda()
    E, A, _, _ = rail_surrogate(5177)
    tE, tA = tsparse.bell_pencil(E, A, dtype=dtype, device=dev)
    F = tsparse.shifted_bell(tE, tA, -1.0)
    rng = np.random.default_rng(8)
    for q in (7, 48, 96, 300):
        X = torch.as_tensor(rng.standard_normal((5177, q)), dtype=dtype, device=dev)
        Xv = X.T.contiguous().T
        before = k2.launches
        got = [F.mm(X), F.tmm(Xv)]
        assert k2.launches == before + 2 * (1 + (q > k2.MAX_Q))
        refs = [k2.bell_mm_plain(F.cols, F.data, X), k2.bell_mm_plain(F.cols_t, F.data_t, Xv)]
        for y, ref in zip(got, refs):
            assert float((y - ref).abs().max() / ref.abs().max()) <= tol
    with pytest.raises(TypeError):
        F.mm(X.to(torch.complex128))


@pytest.mark.cuda
def test_entry_step_card_matches_cpu():
    """The n=256 Ros1 step through K1 on the card against the plain path on
    the CPU: equal ADI iterations, X and K within 1e-9 (Krylov tolerance
    10·eps amplified by the ADI)."""
    from differentialriccatiequations_jl_tpu_torch.entry import entry

    dev = _cuda()
    fn, args = entry(dev)
    before = k1.launches
    Xg, Kg, ig, _ = fn(*args)
    assert k1.launches > before
    fn, args = entry("cpu")
    Xc, Kc, ic, _ = fn(*args)
    assert ig == ic
    Dg, Dc = Xg.to_dense().cpu(), Xc.to_dense()
    assert float(torch.linalg.norm(Dg - Dc) / torch.linalg.norm(Dc)) <= 1e-9
    assert float(torch.linalg.norm(Kg.cpu() - Kc) / torch.linalg.norm(Kc)) <= 1e-9

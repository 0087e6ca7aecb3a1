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

from differentialriccatiequations_jl_tpu_torch import config, kernels
from differentialriccatiequations_jl_tpu_torch.kernels import bell_spmm as k2
from differentialriccatiequations_jl_tpu_torch.kernels import complex_route
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
    op, _ = tdia.dia_pencil(E, A, device="cpu")
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
    op, _ = tsparse.bell_pencil(E, A, bs=16, device="cpu")
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


# Operand layouts and the strides the result must have: (N, q) row-major,
# the (N, q) view of (q, N) storage that the ADI hands `tmm`, and the
# lane-major (q, N) Krylov state (K1's `dia_mm_t` only).
LAYOUTS = {
    "(N, q)": (lambda N, q: torch.zeros((N, q), dtype=torch.float64), lambda N, q: (q, 1)),
    "(N, q) view of (q, N)": (lambda N, q: torch.zeros((q, N), dtype=torch.float64).T,
                              lambda N, q: (1, N)),
    "(q, N)": (lambda N, q: torch.zeros((q, N), dtype=torch.float64), lambda N, q: (N, 1)),
}


@pytest.mark.parametrize("layout", LAYOUTS)
def test_k1_output_follows_operand_layout(layout):
    """K1's wrapper allocates Y in the operand's layout, so the kernel
    writes along the axis it reads along (CPU tensors: checks and
    allocation only, no launch)."""
    make, strides = LAYOUTS[layout]
    N, q = 37, 5
    data = torch.zeros((3, N), dtype=torch.float64)
    X = make(N, q)
    axis = 1 if layout == "(q, N)" else 0
    Y = k1._output(data, (-1, 0, 1), X, axis)
    assert Y.shape == X.shape and Y.stride() == strides(N, q)


@pytest.mark.parametrize("layout", ["(N, q)", "(N, q) view of (q, N)"])
def test_k2_output_follows_operand_layout(layout):
    """K2's wrapper allocates Y in the operand's layout, through the same
    helper as K1's; a single column stays contiguous."""
    make, strides = LAYOUTS[layout]
    n, q, bs = 37, 5, 16
    cols = torch.zeros((3, 2), dtype=torch.int32)
    data = torch.zeros((3, 2, bs, bs), dtype=torch.float64)
    Y = k2._output(cols, data, make(n, q))
    assert Y.shape == (n, q) and Y.stride() == strides(n, q)
    assert kernels.empty_in_layout(make(n, 1)).stride() == (1, 1)


def _rel(got, ref):
    return float((got - ref).abs().max() / ref.abs().max())


@pytest.mark.parametrize("case", ["complex op, complex X", "complex op, real X",
                                  "real op, complex X"])
@pytest.mark.parametrize("fmt", ["dia (N, q)", "dia (q, N)", "bell"])
def test_complex_route_combines_real_products(fmt, case):
    """The complex route's real launches and their combination, with each
    "launch" taken by the plain version on the CPU: the result equals the
    complex product, in two launches for a complex operator and one for a
    real operator."""
    rng = np.random.default_rng(11)
    E, A, _, _ = rail_surrogate(300)
    mu = -0.8 + 0.4j
    real_op = case.startswith("real")
    if fmt == "bell":
        tE, tA = tsparse.bell_pencil(E, A, bs=64, device="cpu")
        F = tE if real_op else tsparse.shifted_bell(tE, tA, mu)
        data, plain, dim = F.data, lambda d, x: k2.bell_mm_plain(F.cols, d, x), 1
    else:
        tE, tA = tdia.dia_pencil(E, A, device="cpu")
        F = tE if real_op else tdia.shifted_dia(tE, tA, mu)
        if fmt == "dia (N, q)":
            data, plain, dim = F.data, lambda d, x: k1.dia_mm_plain(d, F.offsets, x), 1
        else:
            data, plain, dim = F.data, lambda d, x: k1.dia_mm_t_plain(d, F.offsets, x), 0
    shape = (7, 300) if dim == 0 else (300, 7)
    X = torch.as_tensor(rng.standard_normal(shape))
    if case.endswith("complex X"):
        X = torch.complex(X, torch.as_tensor(rng.standard_normal(shape)))
    calls = []

    def launch(d, x):
        assert not d.is_complex() and not x.is_complex() and d.is_contiguous()
        calls.append(x.shape)
        return plain(d, x)

    got = complex_route.product(launch, complex_route.split(data), X, dim)
    assert len(calls) == (1 if real_op else 2)
    torch.testing.assert_close(got, plain(data, X), rtol=1e-13, atol=1e-13)


# The card tests below cover the cases the kernels' tiling creates: n = 1357
# (n % 128 = 77: a masked last block row, rows of X beyond n), widths from
# one column to more than one 128-column chunk of K2, a column slice
# X[:, a:b] (neither axis contiguous), the (N, q) view of (q, N) storage,
# and K1 with more than 16 diagonals (more than one chunk of diagonals).
CARD_QS = (1, 7, 9, 48, 96, 300)


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
        assert _rel(got, ref) <= tol
    with pytest.raises(TypeError):  # K1 takes f32/f64 (and complex by parts)
        F.mmT(Xt.to(torch.float16))
    if dtype == torch.float64:  # a complex operand: one launch on [Re | Im]
        Xc = torch.complex(Xt, Z)
        before = k1.launches
        got = F.mmT(Xc)
        assert k1.launches == before + 1
        assert _rel(got, k1.dia_mm_t_plain(F.data, F.offsets, Xc)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("q", CARD_QS)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k1_layouts_on_card(dtype, tol, q):
    """K1 at n = 1357 in every layout the two kernels of K1 take: (q, N)
    with and without the epilogue, row-major (N, q), the (N, q) view of
    (q, N) storage, and column slices of both; the result keeps the
    operand's layout."""
    dev = _cuda()
    E, A, _, _ = rail_surrogate(1357)
    tE, tA = tdia.dia_pencil(E, A, dtype=dtype, device=dev)
    F = tdia.shifted_dia(tE, tA, -1.0)
    N, offs = F.N, F.offsets
    rng = np.random.default_rng(q)

    def arr(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype, device=dev)

    Xt, Z, X, W = arr(q, N), arr(q, N), arr(N, q), arr(N, q + 5)
    cases = [
        (lambda: k1.dia_mm_t(F.data, offs, Xt), lambda: k1.dia_mm_t_plain(F.data, offs, Xt)),
        (lambda: k1.dia_mm_t(F.data, offs, Xt, Z=Z, alpha=0.37, beta=-1.21),
         lambda: 0.37 * k1.dia_mm_t_plain(F.data, offs, Xt) - 1.21 * Z),
        (lambda: k1.dia_mm(F.data, offs, X), lambda: k1.dia_mm_plain(F.data, offs, X)),
        (lambda: k1.dia_mm(F.data, offs, Xt.T), lambda: k1.dia_mm_plain(F.data, offs, Xt.T)),
        (lambda: k1.dia_mm(F.data, offs, W[:, 2:q + 2]),
         lambda: k1.dia_mm_plain(F.data, offs, W[:, 2:q + 2])),
        (lambda: k1.dia_mm_t(F.data, offs, W.T[2:q + 2]),
         lambda: k1.dia_mm_t_plain(F.data, offs, W.T[2:q + 2])),
    ]
    for kern, plain in cases:
        before = k1.launches
        got = kern()
        assert k1.launches == before + 1
        assert _rel(got, plain()) <= tol
    assert k1.dia_mm(F.data, offs, Xt.T).stride(0) == 1


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k1_many_diagonals_on_card(dtype, tol):
    """21 diagonals: three chunks of K1's diagonal loop, sums in order."""
    import scipy.sparse as sp

    dev = _cuda()
    n = 1357
    rng = np.random.default_rng(21)
    offsets = sorted(rng.choice(np.arange(-400, 401), size=21, replace=False).tolist())
    M = sp.diags([rng.standard_normal(n - abs(o)) for o in offsets], offsets, shape=(n, n))
    op = tdia.dia_from_scipy(M, dtype=dtype, device=dev)
    assert len(op.offsets) == 21
    for q in (7, 48):
        Xt = torch.as_tensor(rng.standard_normal((q, op.N)), dtype=dtype, device=dev)
        assert _rel(op.mmT(Xt), k1.dia_mm_t_plain(op.data, op.offsets, Xt)) <= tol
        assert _rel(op.mm(Xt.T.contiguous()), k1.dia_mm_plain(op.data, op.offsets, Xt.T)) <= tol
    ref = torch.as_tensor(M.toarray(), dtype=dtype, device=dev) @ Xt.T
    assert _rel(op.mm(Xt.T), ref) <= 100 * tol


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k2_matches_plain_on_card(dtype, tol):
    """K2 in f64 sums over slots, then over the inner dimension in 16-wide
    DMMA steps whose inner order is the tensor core's; in f32 over slots
    then b in order; the plain einsum in another order: a few ulps of the
    largest entry.  q = 7, 48, 96 are the step's widths, 300 takes three
    128-column chunks of one launch; `tmm` on a transposed view."""
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
        assert k2.launches == before + 2
        refs = [k2.bell_mm_plain(F.cols, F.data, X), k2.bell_mm_plain(F.cols_t, F.data_t, Xv)]
        for y, ref in zip(got, refs):
            assert _rel(y, ref) <= tol
    with pytest.raises(TypeError):  # K2 takes f32/f64 (and complex by parts)
        F.mm(X.to(torch.float16))
    if dtype == torch.float64:  # a complex operand: one launch on [Re | Im]
        Xc = torch.complex(X, X.flip(0))
        before = k2.launches
        got = F.mm(Xc)
        assert k2.launches == before + 1
        assert _rel(got, k2.bell_mm_plain(F.cols, F.data, Xc)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("q", CARD_QS)
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k2_layouts_on_card(dtype, tol, q):
    """K2 at n = 1357 (the last block row holds 77 rows): row-major X, the
    (n, q) view of (q, n) storage, and a column slice X[:, a:b]; the result
    keeps the operand's layout."""
    dev = _cuda()
    E, A, _, _ = rail_surrogate(1357)
    tE, tA = tsparse.bell_pencil(E, A, dtype=dtype, device=dev)
    F = tsparse.shifted_bell(tE, tA, -1.0)
    n = F.n
    rng = np.random.default_rng(q)
    W = torch.as_tensor(rng.standard_normal((n, q + 5)), dtype=dtype, device=dev)
    for X in (W[:, :q].contiguous(), W[:, :q].T.contiguous().T, W[:, 3:q + 3]):
        before = k2.launches
        got = k2.bell_mm(F.cols, F.data, X)
        assert k2.launches == before + 1
        assert got.stride(0) == (1 if X.stride(0) == 1 and q > 1 else q)
        assert _rel(got, k2.bell_mm_plain(F.cols, F.data, X)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("bs", [9, 20, 200])
@pytest.mark.parametrize("dtype,tol", [(torch.float64, 1e-12), (torch.float32, 1e-5)])
def test_k2_block_sizes_on_card(dtype, tol, bs):
    """Block sizes other than 128: 9 (no 16-byte copies, masked slices),
    20 (rows beyond bs in a 128-row tile) and 200 (two row tiles per block
    row, a ragged last slice)."""
    dev = _cuda()
    E, A, _, _ = rail_surrogate(1357)
    tE, tA = tsparse.bell_pencil(E, A, bs=bs, dtype=dtype, device=dev)
    F = tsparse.shifted_bell(tE, tA, -1.0)
    rng = np.random.default_rng(bs)
    for q in (7, 48):
        X = torch.as_tensor(rng.standard_normal((F.n, q)), dtype=dtype, device=dev)
        assert _rel(F.mm(X), k2.bell_mm_plain(F.cols, F.data, X)) <= tol
        assert _rel(F.tmm(X.T.contiguous().T), k2.bell_mm_plain(F.cols_t, F.data_t, X)) <= tol


@pytest.mark.cuda
@pytest.mark.parametrize("q", (1, 7, 48))
@pytest.mark.parametrize("n", (1357, 5177))
def test_complex_products_on_card(n, q):
    """Complex shifted operators and operands through K1 and K2 on the card
    against their plain versions: two launches for a complex operator, one
    for a real operator on a complex operand.  f64 sums in another order:
    1e-13 relative to the largest entry."""
    dev = _cuda()
    E, A, _, _ = rail_surrogate(n)
    mu = -1.0 + 0.5j
    rng = np.random.default_rng(n + q)

    def cplx(*shape):
        return torch.complex(torch.as_tensor(rng.standard_normal(shape), device=dev),
                             torch.as_tensor(rng.standard_normal(shape), device=dev))

    X = cplx(n, q)
    dE, dA = tdia.dia_pencil(E, A, dtype=torch.float64, device=dev)
    F = tdia.shifted_dia(dE, dA, mu)
    Et = dE.adjoint()
    bE, bA = tsparse.bell_pencil(E, A, bs=128, dtype=torch.float64, device=dev)
    G = tsparse.shifted_bell(bE, bA, mu)
    cases = [
        (k1, 2, lambda: F.mm(X), lambda: k1.dia_mm_plain(F.data, F.offsets, X)),
        (k1, 2, lambda: F.mm(X.real), lambda: k1.dia_mm_plain(F.data, F.offsets, X.real)),
        (k1, 2, lambda: F.mmT(X.T.contiguous()),
         lambda: k1.dia_mm_t_plain(F.data, F.offsets, X.T.contiguous())),
        (k1, 1, lambda: dE.tmm(X), lambda: k1.dia_mm_plain(Et.data, Et.offsets, X)),
        (k2, 2, lambda: G.mm(X), lambda: k2.bell_mm_plain(G.cols, G.data, X)),
        (k2, 2, lambda: G.mm(X.real), lambda: k2.bell_mm_plain(G.cols, G.data, X.real)),
        (k2, 1, lambda: bE.tmm(X), lambda: k2.bell_mm_plain(bE.cols_t, bE.data_t, X)),
    ]
    for kern, nl, run, ref in cases:
        before = kern.launches
        got = run()
        assert kern.launches == before + nl
        torch.cuda.synchronize()
        assert got.is_complex() and _rel(got, ref()) < 1e-13


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

"""The port's DIA operators and kernel K1's plain version against the JAX
package (f64 on the CPU; K1 itself is tested on the card in
`test_torch_kernels.py`).

Inputs are made with numpy from a seed and handed to both packages.
"""

import dataclasses

import numpy as np
import pytest
import scipy.sparse as sp
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from differentialriccatiequations_jl_tpu.ops import dia as jdia  # noqa: E402
from differentialriccatiequations_jl_tpu.ops import operators as jopers  # noqa: E402
from differentialriccatiequations_jl_tpu_torch import convert  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.kernels import dia_spmm as k1  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops import dia as tdia  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops import operators as topers  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate  # noqa: E402

# Same shifted multiply-adds in the same order: only the reductions'
# rounding could differ, and there are none — 1e-13 leaves room for FMA.
RTOL = 1e-13


def _random_banded(n=97, offsets=(-9, -1, 0, 1, 9), seed=0, diag_boost=4.0):
    rng = np.random.default_rng(seed)
    M = sp.lil_matrix((n, n))
    for off in offsets:
        i0, i1 = max(0, -off), min(n, n - off)
        rows = np.arange(i0, i1)
        M[rows, rows + off] = rng.standard_normal(len(rows))
    return (M + diag_boost * sp.eye(n)).tocsr()


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.fixture(scope="module")
def ops():
    M = _random_banded(n=131, seed=3)
    return M, jdia.dia_from_scipy(M), tdia.dia_from_scipy(M, device="cpu")


def test_dia_storage_matches(ops):
    M, jop, top = ops
    assert top.offsets == jop.offsets and top.n == jop.n and top.nnz == jop.nnz
    assert top.symmetric == jop.symmetric
    np.testing.assert_array_equal(_np(top.data), _np(jop.data))
    np.testing.assert_array_equal(_np(top.data_t), _np(jop.data_t))
    np.testing.assert_array_equal(_np(top.diag()), _np(jop.diag()))
    np.testing.assert_array_equal(_np(top.to_dense()), M.toarray())
    assert (top.to_scipy() != M).nnz == 0
    conv = convert.dia_op_from_numpy(np.asarray(jop.data), np.asarray(jop.data_t),
                                     jop.offsets, jop.n, jop.nnz, jop.symmetric, device="cpu")
    assert conv == dataclasses.replace(top, data=conv.data, data_t=conv.data_t)
    np.testing.assert_array_equal(_np(conv.data), _np(top.data))
    for dt, jdt in ((torch.float32, jnp.float32),):
        got, ref = topers.op_astype(top, dt), jopers.op_astype(jop, jdt)
        assert got.dtype == dt
        np.testing.assert_array_equal(_np(got.data_t), _np(ref.data_t))


def test_dia_products_match_xla(ops):
    _, jop, top = ops
    q = 5
    rng = np.random.default_rng(4)
    X = rng.standard_normal((top.N, q))
    Xt = rng.standard_normal((q, top.N))
    Z = rng.standard_normal((q, top.N))
    tX, tXt, tZ = map(torch.as_tensor, (X, Xt, Z))
    offs_t = tuple(-o for o in jop.offsets)
    before = k1.launches
    pairs = [
        (top.mm(tX), jdia._dia_mm_xla(jop.data, jop.offsets, jnp.asarray(X))),
        (top.tmm(tX), jdia._dia_mm_xla(jop.data_t, offs_t, jnp.asarray(X))),
        (top.mmT(tXt), jdia._dia_mm_t_xla(jop.data, jop.offsets, jnp.asarray(Xt))),
        (top.mmT_axpby(tXt, tZ, 0.37, -1.21),
         jop.mmT_axpby(jnp.asarray(Xt), jnp.asarray(Z), 0.37, -1.21)),
        (top.mm(tX[:, 0]), jop.mm(jnp.asarray(X[:, 0]))),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(_np(got), _np(ref), rtol=RTOL, atol=RTOL)
    assert k1.launches == before  # CPU tensors never reach the kernel


def test_dia_adjoint_blocks_and_algebra(ops):
    M, jop, top = ops
    ja, ta = jop.adjoint(), top.adjoint()
    assert ta.offsets == ja.offsets
    np.testing.assert_array_equal(_np(ta.data), _np(ja.data))
    np.testing.assert_array_equal(_np(ta.data_t), _np(ja.data_t))
    for bs, pad in ((32, True), (32, False)):
        np.testing.assert_array_equal(_np(top.diag_blocks(bs, pad)),
                                      _np(jop.diag_blocks(bs, pad)))
    E = _random_banded(n=131, seed=5)
    jE, jA = jdia.dia_pencil(E, M)
    tE, tA = tdia.dia_pencil(E, M, device="cpu")
    assert (tE.offsets, tE.nnz, tA.nnz) == (jE.offsets, jE.nnz, jA.nnz)
    for got, ref in ((tdia.shifted_dia(tE, tA, -0.7), jdia.shifted_dia(jE, jA, jnp.asarray(-0.7))),
                     (tdia.dia_lin_comb(tA, 2.5, tE), jdia.dia_lin_comb(jA, 2.5, jE)),
                     (tdia.dia_scale(tA, -3.0), jdia.dia_scale(jA, -3.0))):
        np.testing.assert_allclose(_np(got.data), _np(ref.data), rtol=RTOL)
        np.testing.assert_allclose(_np(got.data_t), _np(ref.data_t), rtol=RTOL)
        assert got.symmetric == ref.symmetric


def test_dia_pair_op_matches_jax():
    E, A, _, _ = rail_surrogate(150)
    jE, jA = jdia.dia_pencil(E, A)
    tE, tA = tdia.dia_pencil(E, A, device="cpu")
    jop = jdia.DiaPairOp(F=jdia.shifted_dia(jE, jA, jnp.asarray(-1.0)),
                         Et=jE.adjoint(), b=jnp.asarray(0.5))
    top = tdia.DiaPairOp(F=tdia.shifted_dia(tE, tA, -1.0), Et=tE.adjoint(), b=0.5)
    rng = np.random.default_rng(6)
    Xt = rng.standard_normal((6, 150))
    np.testing.assert_allclose(_np(top.mmT(torch.as_tensor(Xt))),
                               _np(jop.mmT(jnp.asarray(Xt))), rtol=RTOL, atol=RTOL)
    np.testing.assert_allclose(_np(top.mm(torch.as_tensor(Xt.T))),
                               _np(jop.mm(jnp.asarray(Xt.T))), rtol=RTOL, atol=RTOL)


@pytest.mark.parametrize("fused", [False, True])
def test_plain_matches_pallas_kernel_interpret_f32(fused):
    """K1's plain version against the TPU kernel it replaces, run through
    the Pallas interpreter in f32 (the kernel's TPU dtype) at the JAX
    package's own tolerance for that kernel (2e-5)."""
    M = _random_banded(n=300, offsets=(-17, -1, 0, 1, 17), seed=14)
    jop = jdia.dia_from_scipy(M, dtype=np.float32)
    top = tdia.dia_from_scipy(M, dtype=torch.float32, device="cpu")
    rng = np.random.default_rng(15)
    Xt = rng.standard_normal((4, top.N)).astype(np.float32)
    Z = rng.standard_normal((4, top.N)).astype(np.float32)
    a, b = np.float32(0.37), np.float32(-1.21)
    old = jdia._INTERPRET
    jdia._INTERPRET = True
    try:
        if fused:
            ref = jdia._dia_mm_pallas_t(jop.data, jop.offsets, jnp.asarray(Xt),
                                        Z=jnp.asarray(Z), coeffs=(a, b))
        else:
            ref = jdia._dia_mm_pallas_t(jop.data, jop.offsets, jnp.asarray(Xt))
    finally:
        jdia._INTERPRET = old
    if fused:
        got = top.mmT_axpby(torch.as_tensor(Xt), torch.as_tensor(Z), float(a), float(b))
    else:
        got = top.mmT(torch.as_tensor(Xt))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(ref), rtol=2e-5, atol=2e-5)

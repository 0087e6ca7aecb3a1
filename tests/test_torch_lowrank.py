"""The port's low-rank factorizations against the JAX package (f64, CPU).

`lr_compress` is unique only up to eigenvector signs (and the order of
equal-magnitude eigenvalues), so factorizations are compared as the dense
``L D Lᵀ`` (n ≤ 400), never through ``L`` itself.
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from differentialriccatiequations_jl_tpu_torch import convert  # noqa: E402
# The package's name `lowrank` is the constructor; the module by its path.
tlr = importlib.import_module("differentialriccatiequations_jl_tpu_torch.lowrank")

jlr = importlib.import_module("differentialriccatiequations_jl_tpu.lowrank")

# The QR and Gram routes are backward stable here (L well conditioned):
# both packages reconstruct L D Lᵀ to a few hundred ulps of its norm.
RTOL = 1e-12


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _pair(L, D, k=None):
    return (tlr.lowrank(torch.as_tensor(L), torch.as_tensor(D), k=k),
            jlr.lowrank(jnp.asarray(L), jnp.asarray(D), k=k))


def _dense(X):
    if isinstance(X, tlr.LowRank):
        return tlr.lr_to_dense(X).numpy()
    return np.asarray(jlr.lr_to_dense(X))


def _factors(n=120, r=24, k=9, seed=0):
    rng = np.random.default_rng(seed)
    L = rng.standard_normal((n, r))
    D = rng.standard_normal((r, r))
    return L, D + D.T, k


def test_lowrank_masking_capacity_and_norm():
    L, D, k = _factors()
    tX, jX = _pair(L, D, k)
    assert tX.k == int(jX.k) == k
    np.testing.assert_array_equal(tX.L.numpy(), np.asarray(jX.L))
    np.testing.assert_array_equal(tX.D.numpy(), np.asarray(jX.D))
    tC = convert.lowrank_from_numpy(np.asarray(jX.L), np.asarray(jX.D), jX.k, device="cpu")
    assert tC.k == k
    np.testing.assert_array_equal(tC.L.numpy(), tX.L.numpy())
    for r_new in (40, 6):
        tY, jY = tlr.lr_with_capacity(tX, r_new), jlr.lr_with_capacity(jX, r_new)
        assert (tY.r, tY.k) == (jY.r, int(jY.k))
        np.testing.assert_array_equal(tY.L.numpy(), np.asarray(jY.L))
        np.testing.assert_array_equal(tY.D.numpy(), np.asarray(jY.D))
    np.testing.assert_allclose(float(tlr.lr_norm(tX)), float(jlr.lr_norm(jX)),
                               rtol=RTOL)


@pytest.mark.parametrize("ky,r_out", [(5, None), (5, 30), (20, 30)])
def test_lr_add_placement(ky, r_out):
    """``Y``'s active columns land after ``X``'s; overflow is dropped."""
    Lx, Dx, kx = _factors(seed=1)
    Ly, Dy, _ = _factors(r=20, seed=2)
    tX, jX = _pair(Lx, Dx, kx)
    tY, jY = _pair(Ly, Dy, ky)
    tS = tlr.lr_add(tX, tY, r_out=r_out)
    jS = jlr.lr_add(jX, jY, r_out=r_out)
    assert (tS.r, tS.k) == (jS.r, int(jS.k))
    np.testing.assert_array_equal(tS.L.numpy(), np.asarray(jS.L))
    np.testing.assert_array_equal(tS.D.numpy(), np.asarray(jS.D))


@pytest.mark.parametrize("method,rank", [("qr", 11), ("gram", 30)])
@pytest.mark.parametrize("r_out", [None, 16])
def test_lr_compress_matches(method, rank, r_out):
    """30 active columns in a 40-wide buffer.  The QR route gets numerical
    rank 11 to reveal; the Gram route squares the condition number, so it
    gets a well-conditioned full-rank factor (its f32 regime's use)."""
    rng = np.random.default_rng(3)
    n, r = 200, 40
    L = np.zeros((n, r))
    L[:, :30] = rng.standard_normal((n, rank)) @ rng.standard_normal((rank, 30))
    D = np.zeros((r, r))
    S = rng.standard_normal((30, 30))
    D[:30, :30] = S + S.T
    tX, jX = _pair(L, D, 30)
    tC = tlr.lr_compress(tX, r_out=r_out, method=method)
    jC = jlr.lr_compress(jX, r_out=r_out, method=method)
    assert tC.k == int(jC.k) == min(rank, r_out or r)
    assert tC.r == jC.r
    assert float(tC.L[:, tC.k:].abs().sum()) == 0.0  # zero-padding invariant
    assert _rel(_dense(tC), _dense(jC)) <= RTOL
    if r_out is None:  # nothing truncated: both reproduce the input
        assert _rel(_dense(tC), _dense(tX)) <= RTOL

"""The port's block-ELL operators (`ops/sparse.py`, kernel K2's plain
version) against the JAX package's ``ops/sparse.py`` on the same numpy
inputs, on the CPU.

Construction is exact (same host numpy code).  Products: f64 against
``_bell_mm_xla`` at 1e-12 relative to the largest entry (same sums, other
order); f32 against the production Pallas kernel ``_bell_mm_pallas`` run
in interpret mode, both of its branches (q = 8 < 128: transposed layout;
q = 128: the ``(nb, K)`` grid), at 1e-5 (f32 sums of up to 384 terms).
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from differentialriccatiequations_jl_tpu.ops import sparse as jsparse  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.convert import bell_op_from_numpy  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.kernels import bell_spmm as k2  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops import sparse as tsparse  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate  # noqa: E402

RTOL_F64 = 1e-12
RTOL_F32 = 1e-5


def _relmax(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    return np.abs(got - ref).max() / np.abs(ref).max()


def _leaves(op):
    return [np.asarray(a) for a in (op.cols, op.data, op.cols_t, op.data_t, op.diag_)]


@pytest.mark.parametrize("n,bs", [(96, 16), (128, 128)])
def test_construction_matches_jax(n, bs):
    E, A, _, _ = rail_surrogate(n)
    pairs = [(tsparse.bell_from_scipy(A, bs=bs, device="cpu"), jsparse.bell_from_scipy(A, bs=bs))]
    pairs += list(zip(tsparse.bell_pencil(E, A, bs=bs, device="cpu"),
                      jsparse.bell_pencil(E, A, bs=bs)))
    for top, jop in pairs:
        assert top.cols.dtype == torch.int32
        for got, ref in zip(_leaves(top), _leaves(jop)):
            np.testing.assert_array_equal(got, ref)
        assert top.n == jop.n and top.bs == jop.bs and top.nnz == jop.nnz
        np.testing.assert_allclose(top.to_dense().numpy(), np.asarray(jop.to_dense()))
        conv = bell_op_from_numpy(*_leaves(jop), jop.n, jop.bs, device="cpu")
        for got, ref in zip(_leaves(conv), _leaves(top)):
            np.testing.assert_array_equal(got, ref)


@pytest.fixture(scope="module")
def pencil96():
    E, A, _, _ = rail_surrogate(96)
    return tsparse.bell_pencil(E, A, bs=16, device="cpu"), jsparse.bell_pencil(E, A, bs=16)


def test_mm_tmm_match_xla_f64(pencil96):
    (_, tA), (_, jA) = pencil96
    rng = np.random.default_rng(11)
    X = rng.standard_normal((96, 5))
    v = rng.standard_normal(96)
    before = k2.launches
    for top, jop in ((tA, jA), (tA.adjoint(), jA.adjoint())):
        ref = jsparse._bell_mm_xla(jop.cols, jop.data, jnp.asarray(X))
        assert _relmax(top.mm(torch.as_tensor(X)), ref) <= RTOL_F64
        ref_t = jsparse._bell_mm_xla(jop.cols_t, jop.data_t, jnp.asarray(X))
        assert _relmax(top.tmm(torch.as_tensor(X)), ref_t) <= RTOL_F64
        assert _relmax(top.mm(torch.as_tensor(v)), jop.mm(jnp.asarray(v))) <= RTOL_F64
    # the (n, q) view of a (q, n) tensor, as the step passes it to tmm
    Xv = torch.as_tensor(X.T.copy()).T
    assert _relmax(tA.tmm(Xv), jA.tmm(jnp.asarray(X))) <= RTOL_F64
    assert k2.launches == before  # CPU tensors take the plain version


@pytest.fixture(scope="module")
def pallas_interpret():
    """The production Pallas kernel in interpret mode (read at trace time)."""
    saved = jsparse._INTERPRET
    jsparse._INTERPRET = True
    yield
    jsparse._INTERPRET = saved


@pytest.mark.parametrize("q", [8, 128])
def test_mm_tmm_match_pallas_interpret_f32(q, pallas_interpret):
    n, bs = 300, 128
    E, A, _, _ = rail_surrogate(n)
    (tE, tA), (jE, jA) = (tsparse.bell_pencil(E, A, bs=bs, dtype=torch.float32, device="cpu"),
                          jsparse.bell_pencil(E, A, bs=bs, dtype=np.float32))
    F_t = tsparse.shifted_bell(tE, tA, -1.0)
    F_j = jsparse.shifted_bell(jE, jA, -1.0)
    X = np.random.default_rng(q).standard_normal((n, q)).astype(np.float32)
    Xp = jnp.asarray(np.pad(X, ((0, 3 * bs - n), (0, 0))))
    for cols, data, tprod in ((F_j.cols, F_j.data, F_t.mm), (F_j.cols_t, F_j.data_t, F_t.tmm)):
        ref = np.asarray(jsparse._bell_mm_pallas(cols, data, Xp))[:n]
        got = tprod(torch.as_tensor(X))
        assert got.dtype == torch.float32
        assert _relmax(got, ref) <= RTOL_F32


def test_lin_comb_scale_shift_match_jax(pencil96):
    (tE, tA), (jE, jA) = pencil96
    cases = [
        (tsparse.bell_lin_comb(tA, -0.125, tE), jsparse.bell_lin_comb(jA, -0.125, jE)),
        (tsparse.bell_scale(tA, 2.5), jsparse.bell_scale(jA, 2.5)),
        (tsparse.shifted_bell(tE, tA, -2.0), jsparse.shifted_bell(jE, jA, -2.0)),
    ]
    for top, jop in cases:
        for got, ref in zip(_leaves(top), _leaves(jop)):
            np.testing.assert_array_equal(got, ref)
    with pytest.raises(ValueError, match="pattern"):
        tsparse.bell_lin_comb(
            tA, 1.0, tsparse.bell_from_scipy(rail_surrogate(96)[1], bs=32, device="cpu"))


def test_diag_blocks_match_jax_when_bs_divides_n(pencil96):
    (tE, tA), (jE, jA) = pencil96
    got = tsparse.shifted_bell(tE, tA, -1.0).diag_blocks()
    ref = jsparse.shifted_bell(jE, jA, -1.0).diag_blocks()
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_diag_blocks_pad_identity_where_bs_does_not_divide_n():
    """n = 100, bs = 16: the last block has 12 padded rows.  The JAX block
    is singular there; the port's carries identity and inverts finitely."""
    E, A, _, _ = rail_surrogate(100)
    (tE, tA) = tsparse.bell_pencil(E, A, bs=16, device="cpu")
    (jE, jA) = jsparse.bell_pencil(E, A, bs=16)
    got = tsparse.shifted_bell(tE, tA, -1.0).diag_blocks()
    ref = np.asarray(jsparse.shifted_bell(jE, jA, -1.0).diag_blocks())
    np.testing.assert_array_equal(got[:-1].numpy(), ref[:-1])
    np.testing.assert_array_equal(got[-1, :4, :4].numpy(), ref[-1, :4, :4])
    np.testing.assert_array_equal(got[-1, 4:, 4:].numpy(), np.eye(12))
    assert torch.isfinite(torch.linalg.inv(got)).all()
    assert np.linalg.matrix_rank(ref[-1]) == 4

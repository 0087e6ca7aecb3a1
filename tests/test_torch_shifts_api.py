"""The shift strategies of the port's ``models/shifts.py`` (`Projection`,
`Heuristic`, `Cyclic`, `Wrapped`, the oracles and their helpers) against
the JAX package's, on ``tests/test_shifts.py``'s cases, f64 on the CPU.

Tolerances: shift values within 1e-12 relative (the same small dense
eigenproblems; the Arnoldi runs the same dense LU solves); structural
properties (stability, conjugate pairs adjacent) exactly.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

from differentialriccatiequations_jl_tpu import ADI as JADI  # noqa: E402
from differentialriccatiequations_jl_tpu import DenseOp as JDenseOp  # noqa: E402
from differentialriccatiequations_jl_tpu.lowrank import lr_zero as jlr_zero  # noqa: E402
from differentialriccatiequations_jl_tpu.models import shifts as JS  # noqa: E402
from differentialriccatiequations_jl_tpu_torch import ADI  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.convert import config_from  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.lowrank import lr_zero  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models import shifts as S  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops.operators import DenseOp  # noqa: E402


def penzl(p):
    return np.array([[-1.0, p], [-p, -1.0]])


def modified_penzl(v):
    return abs(np.real(v)) * penzl(np.imag(v) / np.real(v))


class _Prob:
    def __init__(self, E, A, op):
        self.E = op(E)
        self.A = op(A)


def _penzl_pencil():
    E = np.eye(3)
    A = np.zeros((3, 3))
    A[:2, :2] = penzl(1.0)
    A[2, 2] = -0.5
    return E, A


def _both(E, A):
    return (_Prob(E, A, lambda M: JDenseOp(M)),
            _Prob(E, A, lambda M: DenseOp(torch.as_tensor(M))))


def _close(a, b, tol=1e-12):
    a, b = np.asarray(a, complex), np.asarray(b, complex)
    return a.shape == b.shape and bool(np.all(np.abs(a - b) <= tol * np.abs(a)))


def test_helpers_match_jax():
    for v in (0, 1j, -1, -1 - 2j):
        assert S.is_stable(v) == JS.is_stable(v)
    for v in (np.array(1.0), np.array(2 + 1j)):
        assert S.flip(v) == JS.flip(v)
    vals = np.array([-1 - 1j, -2 + 0j, -1 + 1j, -0.5 + 0j, -2 - 3j, -2 + 3j])
    assert list(S.safe_sort(vals)) == list(JS.safe_sort(vals))


@pytest.mark.parametrize("cplx", [False, True])
def test_stabilize_ritz_values_matches_jax(cplx):
    rng = np.random.default_rng(0)
    v = rng.random(3) + (1j * rng.random(3) if cplx else 0)
    with pytest.warns(UserWarning, match="All Ritz values"):
        w = S.stabilize_ritz_values(np.array(v), "test")
    with pytest.warns(UserWarning, match="All Ritz values"):
        assert _close(w, JS.stabilize_ritz_values(np.array(v), "test"))
    v2 = np.array(v)
    v2[0] = -v2[0].real + 1j * v2[0].imag if cplx else -v2[0]
    with pytest.warns(UserWarning, match="Discarding unstable"):
        w2 = S.stabilize_ritz_values(v2, "test")
    assert len(w2) == 1 and np.all(S.is_stable(w2))


def test_heuristic_penzl_matches_jax():
    jp, tp = _both(*_penzl_pencil())
    js = JS.init_shifts(JS.Heuristic(2, 2, 2), jp).take_many()
    ts = S.init_shifts(S.Heuristic(2, 2, 2), tp).take_many()
    assert _close(js, ts)
    assert 2 <= len(ts) <= 3 and all(np.real(s) < 0 for s in ts)
    i = 0
    while i < len(ts):  # complex shifts adjacent, as conjugate pairs
        if abs(np.imag(ts[i])) > 0:
            assert np.isclose(ts[i + 1], np.conj(ts[i]))
            i += 2
        else:
            i += 1


def test_cyclic_matches_jax():
    o = S.init_shifts(S.Cyclic([1.0, 2.0, 3.0]), None)
    assert [o.take() for _ in range(4)] == [1.0, 2.0, 3.0, 1.0]
    jp, tp = _both(*_penzl_pencil())
    jo = JS.init_shifts(JS.Cyclic(JS.Heuristic(1, 1, 1)), jp)
    to = S.init_shifts(S.Cyclic(S.Heuristic(1, 1, 1)), tp)
    assert _close([jo.take() for _ in range(3)], [to.take() for _ in range(3)])


def test_wrapped_matches_jax():
    class Dummy(S.BufferedOracle):
        def take_many(self):
            return [1.0, 2.0, 3.0]

    o = S.WrappedOracle(lambda v: list(reversed(v)), Dummy())
    assert [o.take() for _ in range(3)] == [3.0, 2.0, 1.0]
    jp, tp = _both(*_penzl_pencil())
    jo = JS.init_shifts(JS.Wrapped(lambda v: [42.0], JS.Heuristic(1, 1, 1)), jp)
    to = S.init_shifts(S.Wrapped(lambda v: [42.0], S.Heuristic(1, 1, 1)), tp)
    assert [to.take(), to.take()] == [jo.take(), jo.take()] == [42.0, 42.0]


def test_projection_known_value():
    """A rank-one residual of ones gives the single shift −5/6."""
    jp, tp = _both(*_penzl_pencil())
    o = S.init_shifts(S.Projection(2), tp)
    assert isinstance(o, S.BufferedOracle)
    o.update(lr_zero(3, 1, torch.float64, device="cpu"), torch.ones((3, 1), dtype=torch.float64))
    jo = JS.init_shifts(JS.Projection(2), jp)
    jo.update(jlr_zero(3, 1, np.float64), np.ones((3, 1)))
    v = o.take()
    assert np.isclose(v, -5.0 / 6.0) and _close([v], [jo.take()])


def test_projection_rejects_odd_history():
    with pytest.raises(ValueError, match="History must be even"):
        S.Projection(1)


def _preserves_conj_pairs(oracle, n):
    i = 0
    while i < n:
        i += 1
        v = oracle.take()
        if abs(np.imag(v)) > 0:
            i += 1
            if not np.isclose(oracle.take(), np.conj(v)):
                return False
    return True


@pytest.mark.parametrize("f", [lambda a: -np.exp(a * 1j), lambda a: -1 - a * 1j])
def test_conjugate_pairs_kept_adjacent(f):
    vals = np.array([f(v) for v in range(-3, 4, 2)])
    assert _preserves_conj_pairs(S.CyclicOracle(S.safe_sort(vals)), len(vals))
    A = np.zeros((4, 4))
    A[:2, :2] = modified_penzl(f(1))
    A[2:, 2:] = modified_penzl(f(2))
    jp, tp = _both(np.eye(4), A)
    o = S.init_shifts(S.Projection(2), tp)
    o.update(None, None, torch.eye(4, dtype=torch.float64))
    jo = JS.init_shifts(JS.Projection(2), jp)
    jo.update(None, None, np.eye(4))
    assert _close(o.take_many(), jo.take_many())
    assert _preserves_conj_pairs(o, 4)


def test_config_hash_stability_and_conversion():
    """Frozen configs hash stably; `config_from` carries the JAX package's
    configs over field by field."""
    builders = [lambda: S.Cyclic((1.0,)), lambda: S.Cyclic(S.Heuristic(1, 2, 3)),
                lambda: S.Projection(2)]
    for b in builders:
        assert hash(b()) == hash(b())
    assert hash(ADI(shifts=S.Projection(2))) == hash(ADI(shifts=S.Projection(2)))
    assert ADI().shifts == S.Projection(2)
    assert config_from(JS.Projection(4)) == S.Projection(4)
    assert config_from(JS.Cyclic(JS.Heuristic(3, 4, 5))) == S.Cyclic(S.Heuristic(3, 4, 5))
    assert config_from(JS.Cyclic([1.0, -2.0 + 1j])) == S.Cyclic((1 + 0j, -2 + 1j))
    assert config_from(JADI(maxiters=7)) == ADI(maxiters=7)

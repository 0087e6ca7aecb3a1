"""The closed-loop Penzl rebuild on the card: the block-tridiagonal Cholesky
factor of a symmetric-definite `DiaOp` (`ops.dia_cholesky`) and
`heuristic_shifts_card` against `heuristic_shifts_host`, f64 on the CPU;
JAX-free.

Tolerances: the factor's solves against SciPy's sparse direct solve at
1e-12 relative (both direct solves of matrices with condition numbers under
200: they agree to rounding); the Ritz values and Penzl shift sets of the
two routes at 1e-8 relative (both run the same Arnoldi, whose roundings
differ in the solves and the order of the products).  The warm-started
rebuilds move the pencil from the open loop to a closed one, as the
Newton's rebuilds do: a warm start is a converged Ritz vector, so a warm
rebuild on a pencil that did not move draws its other Ritz values from
rounding, and neither route's set is then defined to 1e-8.

On the card (``cuda``): one closed-loop rebuild at n = 79841 through both
routes, ``python -m pytest --noconftest tests/test_torch_shifts_card.py -m cuda``.
"""

import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from differentialriccatiequations_jl_tpu_torch.lowrank import lowrank
from differentialriccatiequations_jl_tpu_torch.models import compiled
from differentialriccatiequations_jl_tpu_torch.models import shifts as tshifts
from differentialriccatiequations_jl_tpu_torch.models.problems import GAREProblem
from differentialriccatiequations_jl_tpu_torch.ops.dia import dia_from_scipy, dia_pencil
from differentialriccatiequations_jl_tpu_torch.ops.dia_cholesky import (
    NotDefinite, cholesky_block_size, dia_cholesky)
from differentialriccatiequations_jl_tpu_torch.ops.sparse import bell_pencil
from differentialriccatiequations_jl_tpu_torch.utils.testmat import (
    conv_diff_surrogate, rail_surrogate)

SOLVE_TOL = 1e-12
ROUTE_TOL = 1e-8
NSHIFTS, KP, KM = 20, 30, 30


def _rel(a, b) -> float:
    return float(np.max(np.abs(np.asarray(a) - np.asarray(b)) / np.abs(np.asarray(b))))


def _wide_pencil(nx: int, ny: int, seed: int = 3):
    """The surrogate's stencil on an ``nx × ny`` grid: offsets 0, ±1, ±nx."""
    rng = np.random.default_rng(seed)
    Tx = sp.diags([np.ones(nx - 1), -2 * np.ones(nx), np.ones(nx - 1)], [-1, 0, 1])
    Ty = sp.diags([np.ones(ny - 1), -2 * np.ones(ny), np.ones(ny - 1)], [-1, 0, 1])
    n = nx * ny
    A = (sp.kronsum(Tx, Ty, format="csr") - 0.05 * sp.eye(n)).tocsr()
    off = 0.5 * np.ones(n - 1)
    E = sp.diags([off, 4.0 + rng.random(n), off], [-1, 0, 1]).tocsr()
    return E, A


def _pencils():
    """(name, E, A): the surrogate at n = 371 and 1357 (not multiples of
    their 128-row blocks) and 1024 (a multiple), and a grid whose offset
    ±150 needs 256-row blocks (n = 1200, not a multiple of 256)."""
    out = [(f"rail{n}", *rail_surrogate(n)[:2]) for n in (371, 1024, 1357)]
    out.append(("wide1200", *_wide_pencil(150, 8)))
    return out


@pytest.mark.parametrize("negate", [False, True], ids=["E", "-A"])
@pytest.mark.parametrize("case", _pencils(), ids=lambda c: c[0])
def test_factor_solves_like_spsolve(case, negate):
    name, E, A = case
    E_op, A_op = dia_pencil(E, A, device="cpu")
    op, M = (A_op, A) if negate else (E_op, E)
    b = cholesky_block_size(op)
    assert b == 128 * -(-max(abs(o) for o in op.offsets) // 128)
    assert (op.n % b == 0) == (name == "rail1024")
    fact = dia_cholesky(op, negate=negate)
    X = np.random.default_rng(7).standard_normal((op.n, 5))
    ref = spla.spsolve(M.tocsc(), X)
    got = fact.solve(torch.as_tensor(X))
    assert got.shape == (op.n, 5) and got.dtype == torch.float64
    assert np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref) <= SOLVE_TOL
    one = fact.solve(torch.as_tensor(X[:, 0]))
    assert one.shape == (op.n,)
    assert np.linalg.norm(one.numpy() - ref[:, 0]) / np.linalg.norm(ref[:, 0]) <= SOLVE_TOL
    # Three sets of b × b blocks at most.
    assert fact.nbytes <= 3 * -(-op.n // b) * b * b * 8


def test_wide_offsets_take_wider_blocks():
    E, A = _wide_pencil(150, 8)
    E_op, _ = dia_pencil(E, A, device="cpu")
    assert max(E_op.offsets) == 150 and cholesky_block_size(E_op) == 256
    E_small, _ = dia_pencil(*rail_surrogate(371)[:2], device="cpu")
    assert cholesky_block_size(E_small) == 128


def test_float32_operator_factors_in_float64():
    E, A, _, _ = rail_surrogate(371)
    E32 = dia_from_scipy(E, dtype=torch.float32, device="cpu")
    x = np.random.default_rng(2).standard_normal(371).astype(np.float32).astype(np.float64)
    got = dia_cholesky(E32).solve(torch.as_tensor(x, dtype=torch.float32))
    assert got.dtype == torch.float64
    ref = spla.spsolve(sp.csc_matrix(E32.to_scipy(), dtype=np.float64), x)
    assert np.linalg.norm(got.numpy() - ref) / np.linalg.norm(ref) <= SOLVE_TOL


@pytest.mark.parametrize("which", ["A", "E-5I"])
def test_not_definite_raises(which):
    E, A, _, _ = rail_surrogate(371)
    M = A if which == "A" else (E - 5.0 * sp.eye(371)).tocsr()
    op = dia_from_scipy(M, device="cpu")
    assert op.symmetric is True
    with pytest.raises(NotDefinite, match="not positive definite"):
        dia_cholesky(op)


def _routes(E, A, E_op, A_op, B, Ks, monkeypatch):
    """Both routes over the feedbacks ``Ks`` in turn (the first cold, the
    others warm-started, at half depth, as the Newton's rebuilds run):
    [(host Ritz values, host shifts, card Ritz values, card shifts)]."""
    seen = []
    real = tshifts.heuristic
    monkeypatch.setattr(tshifts, "heuristic", lambda R, ns: (seen.append(R), real(R, ns))[1])
    host_cache, card_cache, out = {}, {}, []
    for i, K in enumerate(Ks):
        warm = i > 0
        kp, km = (KP // 2, KM // 2) if warm else (KP, KM)
        h = tshifts.heuristic_shifts_host(E, A, NSHIFTS, kp, km, B=B, K=K,
                                          lu_cache=host_cache, warm_start=warm)
        c = tshifts.heuristic_shifts_card(E_op, A_op, NSHIFTS, kp, km, torch.as_tensor(B),
                                          torch.as_tensor(K), cache=card_cache,
                                          warm_start=warm)
        out.append((np.sort_complex(seen[-2]), np.sort_complex(np.asarray(h)),
                    np.sort_complex(seen[-1]), np.sort_complex(np.asarray(c))))
    return out


@pytest.mark.parametrize("n", [371, 1357])
@pytest.mark.parametrize("gain", [10.0, 50.0])
def test_card_route_matches_host_route(n, gain, monkeypatch):
    """The open loop (``K = 0``) cold, then the closed loop ``K = gain·Bᵀ``
    warm-started from it."""
    E, A, B, _ = rail_surrogate(n)
    E_op, A_op = dia_pencil(E, A, device="cpu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        runs = _routes(E, A, E_op, A_op, B, [np.zeros((B.shape[1], n)), gain * B.T],
                       monkeypatch)
    for i, (Rh, h, Rc, c) in enumerate(runs):
        assert len(Rh) == len(Rc) and len(h) == len(c) == NSHIFTS
        assert _rel(Rc, Rh) <= ROUTE_TOL, f"Ritz values of call {i}"
        assert _rel(c, h) <= ROUTE_TOL, f"shift set of call {i}"


def test_card_route_keeps_warm_starts_on_the_device(monkeypatch):
    E, A, B, _ = rail_surrogate(371)
    E_op, A_op = dia_pencil(E, A, device="cpu")
    cache = {}
    tshifts.heuristic_shifts_card(E_op, A_op, 8, 12, 12, B=torch.as_tensor(B),
                                  K=torch.zeros((B.shape[1], 371), dtype=torch.float64),
                                  cache=cache)
    assert set(cache) == {"warm_fwd", "warm_bwd"}
    for v in cache.values():
        assert isinstance(v, torch.Tensor) and v.shape == (371,)
        assert abs(float(torch.linalg.vector_norm(v)) - 1.0) < 1e-12


def test_route_predicate():
    E, A, _, _ = rail_surrogate(371)
    E_op, A_op = dia_pencil(E, A, device="cpu")
    # The CPU keeps the host route: the tests hold it against the JAX package.
    assert not compiled._shifts_on_card(E_op, A_op)
    Ec, Ac, _, _ = conv_diff_surrogate(371)
    Ec_op, Ac_op = dia_pencil(Ec, Ac, device="cpu")
    assert Ac_op.symmetric is False
    Eb, Ab = bell_pencil(E, A, bs=128, device="cpu")
    for e, a in ((Ec_op, Ac_op), (Eb, Ab)):
        assert not compiled._shifts_on_card(e, a)


N_NEWTON = 371
NEWTON_KW = dict(shifts=compiled.PerStepHeuristic(NSHIFTS, KP, KM),
                 cfg=compiled.CompiledConfig(60, 10, 48), capacity=128, reltol=1e-10)


@pytest.fixture(scope="module")
def newton_problem():
    E, A, B, C = rail_surrogate(N_NEWTON)
    E_op, A_op = dia_pencil(E, A, device="cpu")
    return GAREProblem(E_op, A_op, lowrank(torch.as_tensor(1000.0 * B)),
                       lowrank(torch.as_tensor(C.T.copy())))


def _newton(prob, monkeypatch, route, card_fn=None):
    monkeypatch.setattr(compiled, "_shifts_on_card", lambda E, A: route)
    if card_fn is not None:
        monkeypatch.setattr(compiled, "heuristic_shifts_card", card_fn)
    before = (compiled.shift_rebuilds, compiled.shift_rebuilds_card)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        X, info = compiled.solve_gare_newton_compiled(prob, **NEWTON_KW)
    counts = (compiled.shift_rebuilds - before[0], compiled.shift_rebuilds_card - before[1])
    return X, info, counts, [str(w.message) for w in caught]


@pytest.fixture(scope="module")
def host_newton(newton_problem):
    mp = pytest.MonkeyPatch()
    try:
        return _newton(newton_problem, mp, False)
    finally:
        mp.undo()


def test_newton_through_the_card_route(newton_problem, host_newton, monkeypatch):
    Xh, ih, (rh, ch), _ = host_newton
    Xc, ic, (rc, cc), _ = _newton(newton_problem, monkeypatch, True)
    assert ih["converged"] and ic["converged"]
    assert ic["newton_steps"] == ih["newton_steps"]
    assert ic["adi_iters"] == ih["adi_iters"]
    assert ic["shift_rebuilds"] == ih["shift_rebuilds"] == rh == rc == cc > 0
    assert ch == 0
    Dh = Xh.L @ Xh.D @ Xh.L.T
    Dc = Xc.L @ Xc.D @ Xc.L.T
    assert float(torch.linalg.norm(Dc - Dh) / torch.linalg.norm(Dh)) <= 1e-9


def test_newton_falls_back_to_the_host_route(newton_problem, host_newton, monkeypatch):
    """A factor that finds ``E`` or ``−A`` not definite sends the rest of
    the solve to the host route, with a warning: the host route's solve,
    rebuild for rebuild, and no card rebuild counted."""
    calls = []

    def not_definite(*args, **kwargs):
        calls.append(1)
        raise NotDefinite("planted")

    Xh, ih, (rh, _), warned_h = host_newton
    Xf, i_f, (rf, cf), warned_f = _newton(newton_problem, monkeypatch, True, not_definite)
    assert len(calls) == 1 and cf == 0 and rf == rh
    fallback = "closed-loop shifts on the host route: planted"
    assert fallback in warned_f and fallback not in warned_h
    assert i_f["residuals"] == ih["residuals"] and i_f["adi_iters"] == ih["adi_iters"]
    assert torch.equal(Xf.L, Xh.L) and torch.equal(Xf.D, Xh.D)


@pytest.mark.cuda
def test_closed_loop_rebuild_on_card():
    """At n = 79841: one closed-loop rebuild through both routes, cold, the
    Newton cell's depth (30 + 30 steps, 20 shifts)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    n = 79841
    E, A, B, _ = rail_surrogate(n)
    E_op, A_op = dia_pencil(E, A, dtype=torch.float64, device="cuda")
    K = 10.0 * B.T
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        host = tshifts.heuristic_shifts_host(E, A, NSHIFTS, KP, KM, B=B, K=K)
        card = tshifts.heuristic_shifts_card(
            E_op, A_op, NSHIFTS, KP, KM, B=torch.as_tensor(B, device="cuda"),
            K=torch.as_tensor(K, device="cuda"))
    assert _rel(np.sort_complex(np.asarray(card)), np.sort_complex(np.asarray(host))) <= ROUTE_TOL

"""The slice as a whole: the port's compiled Kleinman–Newton GARE solver
and its pieces (`residual_gare_lowrank`, `_shift_buffer`,
`_linesearch_combine`) against the JAX package's on the same numpy inputs,
f64 on the CPU.

The port's problem is built from the JAX problem's leaves
(`convert.gare_problem_from_numpy`).  Tolerances: 1e-12 relative for the
pieces (the same operations, rounding only); for the solver, equal Newton
steps, θ-stages, shift rebuilds and ADI iteration counts, ``X`` and ``K``
within 1e-9 (the Krylov tolerance 10·eps amplified by the ADI and the
Newton iteration) and each residual within 1e-8 relative, or within the
residual's rounding floor n·eps·‖Q‖ once it has reached it.
"""

import importlib
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from differentialriccatiequations_jl_tpu.ops import dia as jdia  # noqa: E402
# The package's name `lowrank` is the constructor; the module by its path.
tlr = importlib.import_module("differentialriccatiequations_jl_tpu_torch.lowrank")
from differentialriccatiequations_jl_tpu_torch.convert import gare_problem_from_numpy  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.kernels import dia_spmm as k1  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models import compiled as tcomp  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models import shifts as tshifts  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models.problems import GAREProblem  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models.residuals import residual_gare_lowrank  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models.rosenbrock_lowrank import feedback_K  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops import sparse as tsparse  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils.callbacks import Observer  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate  # noqa: E402

jcomp = importlib.import_module("differentialriccatiequations_jl_tpu.models.compiled")
jprob = importlib.import_module("differentialriccatiequations_jl_tpu.models.problems")
jres = importlib.import_module("differentialriccatiequations_jl_tpu.models.residuals")
jlr = importlib.import_module("differentialriccatiequations_jl_tpu.lowrank")

N = 128
CFG = tcomp.CompiledConfig(maxiters=120, r_res=32)
CFG_J = jcomp.CompiledConfig(maxiters=120, r_res=32)
CAPACITY = 128
EPS = float(np.finfo(np.float64).eps)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # Beside the JAX package's CPU thread pool, torch's own pool slows the
    # small products down; never raise the count again (MKL stalls).
    torch.set_num_threads(1)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _dia_leaves(op) -> dict:
    return dict(data=np.asarray(op.data), data_t=np.asarray(op.data_t),
                offsets=op.offsets, n=op.n, nnz=op.nnz_, symmetric=op.symmetric)


def _lr_leaves(X):
    return np.asarray(X.L), np.asarray(X.D), int(X.k)


def _problems(gscale: float):
    """The n=128 Rail GARE with ``G = lowrank(gscale·B)``, ``Q = lowrank(Cᵀ)``
    in both packages: (JAX problem, port problem, scipy E, scipy A)."""
    E, A, B, C = rail_surrogate(N)
    jE, jA = jdia.dia_pencil(E, A)
    jp = jprob.GAREProblem(jE, jA, jlr.lowrank(jnp.asarray(gscale * B)),
                           jlr.lowrank(jnp.asarray(C.T)))
    tp = gare_problem_from_numpy(_dia_leaves(jE), _dia_leaves(jA),
                                 _lr_leaves(jp.G), _lr_leaves(jp.Q), device="cpu")
    return jp, tp, E, A


def _lr_pair(rng, r, k):
    """The same random `LowRank` (capacity r, rank k) in both packages."""
    L = rng.standard_normal((N, r))
    D = rng.standard_normal((r, r))
    D = D + D.T
    return tlr.lowrank(torch.as_tensor(L), torch.as_tensor(D), k=k), jlr.lowrank(L, D, k=k)


def _check_solve(tout, jout, tp, jp):
    """X and K of both solves within 1e-9, residual histories as stated in
    the module docstring."""
    (Xt, it), (Xj, ij) = tout, jout
    assert it["newton_steps"] == ij["newton_steps"]
    assert it["adi_iters"] == ij["adi_iters"]
    assert it["shift_rebuilds"] == ij["shift_rebuilds"]
    assert it["converged"] and ij["converged"]
    assert set(it) == set(ij)
    floor = N * EPS * float(tlr.lr_norm(tp.Q))
    np.testing.assert_allclose(it["residuals"], ij["residuals"], rtol=1e-8, atol=floor)
    assert _rel(tlr.lr_to_dense(Xt).numpy(), jlr.lr_to_dense(Xj)) <= 1e-9
    Kt = feedback_K(tp.E, tp.G.L, Xt).numpy()
    Kj = np.asarray(((jp.G.L.T @ Xj.L) @ Xj.D) @ jp.E.tmm(Xj.L).T)
    assert _rel(Kt, Kj) <= 1e-9


class _Events(Observer):
    def __init__(self):
        self.events = []

    def observe_gare_start(self, prob, alg):
        self.events.append("start")

    def observe_gare_step(self, iter, X, residual, residual_norm):
        self.events.append(("step", iter, residual_norm))

    def observe_gare_done(self, iters, X, residual, residual_norm):
        self.events.append("done")

    def observe_gare_metadata(self, desc, metadata):
        self.events.append(desc)


@pytest.fixture(scope="module")
def fixed_shift_solves():
    """Both packages' Newton with a fixed real Penzl buffer (the
    configuration of the JAX package's ``test_newton_compiled_gare``)."""
    jp, tp, E, A = _problems(1.0)
    shifts = np.asarray([s.real for s in tshifts.heuristic_shifts_host(E, A, 10, 12, 12)])
    tout = tcomp.solve_gare_newton_compiled(tp, shifts=shifts, cfg=CFG,
                                            capacity=CAPACITY, reltol=1e-11)
    jout = jcomp.solve_gare_newton_compiled(jp, shifts=jnp.asarray(shifts), cfg=CFG_J,
                                            capacity=CAPACITY, reltol=1e-11)
    return tout, jout, tp, jp, shifts


@pytest.fixture(scope="module")
def benchmark_solves():
    """Both packages' Newton in the benchmark configuration: ``G =
    lowrank(1000·B)``, closed-loop shifts ``PerStepHeuristic(10, 12, 12)``."""
    jp, tp, _, _ = _problems(1000.0)
    obs = _Events()
    before = k1.launches
    tout = tcomp.solve_gare_newton_compiled(
        tp, shifts=tcomp.PerStepHeuristic(10, 12, 12), cfg=CFG, capacity=CAPACITY,
        reltol=1e-10, observer=obs)
    assert k1.launches == before  # CPU tensors take the plain version
    jout = jcomp.solve_gare_newton_compiled(
        jp, shifts=jcomp.PerStepHeuristic(10, 12, 12), cfg=CFG_J, capacity=CAPACITY,
        reltol=1e-10)
    return tout, jout, tp, jp, obs


@pytest.mark.parametrize("theta", [1.0, 1e-3])
def test_residual_gare_lowrank_matches_jax(theta):
    jp, tp, _, _ = _problems(1000.0)
    Xt, Xj = _lr_pair(np.random.default_rng(3), 16, 12)
    Gt = tlr.LowRank(L=tp.G.L, D=theta * tp.G.D, k=tp.G.k)
    Gj = jlr.LowRank(L=jp.G.L, D=theta * jp.G.D, k=jp.G.k)
    got = residual_gare_lowrank(tp.E, tp.A, Gt, tp.Q, Xt, r_out=40)
    ref = jres.residual_gare_lowrank(jp.E, jp.A, Gj, jp.Q, Xj, r_out=40)
    assert got.k == int(ref.k) and got.r == ref.L.shape[1]
    assert _rel(tlr.lr_to_dense(got).numpy(), jlr.lr_to_dense(ref)) <= 1e-12


SHIFT_SETS = {
    "real": [-1.0, -2.0, -3.0],
    "complex_adjacent": [-1.0, -2.0 + 1.0j, -2.0 - 1.0j, -3.0],
    "complex_split": [-1.0 + 0.5j, -3.0, -1.0 - 0.5j],
    "odd_length": [-1.0 + 0.5j, -1.0 - 0.5j, -2.0, -3.0 + 2.0j, -3.0 - 2.0j],
    "all_complex": [-1.0 + 0.5j, -1.0 - 0.5j, -2.0 + 1.0j, -2.0 - 1.0j],
}
MODES = {"default": {}, "pair_encode": {"pair_encode": True}, "real_only": {"real_only": True}}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", SHIFT_SETS)
def test_shift_buffer_matches_jax(name, mode):
    sv = SHIFT_SETS[name]
    for tdt, jdt in ((torch.float64, jnp.float64), (torch.float32, jnp.float32)):
        for nshifts in (2, 3, 5, 6, 9):
            got = tcomp._shift_buffer(sv, tdt, nshifts, **MODES[mode])
            ref = np.asarray(jcomp._shift_buffer(sv, jdt, nshifts, **MODES[mode]))
            assert isinstance(got, np.ndarray)
            assert got.dtype == ref.dtype and got.shape == ref.shape, (nshifts, got, ref)
            np.testing.assert_array_equal(got, ref)
            tcomp.check_shift_pairing(got)


@pytest.mark.parametrize("lam", [0.5, 1.0 / 64.0])
def test_linesearch_combine_matches_jax(lam):
    rng = np.random.default_rng(11)
    Pt, Pj = _lr_pair(rng, 16, 12)
    Tt, Tj = _lr_pair(rng, 16, 10)
    got = tcomp._linesearch_combine(Pt, Tt, lam, 16)
    ref = jcomp._linesearch_combine(Pj, Tj, lam, 16)
    assert got.r == 16 and got.k == int(ref.k)
    assert _rel(tlr.lr_to_dense(got).numpy(), jlr.lr_to_dense(ref)) <= 1e-12


def test_newton_fixed_shifts_matches_jax(fixed_shift_solves):
    tout, jout, tp, jp, _ = fixed_shift_solves
    _check_solve(tout, jout, tp, jp)
    assert tout[1]["thetas"] == [] and tout[1]["shift_rebuilds"] == 0
    h = tout[1]["residuals"]
    assert h[-1] <= tout[1]["abstol"] and h[-1] < 0.02 * h[-2]


def test_newton_benchmark_config_matches_jax(benchmark_solves):
    tout, jout, tp, jp, _ = benchmark_solves
    it, ij = tout[1], jout[1]
    np.testing.assert_allclose(it["sigma"], ij["sigma"], rtol=1e-12)
    assert len(it["thetas"]) == len(ij["thetas"])
    np.testing.assert_allclose(it["thetas"], ij["thetas"], rtol=1e-12)
    np.testing.assert_allclose(it["linesearch_lams"], ij["linesearch_lams"], rtol=1e-12)
    assert it["sigma"] > 4.0 and it["thetas"][-1] == 1.0
    _check_solve(tout, jout, tp, jp)
    # the independent residual of the unscaled result
    rel = float(tlr.lr_norm(residual_gare_lowrank(tp.E, tp.A, tp.G, tp.Q, tout[0]))
                / tlr.lr_norm(tp.Q))
    assert rel < 1e-9


def test_newton_observer_events(benchmark_solves):
    tout, _, _, _, obs = benchmark_solves
    info = tout[1]
    steps = [e for e in obs.events if isinstance(e, tuple)]
    assert obs.events[0] == "start" and obs.events[-1] == "done"
    # a stage that converges reports its step again as the next stage's start
    idx = [s[1] for s in steps]
    assert idx == sorted(idx) and set(idx) == set(range(info["newton_steps"] + 1))
    assert [s[2] for s in steps] == info["residuals"]
    assert obs.events.count("continuation") == 1
    assert obs.events.count("line search") == len(info["linesearch_lams"])


def test_newton_block_ell_matches_dia(fixed_shift_solves):
    """The same fixed-shift solve on a block-ELL pencil (bs=32, K2's plain
    version on the CPU): the block-Jacobi blocks differ from the banded
    path's 128-wide ones, so only the solution is compared."""
    (X_dia, info_dia), _, tp, _, shifts = fixed_shift_solves
    E, A, _, _ = rail_surrogate(N)
    bE, bA = tsparse.bell_pencil(E, A, bs=32, device="cpu")
    X, info = tcomp.solve_gare_newton_compiled(
        GAREProblem(bE, bA, tp.G, tp.Q), shifts=shifts, cfg=CFG,
        capacity=CAPACITY, reltol=1e-11)
    assert info["converged"]
    assert _rel(tlr.lr_to_dense(X).numpy(), tlr.lr_to_dense(X_dia).numpy()) <= 1e-9


def test_newton_pair_buffer_matches_real_substitute():
    """A fixed pair-encoded buffer with a conjugate pair runs the stacked
    double step inside Newton; it reaches the same solution as an all-real
    buffer."""
    _, tp, _, _ = _problems(1.0)
    out = {}
    for name, buf in (("pair", tcomp.pair_encode_shifts([-0.5, -1.0 + 0.5j, -1.0 - 0.5j, -2.0])),
                      ("real", np.asarray([-0.5, -1.0, -2.0]))):
        X, info = tcomp.solve_gare_newton_compiled(tp, shifts=buf, cfg=CFG,
                                                   capacity=CAPACITY, reltol=1e-11)
        assert info["converged"], info
        out[name] = tlr.lr_to_dense(X).numpy()
    assert _rel(out["pair"], out["real"]) <= 1e-9


def test_newton_unported_options_raise():
    """The two options that used to raise run now: inner FGMRES under
    the capped compiled ADI (``adi_iters`` -1 a step) and the f32 inner
    core (the ADI's counts); ``tests/test_torch_gmres.py`` and
    ``tests/test_torch_mixed.py`` hold them against the JAX package."""
    from differentialriccatiequations_jl_tpu_torch import GMRES

    _, tp, _, _ = _problems(1.0)
    gmres = GMRES(maxiters=2, warn_convergence=False,
                  preconditioner=tcomp.CappedADI(maxiters=4, r_in=16, capacity=64))
    for kw in ({"inner_gmres": gmres}, {"inner_solve_dtype": "float32"}):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            X, info = tcomp.solve_gare_newton_compiled(
                tp, shifts=np.asarray([-1.0, -2.0]), cfg=CFG, capacity=CAPACITY,
                maxiters=2, **kw)
        assert info["newton_steps"] == 2 and np.isfinite(info["residuals"]).all()
        assert info["residuals"][-1] < info["residuals"][0]
        assert torch.isfinite(X.L).all() and torch.isfinite(X.D).all()
        if "inner_gmres" in kw:
            assert info["adi_iters"] == [-1, -1]
        else:
            assert min(info["adi_iters"]) > 0


def test_newton_maxiters_warns_and_reports():
    """A depth cut ends the solve with a warning, not an exception, and the
    result is finite."""
    _, tp, _, _ = _problems(1000.0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        X, info = tcomp.solve_gare_newton_compiled(
            tp, shifts=tcomp.PerStepHeuristic(10, 12, 12), cfg=CFG, capacity=CAPACITY,
            maxiters=3, reltol=1e-10)
    assert not info["converged"] and info["newton_steps"] == 3
    assert len(info["residuals"]) >= 4 and np.isfinite(info["residuals"]).all()
    assert any("did not converge" in str(w.message) for w in caught)
    assert torch.isfinite(X.L).all() and torch.isfinite(X.D).all()

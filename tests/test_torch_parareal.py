"""Parareal and the row-sharded products: the port against the JAX package
on the same numpy inputs, f64 on the CPU.

Parareal runs `tests/test_parareal.py`'s configuration (the n=96 Rail
surrogate, 6 steps of τ = 20, the real parts of 8 Penzl shifts, capacity 96,
`CompiledConfig(60, 10, 48)`, abstol 1e-13), so the JAX compiles come from
the persistent cache.  Held: every K and boundary within 1e-9 relative (the
Krylov tolerance amplified by the ADI, as the compiled steps); equal
iterations, stop reasons, ADI iterations of the final sweep and of all
sweeps; the boundary updates ("deltas") within 1e-6 relative where they lie
above √eps·‖X(T)‖.  A delta is the Gram-form norm `lr_norm` of a difference
of nearly equal states, whose rounding floor is about √eps of the states'
norm (bench.py:1044-1048): below it the value follows the summation order.
The port's parareal with ``max_iters = slabs`` reproduces its own serial
sweep (classical exactness, 1e-8 as `tests/test_parareal.py` holds it).

The row-sharded DIA and block-ELL products (emulated shards, one process)
against the JAX package's sharded products on conftest's 8 virtual devices
(`tests/test_sharded_spmm.py`'s n = 1024, bs = 16), within 1e-12.
"""

import importlib
import warnings

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as sspla
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import differentialriccatiequations_jl_tpu_torch as T  # noqa: E402
from differentialriccatiequations_jl_tpu.models.shifts import heuristic_shifts_host  # noqa: E402
from differentialriccatiequations_jl_tpu.ops import dia as jdia  # noqa: E402
from differentialriccatiequations_jl_tpu.ops import sparse as jsparse  # noqa: E402
from differentialriccatiequations_jl_tpu_torch import convert  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models.compiled import (  # noqa: E402
    CompiledConfig, solve_gdre_ros1_compiled)
from differentialriccatiequations_jl_tpu_torch.models.parareal import (  # noqa: E402
    solve_gdre_parareal)
from differentialriccatiequations_jl_tpu_torch.ops.dia import dia_pencil, is_banded  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops.sparse import bell_pencil  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.parallel.mesh import shard_operator  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.parallel.sharded_ops import (  # noqa: E402
    ShardedBellSpmm)
from differentialriccatiequations_jl_tpu_torch.utils.callbacks import Observer  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate  # noqa: E402

jlr = importlib.import_module("differentialriccatiequations_jl_tpu.lowrank")
jcomp = importlib.import_module("differentialriccatiequations_jl_tpu.models.compiled")
jpar = importlib.import_module("differentialriccatiequations_jl_tpu.models.parareal")
jprobs = importlib.import_module("differentialriccatiequations_jl_tpu.models.problems")
jmesh = importlib.import_module("differentialriccatiequations_jl_tpu.parallel.mesh")
jsh = importlib.import_module("differentialriccatiequations_jl_tpu.parallel.sharded_ops")

N, NSTEPS, TAU, CAP = 96, 6, 20.0, 96
CFG = CompiledConfig(maxiters=60, compression_interval=10, r_res=48)
RTOL = 1e-9
DELTA_RTOL = 1e-6
SHARD_TOL = 1e-12


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # Beside the JAX package's CPU thread pool, torch's own pool slows the
    # small products down; never raise the count again (MKL stalls).
    torch.set_num_threads(1)


def _inputs(nsteps=NSTEPS):
    E, A, B, C = rail_surrogate(N)
    sv = heuristic_shifts_host(E, A, 8, 10, 10)
    shifts = np.asarray([s.real for s in sv])
    L0 = sspla.splu(E.tocsc()).solve(np.asarray(C).T.copy())
    return E, A, B, C, L0, shifts, (4500.0, 4500.0 - TAU * nsteps)


def _port_problem(nsteps=NSTEPS):
    E, A, B, C, L0, shifts, tspan = _inputs(nsteps)
    tE, tA = dia_pencil(E, A, device="cpu")
    q = C.shape[0]
    X0 = T.lr_with_capacity(T.lowrank(torch.as_tensor(L0),
                                      0.01 * torch.eye(q, dtype=torch.float64)), CAP)
    prob = T.GDREProblem(tE, tA, torch.as_tensor(B), torch.as_tensor(C), X0, tspan)
    return prob, shifts


def _kw(shifts):
    return dict(dt=-TAU, shifts=shifts, cfg=CFG, capacity=CAP, abstol=1e-13)


def _dense(X):
    X = X if isinstance(X, T.LowRank) else T.LowRank(
        L=torch.tensor(np.asarray(X.L)), D=torch.tensor(np.asarray(X.D)), k=int(X.k))
    return (X.L @ X.D @ X.L.T).numpy()


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _info(sol):
    i = sol.parareal_info
    return i["iterations"], i["stopped_by"], sol.adi_iters, i["fine_iters_total"]


@pytest.fixture(scope="module")
def jax_solutions():
    """The JAX package's parareal for (slabs, max_iters) = (3, 3) and
    (3, 2), computed once for the module."""
    E, A, B, C, L0, shifts, tspan = _inputs()
    jE, jA = jdia.dia_pencil(E, A)
    X0 = jlr.lr_with_capacity(jlr.lowrank(jnp.asarray(L0), 0.01 * jnp.eye(C.shape[0])), CAP)
    prob = jprobs.GDREProblem(jE, jA, jnp.asarray(B), jnp.asarray(C), X0, tspan)
    cfg = jcomp.CompiledConfig(maxiters=60, compression_interval=10, r_res=48)
    return {(S, K): jpar.solve_gdre_parareal(
        prob, dt=-TAU, shifts=jnp.asarray(shifts), cfg=cfg, capacity=CAP, abstol=1e-13,
        alg=jpar.Parareal(slabs=S, max_iters=K)) for S, K in ((3, 3), (3, 2))}


@pytest.fixture(scope="module")
def port():
    return _port_problem()


@pytest.mark.parametrize("slabs,max_iters", [(3, 3), (3, 2)])
def test_parareal_matches_jax(jax_solutions, port, slabs, max_iters):
    """Same K trajectory, boundaries, counts and boundary updates as the
    JAX package's vmapped fine sweep: the port's loop over the slabs gives
    each slab its own ADI count, as JAX's batched while-loop does."""
    js = jax_solutions[(slabs, max_iters)]
    prob, shifts = port
    alg = convert.config_from(jpar.Parareal(slabs=slabs, max_iters=max_iters))
    ts = solve_gdre_parareal(prob, alg=alg, **_kw(shifts))
    assert _info(ts) == (js.parareal_info["iterations"], js.parareal_info["stopped_by"],
                         js.adi_iters, js.parareal_info["fine_iters_total"])
    assert len(ts.K) == len(js.K) == NSTEPS + 1 and len(ts.X) == slabs + 1
    assert max(_rel(t, j) for t, j in zip(ts.K[1:], js.K[1:])) < RTOL
    assert max(_rel(_dense(t), _dense(j)) for t, j in zip(ts.X, js.X)) < RTOL
    assert ts.parareal_info["boundary_times"] == js.parareal_info["boundary_times"]
    dt, dj = ts.parareal_info["deltas"], js.parareal_info["deltas"]
    floor = np.sqrt(np.finfo(np.float64).eps) * float(T.lr_norm(ts.X[-1]))
    assert len(dt) == len(dj) and dt[0] == pytest.approx(dj[0], rel=DELTA_RTOL)
    for a, b in zip(dt, dj):
        if b > floor:
            assert a == pytest.approx(b, rel=DELTA_RTOL)
        else:
            assert a <= 10 * floor
    assert ts.adi_res_max == pytest.approx(js.adi_res_max, rel=1e-6, abs=1e-13)


def test_parareal_reproduces_serial_fine_sweep(port):
    """max_iters = slabs ⇒ every slab boundary is the fine value, so the
    trajectory is the port's serial compiled Ros1 sweep
    (`tests/test_parareal.py:58-71`)."""
    prob, shifts = port
    ref = solve_gdre_ros1_compiled(prob, **_kw(shifts))
    sol = solve_gdre_parareal(prob, alg=T.Parareal(slabs=3, max_iters=3), **_kw(shifts))
    assert len(sol.K) == len(ref.K) and sol.parareal_info["iterations"] <= 3
    assert max(_rel(a, b) for a, b in zip(sol.K[1:], ref.K[1:])) < 1e-8
    assert _rel(_dense(sol.X[-1]), _dense(ref.X[-1])) < 1e-8
    d = sol.parareal_info["deltas"]
    assert all(b < a for a, b in zip(d, d[1:]))  # the updates contract


def test_parareal_stop_reasons(port):
    """`tests/test_parareal.py:88-117`: a tolerance stop, a plateau stop
    (with its warning) or max_iters, and no plateau stop from one slow
    iteration."""
    prob, shifts = port
    kw = _kw(shifts)
    sol = solve_gdre_parareal(prob, alg=T.Parareal(slabs=3, reltol=1e-2), **kw)
    assert sol.parareal_info["stopped_by"] == "reltol"
    with warnings.catch_warnings(record=True) as wlist:
        warnings.simplefilter("always")
        sol2 = solve_gdre_parareal(prob, alg=T.Parareal(slabs=3, max_iters=3, reltol=1e-30,
                                                        plateau_factor=0.5), **kw)
    assert sol2.parareal_info["stopped_by"] in ("plateau", "max_iters")
    if sol2.parareal_info["stopped_by"] == "plateau":
        assert any("plateau" in str(w.message) for w in wlist)
    sol3 = solve_gdre_parareal(prob, alg=T.Parareal(slabs=3, max_iters=2, reltol=1e-30,
                                                    plateau_factor=0.99), **kw)
    assert sol3.parareal_info["iterations"] == 2
    # A plateau stop forced by a factor no delta ratio can stay under.
    with pytest.warns(UserWarning, match="plateau"):
        sol4 = solve_gdre_parareal(prob, alg=T.Parareal(slabs=3, max_iters=3, reltol=1e-30,
                                                        plateau_factor=0.0), **kw)
    assert sol4.parareal_info["stopped_by"] == "plateau"
    assert sol4.parareal_info["iterations"] == 3
    with pytest.raises(ValueError, match="not divisible by slabs=4"):
        solve_gdre_parareal(prob, alg=T.Parareal(slabs=4), **kw)


def test_parareal_solve_dispatch_and_save_state():
    """`solve` dispatches a low-rank GDRE with `Parareal`; with
    ``save_state`` the states are aligned with ``t`` and end at the last
    boundary; the events arrive in order."""
    prob, shifts = _port_problem(nsteps=4)
    kw = dict(dt=-TAU, shifts=shifts, cfg=CFG, capacity=CAP, abstol=1e-13)
    sol = T.solve(prob, T.Parareal(slabs=2, max_iters=2), **kw)
    assert sol.parareal_info["slabs"] == 2 and sol.parareal_info["n_fine"] == 2
    assert len(sol.X) == 3 and len(sol.K) == len(sol.t) == 5

    class Events(Observer):
        def __init__(self):
            self.seen = []

        def observe_gdre_start(self, prob, alg):
            self.seen.append("start")

        def observe_gdre_step(self, t, X, K):
            self.seen.append("step")

        def observe_gdre_done(self):
            self.seen.append("done")

    ev = Events()
    full = T.solve(prob, T.Parareal(slabs=2, max_iters=2), save_state=True, observer=ev, **kw)
    assert len(full.X) == len(full.t) == 5
    assert ev.seen == ["start"] + ["step"] * full.parareal_info["iterations"] + ["done"]
    for s, i in ((1, 2), (2, 4)):  # boundary s is the state at t[s·n_fine]
        assert _rel(_dense(full.X[i]), _dense(sol.X[s])) < 1e-12
    assert max(_rel(a, b) for a, b in zip(full.K, sol.K)) < 1e-12


@pytest.fixture(scope="module")
def sharded_inputs():
    n = 1024
    E, A, _, _ = rail_surrogate(n)
    X = np.random.default_rng(0).standard_normal((n, 5))
    return E, A, X


def test_sharded_dia_matches_jax(sharded_inputs):
    """`shard_operator` + the local DIA product on the halo-extended
    operand, 8 shards, against the JAX package's `_dia_mm_halo` (``mm`` and
    ``tmm`` of a `DiaOp` with a mesh); `is_banded` as the JAX package's."""
    E, A, X = sharded_inputs
    wide = sp.random(64, 64, density=0.5, random_state=np.random.default_rng(2), format="csr")
    for M in (A, wide, X):
        assert is_banded(M) == jdia.is_banded(M)
    assert is_banded(A) and not is_banded(wide)
    mesh = jmesh.make_mesh(8)
    jE, jA = jdia.dia_pencil(E, A, mesh=mesh, pad_to=8)
    _, tA = dia_pencil(E, A, device="cpu")
    Xt = torch.as_tensor(X)
    shards = [shard_operator(None, tA, rank=r, world=8) for r in range(8)]
    for t, jprod in ((False, jA.mm), (True, jA.tmm)):
        Y = torch.cat([s.local_mm(s.extend(Xt), t=t) for s in shards]).numpy()
        Yj = np.asarray(jprod(jnp.asarray(X)))
        assert _rel(Y, Yj) < SHARD_TOL
        assert _rel(Y, (A.T if t else A) @ X) < SHARD_TOL


def test_sharded_bell_matches_jax(sharded_inputs):
    """`ShardedBellSpmm` (8 emulated shards of 8 block rows, bs = 16) against
    the JAX package's `ShardedBellSpmm` on 8 virtual devices, ``AX``,
    ``AᵀX`` and a 1-D right-hand side."""
    E, A, X = sharded_inputs
    mesh = jmesh.make_mesh(8)
    _, jA = jsparse.bell_pencil(E, A, bs=16)
    _, tA = bell_pencil(E, A, bs=16, device="cpu")
    v = np.random.default_rng(1).standard_normal(X.shape[0])
    for transpose in (False, True):
        shards = [ShardedBellSpmm(None, tA, transpose=transpose, rank=r, world=8)
                  for r in range(8)]
        jmm = jsh.ShardedBellSpmm(mesh, jA, transpose=transpose)
        for rhs in (X, v):
            R = torch.as_tensor(rhs if rhs.ndim == 2 else rhs[:, None])
            Y = torch.cat([s.local_mm(s.extend(R)) for s in shards]).numpy()
            Yj = np.asarray(jmm(jnp.asarray(rhs))).reshape(Y.shape)
            assert _rel(Y, Yj) < SHARD_TOL
            assert _rel(Y, ((A.T if transpose else A) @ rhs).reshape(Y.shape)) < SHARD_TOL

"""The row-sharded compiled steps over real process groups: the TSQR
compression, the Gram norms, the dry run's Ros1 and Newton steps and the
Ros1 sweep, against one process and against the JAX package.  Its spawned
ranks import this file, so it imports no JAX at its top: the two tests
that hold the ranks' results to the JAX package import it in their bodies
(and skip where it is missing, as on a host without it).

One spawn of 2 gloo ranks at n = 256 (`sharded_runs`, 128 rows a rank)
runs, each on row-sharded operands and in one process:

* `lr_compress` of a residual-shaped factor (q + 2r = 198 columns, wider
  than a shard's 128 rows, 150 of them active) and of a narrow one (48
  columns): LDLᵀ within 1e-12, equal ranks;
* `lr_norm` and `lr_dot`: within 1e-12;
* the lane-major product `ShardedDiaOp.mmT` (a halo exchange of columns)
  of `A` and of its adjoint, split in 128-row blocks and in single rows:
  within 1e-12 of `DiaOp.mmT`;
* the JAX dry run's pair-buffer Ros1 step, its Newton step and the JAX
  package's Ros1 sweep test (`tests/test_sharded_gdre.py:140-153`): equal
  ADI iterations, Krylov iterations within 2 %, every K and the final X
  within 1e-10 (`tests/test_sharded_gdre.py:170-175`);
* the same sweep and Newton step against the JAX package's one-device
  ``solve_gdre_ros1_compiled`` (at ``tests/test_sharded_gdre.py:140-153``'s
  configuration) and ``_newton_step_compiled`` (at the dry run's, its
  ``parallel/dryrun.py:82-100``), run in this process on the same numpy
  inputs: equal ADI iterations, every K and LDLᵀ within 1e-9 (the Krylov
  tolerance 10·eps amplified by the ADI, as the port's one-process steps
  are held to the JAX package).

The validation errors, the identity of the reductions without a mesh, the
refusal of a sharded product (DIA and block-ELL) outside its mesh and the
spawner's deadline need no group.  A ``cuda`` test runs the sweep at
n = 1357 over a world-size-1 NCCL group on the card.
"""

import dataclasses
import functools
import importlib
import time

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

from differentialriccatiequations_jl_tpu_torch.lowrank import (
    LowRank, lr_compress, lr_dot, lr_norm)
from differentialriccatiequations_jl_tpu_torch.models.compiled import (
    PREC_BS, build_dia_shift_ops, build_step_shift_solvers)
from differentialriccatiequations_jl_tpu_torch.ops.dia import dia_pencil
from differentialriccatiequations_jl_tpu_torch.ops.sparse import bell_pencil
from differentialriccatiequations_jl_tpu_torch.ops.operators import lr_update
from differentialriccatiequations_jl_tpu_torch.parallel import dryrun
from differentialriccatiequations_jl_tpu_torch.parallel.mesh import (
    make_mesh, row_allgather, row_allreduce, row_norm, shard_lowrank, shard_operator,
    unshard_tall, use_mesh)
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate

N = 256
COMPRESS_TOL = 1e-12
STEP_TOL = 1e-10
KRYLOV_TOL = 0.02
JAX_TOL = 1e-9


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _factor(n, r, k, seed):
    """An ``(n, r)`` factor with ``k`` active columns of decaying scale
    (so the cut drops some) and a symmetric indefinite ``D``."""
    rng = np.random.default_rng(seed)
    L = np.zeros((n, r))
    L[:, :k] = rng.standard_normal((n, k)) * np.logspace(0, -20, k)
    D = np.zeros((r, r))
    S = rng.standard_normal((k, k))
    D[:k, :k] = S + S.T
    return LowRank(L=torch.as_tensor(L), D=torch.as_tensor(D), k=k)


def _dense(X):
    return (X.L @ X.D @ X.L.T).cpu().numpy()


def _compressions(mesh):
    """Each factor compressed on its shards and whole: (LDLᵀ difference,
    ranks sharded and whole, the smallest shard's rows, the width)."""
    out = []
    for r, k, seed in ((198, 150, 1), (48, 40, 2)):
        X = _factor(N, r, k, seed)
        with use_mesh(mesh):
            Y_l = lr_compress(shard_lowrank(mesh, X, PREC_BS))
        Y = LowRank(L=unshard_tall(mesh, Y_l.L, N, PREC_BS), D=Y_l.D, k=Y_l.k)
        ref = lr_compress(X)
        out.append((_rel(_dense(Y), _dense(ref)), Y.k, ref.k, Y_l.L.shape[0], r))
    return out


def _norms(mesh):
    X, Y = _factor(N, 48, 40, 3), _factor(N, 48, 30, 4)
    with use_mesh(mesh):
        Xl, Yl = shard_lowrank(mesh, X, PREC_BS), shard_lowrank(mesh, Y, PREC_BS)
        got = (float(lr_norm(Xl)), float(lr_dot(Xl, Yl)))
    return got, (float(lr_norm(X)), float(lr_dot(X, Y)))


def _lane_major_products(mesh):
    """``mmT`` of the shards of ``A`` and ``Aᵀ`` (block splits 128 and 1)
    against the whole operator's: {(operator, block): relative
    difference}."""
    E, A, _, _ = rail_surrogate(N)
    _, A_op = dia_pencil(E, A, device="cpu")
    Xt = torch.as_tensor(np.random.default_rng(6).standard_normal((7, N)))
    out = {}
    for name, op in (("A", A_op), ("At", A_op.adjoint())):
        for block in (PREC_BS, 1):
            sh = shard_operator(mesh, op, block=block)
            with use_mesh(mesh):
                Y_l = sh.mmT(Xt[:, sh.rows[0]:sh.rows[1]].contiguous())
            Y = unshard_tall(mesh, Y_l.T.contiguous(), N, block).T
            out[(name, block)] = _rel(Y, op.mmT(Xt))
    return out


def _numpy(run):
    X, K, *counts = run
    Ks = K if isinstance(K, list) else [K]
    return (_dense(X), [k.cpu().numpy() for k in Ks], *counts)


def sharded_runs(dev, n=N, reference=True):
    """A rank's runs (see the module docstring); with ``reference`` also
    the pair-buffer Ros1 step, and each run in one process.  Returns numpy
    results."""
    mesh = make_mesh(device=dev.type)
    runs = {"sweep": dryrun.ros1_sweep, "newton": dryrun.newton_step_sharded}
    if reference:
        runs["ros1"] = dryrun.ros1_step_sharded
    out = {name: _numpy(run(dev, n, mesh)) for name, run in runs.items()}
    if reference:
        out.update({name + "_ref": _numpy(run(dev, n)) for name, run in runs.items()})
        out["compress"] = _compressions(mesh)
        out["norms"] = _norms(mesh)
        out["mmT"] = _lane_major_products(mesh)
    return out


@pytest.fixture(scope="module")
def runs():
    torch.set_num_threads(1)
    return dryrun.run_ranks(sharded_runs, 2, "cpu")


@pytest.mark.parametrize("case", [0, 1], ids=["shard_narrower_than_factor", "narrow_factor"])
def test_tsqr_compress_matches_plain(runs, case):
    """A 198-column factor on 128-row shards, and a 48-column one."""
    diff, k, k_ref, rows, width = runs["compress"][case]
    assert k == k_ref and 0 < k < width
    assert diff <= COMPRESS_TOL
    assert (rows < width) == (case == 0)


@pytest.mark.parametrize("op", ["A", "At"])
@pytest.mark.parametrize("block", [PREC_BS, 1])
def test_lane_major_sharded_product(runs, op, block):
    assert runs["mmT"][(op, block)] <= COMPRESS_TOL


@pytest.mark.parametrize("case", [0, 1], ids=["lr_norm", "lr_dot"])
def test_gram_norms_match_plain(runs, case):
    got, ref = runs["norms"]
    assert got[case] == pytest.approx(ref[case], rel=COMPRESS_TOL)


@pytest.mark.parametrize("name", ["ros1", "newton", "sweep"])
def test_sharded_step_matches_one_process(runs, name):
    """Equal ADI iterations, Krylov iterations within 2 %, X and every K
    within 1e-10."""
    X, Ks, adi, *rest = runs[name]
    Xr, Ksr, adir, *rest_ref = runs[name + "_ref"]
    kry, kry_ref = rest[-1], rest_ref[-1]
    assert adi == adir and abs(kry - kry_ref) <= KRYLOV_TOL * kry_ref
    assert _rel(X, Xr) <= STEP_TOL
    assert len(Ks) == len(Ksr)
    assert max(_rel(a, b) for a, b in zip(Ks, Ksr)) <= STEP_TOL


def test_shard_split_validation():
    """The compiled steps need whole 128-row blocks on every rank and no
    empty shard."""
    E, A, _, _ = rail_surrogate(300)
    E_op, A_op = dia_pencil(E, A, device="cpu")
    cut = shard_operator(None, A_op, rank=0, world=2)  # rows [0, 150)
    with pytest.raises(ValueError, match="cut a 128-row block"):
        cut.diag_blocks(PREC_BS)
    with pytest.raises(ValueError, match="cut a 128-row block"):
        build_dia_shift_ops(cut, cut, np.asarray([-1.0]))
    with pytest.raises(ValueError, match="last shard would be empty"):
        shard_operator(None, A_op, rank=0, world=4, block=PREC_BS)
    whole = shard_operator(None, A_op, rank=1, world=2, block=PREC_BS)  # [256, 300)
    assert whole.rows == (256, 300) and whole.N == 44 and whole.shape == (300, 300)
    assert torch.equal(whole.diag_blocks(PREC_BS), A_op.diag_blocks(PREC_BS)[2:])


def test_reductions_are_the_identity_without_a_mesh():
    t = torch.arange(6, dtype=torch.float64).reshape(2, 3)
    assert row_allreduce(t) is t
    assert row_allgather(t) == [t]
    assert torch.equal(row_norm(t), torch.linalg.norm(t))


def _hang(dev):
    """Rank 0 enters an all-reduce that rank 1 never joins."""
    import torch.distributed as dist

    if dist.get_rank() == 0:
        dist.all_reduce(torch.zeros(1))
    else:
        time.sleep(600)


def test_spawn_deadline_stops_the_ranks():
    """A rank that never joins a collective fails the spawn within its
    deadline, and no rank outlives it."""
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="still running"):
        dryrun.run_ranks(_hang, 2, "cpu", deadline=3)
    assert time.monotonic() - t0 < 30


@pytest.mark.cuda
def test_world_size_one_nccl_sweep_on_the_card():
    """The Ros1 sweep at n = 1357 on the card over a world-size-1 NCCL
    group against the same sweep without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = dryrun.run_ranks(sharded_runs, 1, "cuda", args=(1357, False))
    ref = _numpy(dryrun.ros1_sweep(torch.device("cuda"), 1357))
    X, Ks, adi, kry = out["sweep"]
    assert adi == ref[2] and abs(kry - ref[3]) <= KRYLOV_TOL * ref[3]
    assert _rel(X, ref[0]) <= STEP_TOL
    assert max(_rel(a, b) for a, b in zip(Ks, ref[1])) <= STEP_TOL


def _jax():
    """The JAX package's modules (the test skips without JAX)."""
    pytest.importorskip("jax")
    name = "differentialriccatiequations_jl_tpu."
    return {m: importlib.import_module(name + m) for m in
            ("lowrank", "models.compiled", "models.problems", "models.residuals",
             "models.shifts", "ops.dia")}


def _jax_pencil():
    E, A, B, C = rail_surrogate(N)
    return E, A, B, C, spla.splu(E.tocsc()).solve(np.asarray(C).T.copy())


def test_sharded_sweep_matches_jax(runs):
    """The ranks' sweep against the JAX package's one-device sweep."""
    j = _jax()
    import jax.numpy as jnp

    jlr, jcomp = j["lowrank"], j["models.compiled"]
    E, A, B, C, L0 = _jax_pencil()
    jE, jA = j["ops.dia"].dia_pencil(E, A, pad_to=8)
    shifts = jnp.asarray([s.real for s in j["models.shifts"].heuristic_shifts_host(
        E, A, 8, 10, 10)])
    X0 = jlr.lr_with_capacity(jlr.lowrank(jnp.asarray(L0), 0.01 * jnp.eye(C.shape[0])), 96)
    prob = j["models.problems"].GDREProblem(jE, jA, jnp.asarray(B), jnp.asarray(C), X0,
                                            (4500.0, 4440.0))
    sol = jcomp.solve_gdre_ros1_compiled(
        prob, dt=-20.0, shifts=shifts, cfg=jcomp.CompiledConfig(60, 10, 48), capacity=96,
        abstol=1e-12)
    X, Ks, adi, _ = runs["sweep"]
    assert adi == sol.adi_iters
    assert len(Ks) == len(sol.K)
    assert max(_rel(a, np.asarray(b)) for a, b in zip(Ks, sol.K)) <= JAX_TOL
    assert _rel(X, np.asarray(jlr.lr_to_dense(sol.X[-1]))) <= JAX_TOL


def test_sharded_newton_step_matches_jax(runs):
    """The ranks' Newton step against the JAX package's one-device step."""
    j = _jax()
    import jax.numpy as jnp

    jlr, jcomp = j["lowrank"], j["models.compiled"]
    E, A, B, C, L0 = _jax_pencil()
    jE, jA = j["ops.dia"].dia_pencil(E, A)
    cfg = jcomp.CompiledConfig(maxiters=8, compression_interval=4, r_res=16)
    shifts = jnp.asarray([-0.5, -1.5, -3.0])
    X0 = jlr.lr_with_capacity(jlr.lowrank(jnp.asarray(L0), 0.01 * jnp.eye(C.shape[0])), 64)
    Bj = jnp.asarray(B)
    G = jlr.lr_with_capacity(jlr.lowrank(Bj), 16)
    Q = jlr.lr_with_capacity(jlr.lowrank(jnp.asarray(np.asarray(C).T)), 16)
    K0 = ((Bj.T @ X0.L) @ X0.D) @ jE.tmm(X0.L).T
    res = j["models.residuals"].residual_gare_lowrank(jE, jA, G, Q, X0, r_out=cfg.r_res)
    lus = jcomp.build_dia_shift_ops(jE, jA, shifts)
    X1, iters, _ = jcomp._newton_step_compiled(jE, jA, Bj, X0, K0, res, shifts,
                                               jnp.asarray(1e-3), cfg, lus)
    K1 = ((Bj.T @ X1.L) @ X1.D) @ jE.tmm(X1.L).T
    X, (K,), adi, _, _ = runs["newton"]
    assert adi == int(iters)
    assert _rel(X, np.asarray(jlr.lr_to_dense(X1))) <= JAX_TOL
    assert _rel(K, np.asarray(K1)) <= JAX_TOL


@pytest.mark.parametrize("fmt", ["dia", "bell"])
def test_sharded_products_need_their_mesh(fmt):
    """A product of a row shard (DIA, or block-ELL in 128-row blocks)
    raises outside ``use_mesh(its mesh)``, also inside a solver or a
    low-rank update, before any collective: there the reductions around it
    would sum one rank alone."""
    E, A, B, _ = rail_surrogate(N)
    pencil = dia_pencil if fmt == "dia" else functools.partial(bell_pencil, bs=PREC_BS)
    E_op, A_op = pencil(E, A, device="cpu")
    mesh = object()  # stands for the shards' mesh: nothing reaches a group
    E_s, A_s = (dataclasses.replace(shard_operator(None, op, rank=0, world=1, block=PREC_BS),
                                    mesh=mesh) for op in (E_op, A_op))
    lus = build_step_shift_solvers(E_s, A_s, np.asarray([-1.0]))
    X = torch.ones((N, 2), dtype=torch.float64)
    F = lr_update(A_s, -1.0, torch.as_tensor(B), torch.ones((B.shape[1], N),
                                                           dtype=torch.float64))
    calls = (lambda: A_s.mm(X), lambda: lus.core_solver(0).solve(X), lambda: F.mm(X))
    for call in calls:
        with pytest.raises(RuntimeError, match="outside use_mesh"):
            call()
    with use_mesh(object()), pytest.raises(RuntimeError, match="outside use_mesh"):
        A_s.tmm(X)  # under another mesh

"""The block-ELL row shards, Ros2 on shards, the sharded f32 refined core
and GMRES over a mesh, on real process groups against one process and
against the JAX package.  Its spawned ranks import this file, so it
imports no JAX at its top: the tests that hold the ranks' results to the
JAX package import it in their bodies (and skip where it is missing).

Two spawns of 2 gloo ranks each (`sharded_runs`, started together) run,
each on row shards and in one process:

* the block-ELL Ros1 and Ros2 sweeps at ``tests/test_torch_ros2.py``'s
  configuration (`dryrun.SWEEP`: n = 96 in 16-row blocks, 3 per rank;
  τ = 10, 3 steps, capacity 64, 8 Penzl shifts), whose JAX compiles are
  then already in the persistent cache;
* at n = 256 (128 rows a rank): the Ros2 sweep on DIA shards (2 steps),
  `lr_compress(method="gram")` of an f64 and of an f32 factor, the compiled
  GALE with an f32 Krylov core on DIA shards, refined f32 solves
  (`Krylov(solve_dtype="float32", refine_iters=3)`) on a shifted DIA and
  a shifted block-ELL operator, and `Krylov(method="gmres")` on the
  shifted DIA operator.

Each is held to one process: equal ADI iterations, Krylov iterations
within 2 %, K, LDLᵀ and solutions within 1e-10 (the f32 factor's
compression within 1e-5, the f32 Gram matrix's sums taken in another
order).  The two block-ELL sweeps are also held to the JAX package's
one-device sweeps on the same numpy inputs: within 1e-9, equal ADI
iterations.  Tests without a group: the emulated shards' block-Jacobi
blocks, and the algebra that keeps a shard.  A ``cuda`` test runs the
block-ELL Ros2 sweep at n = 1357 over a world-size-1 NCCL group on the
card.
"""

import dataclasses
import importlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from differentialriccatiequations_jl_tpu_torch.lowrank import LowRank, _mask_cols, lr_norm
from differentialriccatiequations_jl_tpu_torch.models.compiled import (
    CompiledConfig, adi_compiled, build_dia_shift_ops, default_dia_krylov)
from differentialriccatiequations_jl_tpu_torch.models.residuals import residual_gale_lowrank
from differentialriccatiequations_jl_tpu_torch.models.shifts import heuristic_shifts_host
from differentialriccatiequations_jl_tpu_torch.ops.blocklinear import Krylov
from differentialriccatiequations_jl_tpu_torch.ops.dia import dia_pencil, shifted_dia
from differentialriccatiequations_jl_tpu_torch.ops.operators import lin_comb, op_astype
from differentialriccatiequations_jl_tpu_torch.ops.sparse import (
    bell_lin_comb, bell_pencil, bell_scale, shifted_bell)
from differentialriccatiequations_jl_tpu_torch.parallel import dryrun
from differentialriccatiequations_jl_tpu_torch.parallel.mesh import (
    make_mesh, shard_lowrank, shard_operator, shard_tall, unshard_tall, use_mesh)
from differentialriccatiequations_jl_tpu_torch.parallel.sharded_ops import ShardedBellOp
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate

N_BELL = 96
N = 256
TOL = 1e-10
F32_TOL = 1e-5
KRYLOV_TOL = 0.02
JAX_TOL = 1e-9
REFINED = Krylov(method="cg", negate=True, preconditioner="block_jacobi",
                 solve_dtype="float32", refine_iters=3)
GMRES = Krylov(method="gmres", restart=20, maxiter=3, negate=True,
               preconditioner="block_jacobi")


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _dense(X):
    return (X.L @ X.D @ X.L.T).double().cpu().numpy()


def _sweep(run):
    X, Ks, adi, kry = run
    return _dense(X), [K.cpu().numpy() for K in Ks], adi, kry


def _factor(dtype, seed):
    """A well-conditioned ``(N, 48)`` factor with 40 active columns and a
    symmetric indefinite ``D``."""
    rng = np.random.default_rng(seed)
    L = np.zeros((N, 48))
    L[:, :40] = rng.standard_normal((N, 40))
    D = np.zeros((48, 48))
    S = rng.standard_normal((40, 40))
    D[:40, :40] = S + S.T
    return LowRank(L=torch.as_tensor(L, dtype=dtype), D=torch.as_tensor(D, dtype=dtype), k=40)


def _gale_f32_core(mesh):
    """The compiled GALE ``AᵀXE + EᵀXA = −CᵀC`` at n = 256 with an f32
    Krylov core (3 refinements) on DIA operands split over ``mesh``: (the
    LDLᵀ gathered, ADI iterations, relative residual, Krylov
    iterations)."""
    E, A, _, C = rail_surrogate(N)
    E_op, A_op = dia_pencil(E, A, device="cpu")
    Ct = torch.as_tensor(np.ascontiguousarray(C.T))
    X0 = LowRank(L=torch.zeros((N, 64), dtype=torch.float64),
                 D=torch.zeros((64, 64), dtype=torch.float64), k=0)
    if mesh is not None:
        E_op, A_op, Ct = (shard_operator(mesh, E_op, block=128),
                          shard_operator(mesh, A_op, block=128), shard_tall(mesh, Ct, 128))
        X0 = shard_lowrank(mesh, X0, 128)
    shifts = np.asarray([v.real for v in heuristic_shifts_host(E, A, 8, 20, 20)])
    kry = dataclasses.replace(default_dia_krylov(torch.float64, False), solve_dtype="float32",
                              refine_iters=3)
    cfg = CompiledConfig(maxiters=60, compression_interval=10, r_res=16)
    with use_mesh(mesh):
        Cf = LowRank(L=Ct, D=torch.eye(Ct.shape[1], dtype=torch.float64), k=Ct.shape[1])
        lus = build_dia_shift_ops(E_op, A_op, shifts, krylov_cfg=kry)
        res0 = residual_gale_lowrank(E_op, A_op, Cf, X0, r_out=cfg.r_res)
        norm_c = float(lr_norm(Cf))
        (X, _, iters, res), kry_iters = dryrun._counted(lambda: adi_compiled(
            E_op, A_op, _mask_cols(res0.L, res0.k), res0.D, res0.k, X0, shifts,
            1e-10 * norm_c, cfg, lus))
        assert lus.prec_inv.dtype == torch.float32
    if mesh is not None:
        X = LowRank(L=unshard_tall(mesh, X.L, N, 128), D=X.D, k=X.k)
    return _dense(X), iters, float(res) / norm_c, kry_iters


def _solves(mesh):
    """The refined f32 solves and the GMRES solve at n = 256: {name:
    (solution, Krylov iterations)}."""
    E, A, _, _ = rail_surrogate(N)
    W = torch.as_tensor(np.random.default_rng(7).standard_normal((N, 4)))
    F_dia = shifted_dia(*dia_pencil(E, A, device="cpu"), -0.01)
    F_bell = shifted_bell(*bell_pencil(E, A, bs=16, device="cpu"), -0.01)
    out = {}
    for name, op, alg in (("refined_dia", F_dia, REFINED), ("refined_bell", F_bell, REFINED),
                          ("gmres", F_dia, GMRES)):
        x, kry = dryrun.solve_sharded(mesh, op, W, alg)
        out[name] = (x.numpy(), kry)
    return out


def _compressions(mesh):
    out = {}
    for name, dtype in (("f64", torch.float64), ("f32", torch.float32)):
        Y = dryrun.compress_sharded(mesh, _factor(dtype, 3))
        out[name] = (_dense(Y), Y.k)
    return out


def sharded_runs(dev, part, n_bell=N_BELL):
    """A rank's runs of ``part``, sharded and in one process (see the
    module docstring): ``"sweeps"`` the block-ELL sweeps at ``n_bell``,
    ``"small"`` the runs at n = 256, ``"card"`` the block-ELL Ros2 sweep
    alone at ``n_bell`` in 128-row blocks.  Returns numpy results."""
    mesh = make_mesh(device=dev.type)
    card = dict(bs=128, capacity=96, cfg=(60, 10, 48))
    runs = {
        "sweeps": {"bell_ros1": lambda m: _sweep(dryrun.bell_sweep(dev, n_bell, m, "ros1")),
                   "bell_ros2": lambda m: _sweep(dryrun.bell_sweep(dev, n_bell, m, "ros2"))},
        "small": {"dia_ros2": lambda m: _sweep(dryrun.ros2_sweep(dev, N, m, nsteps=2)),
                  "gale_f32": _gale_f32_core, "solves": _solves, "gram": _compressions},
        "card": {"bell_ros2": lambda m: _sweep(dryrun.bell_sweep(dev, n_bell, m, "ros2", **card))},
    }[part]
    out = {name: run(mesh) for name, run in runs.items()}
    out.update({name + "_ref": run(None) for name, run in runs.items()})
    return out


@pytest.fixture(scope="module")
def spawned():
    """Both parts' spawns of 2 gloo ranks, started together in the
    background: their collectives mostly wait (on a peer, on a wake-up), so
    the two overlap, and with them the JAX references of the tests that
    take this fixture."""
    with ThreadPoolExecutor(2) as pool:
        yield [pool.submit(dryrun.run_ranks, sharded_runs, 2, "cpu", args=(part,))
               for part in ("sweeps", "small")]


@pytest.fixture(scope="module")
def runs(spawned):
    return {name: out for fut in spawned for name, out in fut.result().items()}


def _jax_sweep(method):
    """The JAX package's one-device block-ELL sweep at `dryrun.SWEEP`."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    name = "differentialriccatiequations_jl_tpu."
    jlr, jcomp, jprob, jsparse = (importlib.import_module(name + m) for m in (
        "lowrank", "models.compiled", "models.problems", "ops.sparse"))
    c = dryrun.SWEEP
    E, A, B, C = rail_surrogate(N_BELL)
    X0 = dryrun.rail_x0(E, C, "cpu", c["capacity"])
    shifts = dryrun.sweep_shifts(E, A, method, c["tau"], c["nshifts"])
    jE, jA = jsparse.bell_pencil(E, A, bs=c["bs"])
    X0j = jlr.LowRank(L=jnp.asarray(X0.L.numpy()), D=jnp.asarray(X0.D.numpy()),
                      k=jnp.asarray(X0.k))
    prob = jprob.GDREProblem(jE, jA, B, C, X0j, (4500.0, 4500.0 - c["nsteps"] * c["tau"]))
    solve = getattr(jcomp, f"solve_gdre_{method}_compiled")
    sol = solve(prob, dt=-c["tau"], shifts=jnp.asarray(shifts),
                cfg=jcomp.CompiledConfig(*c["cfg"]), capacity=c["capacity"])
    return np.asarray(jlr.lr_to_dense(sol.X[-1])), [np.asarray(K) for K in sol.K], sol.adi_iters


@pytest.mark.parametrize("method", ["ros1", "ros2"])
def test_sharded_bell_sweep_matches_jax(spawned, method):
    """The ranks' block-ELL sweep against the JAX package's one-device
    sweep: every K and the final LDLᵀ within 1e-9, equal ADI iterations
    (the reference runs here while the ranks run)."""
    Xj, Ksj, adij = _jax_sweep(method)
    X, Ks, adi, _ = spawned[0].result()["bell_" + method]
    assert adi == int(adij) and len(Ks) == len(Ksj)
    assert max(_rel(a, b) for a, b in zip(Ks, Ksj)) <= JAX_TOL
    assert _rel(X, Xj) <= JAX_TOL


def _hold_sweep(got, ref):
    X, Ks, adi, kry = got
    Xr, Ksr, adir, kryr = ref
    assert adi == adir and abs(kry - kryr) <= KRYLOV_TOL * kryr
    assert len(Ks) == len(Ksr)
    assert max(_rel(a, b) for a, b in zip(Ks, Ksr)) <= TOL
    assert _rel(X, Xr) <= TOL


@pytest.mark.parametrize("name", ["bell_ros1", "bell_ros2", "dia_ros2"])
def test_sharded_sweep_matches_one_process(runs, name):
    """Equal ADI iterations, Krylov iterations within 2 %, every K and the
    final LDLᵀ within 1e-10."""
    _hold_sweep(runs[name], runs[name + "_ref"])


@pytest.mark.parametrize("dtype", ["f64", "f32"])
def test_gram_compress_matches_one_process(runs, dtype):
    (Y, k), (Yr, kr) = runs["gram"][dtype], runs["gram_ref"][dtype]
    assert k == kr == 40
    assert _rel(Y, Yr) <= (TOL if dtype == "f64" else F32_TOL)


def test_compiled_gale_f32_core_matches_one_process(runs):
    X, iters, res, kry = runs["gale_f32"]
    Xr, itr, resr, kryr = runs["gale_f32_ref"]
    assert iters == itr and abs(kry - kryr) <= KRYLOV_TOL * kryr
    assert res <= 1e-10 and res == pytest.approx(resr, rel=1e-4)
    assert _rel(X, Xr) <= TOL


@pytest.mark.parametrize("name", ["refined_dia", "refined_bell", "gmres"])
def test_sharded_solve_matches_one_process(runs, name):
    (x, kry), (xr, kryr) = runs["solves"][name], runs["solves_ref"][name]
    assert abs(kry - kryr) <= KRYLOV_TOL * kryr
    assert _rel(x, xr) <= TOL


def test_emulated_shards_diag_blocks_are_the_global_rows():
    """n = 100 in 16-row blocks over 2 ranks: 4 and 3 block rows, the last
    one cut by ``n`` (identity on its padded rows, as the whole operator's);
    the forward and transposed products of the shards are the whole
    operator's."""
    E, A, _, _ = rail_surrogate(100)
    _, A_op = bell_pencil(E, A, bs=16, device="cpu")
    shards = [shard_operator(None, A_op, rank=r, world=2) for r in range(2)]
    assert [s.rows for s in shards] == [(0, 64), (64, 100)] and shards[1].nb == 3
    assert torch.equal(torch.cat([s.diag_blocks() for s in shards]), A_op.diag_blocks())
    X = torch.as_tensor(np.random.default_rng(2).standard_normal((100, 3)))
    for t, ref in ((False, A_op.mm(X)), (True, A_op.tmm(X))):
        Y = torch.cat([s.local_mm(s.extend(X), t=t) for s in shards])
        assert _rel(Y, ref) <= 1e-14


def test_shard_algebra_keeps_the_shard():
    """`adjoint`, `bell_lin_comb`, `bell_scale`, `shifted_bell`, `lin_comb`
    and `op_astype` of shards are shards of the same rows; a shard and a
    whole operator do not combine, nor do shards of other rows with the
    same block pattern (ranks 0 and 1 of 3 hold 3 block rows each)."""
    E, A, _, _ = rail_surrogate(100)
    E_op, A_op = bell_pencil(E, A, bs=16, device="cpu")
    E_s, A_s = (shard_operator(None, op, rank=1, world=2) for op in (E_op, A_op))
    X = torch.as_tensor(np.random.default_rng(3).standard_normal((100, 2)))
    for got, whole in ((A_s.adjoint(), A_op.adjoint()),
                       (bell_lin_comb(A_s, -0.5, E_s), bell_lin_comb(A_op, -0.5, E_op)),
                       (bell_scale(A_s, 3.0), bell_scale(A_op, 3.0)),
                       (shifted_bell(E_s, A_s, -2.0), shifted_bell(E_op, A_op, -2.0)),
                       (lin_comb(A_s, 0.25, E_s), lin_comb(A_op, 0.25, E_op)),
                       (op_astype(A_s, torch.float32), op_astype(A_op, torch.float32))):
        assert isinstance(got, ShardedBellOp) and got.rows == (64, 100) and got.H == 1
        Y = got.local_mm(got.extend(X.to(got.dtype)))
        tol = F32_TOL if got.dtype == torch.float32 else 1e-14
        assert _rel(Y, whole.mm(X.to(got.dtype))[64:]) <= tol
    with pytest.raises(ValueError, match="pattern-sharing"):
        bell_lin_comb(A_s, 1.0, E_op)
    E0, A1 = (shard_operator(None, op, rank=r, world=3) for op, r in ((E_op, 0), (A_op, 1)))
    assert E0.cols.shape == A1.cols.shape and E0.rows != A1.rows
    with pytest.raises(ValueError, match="pattern-sharing"):
        bell_lin_comb(A1, 1.0, E0)
    with pytest.raises(NotImplementedError, match="no whole form"):
        A_s.to_dense()


@pytest.mark.cuda
def test_world_size_one_nccl_bell_sweep_on_the_card():
    """The block-ELL Ros2 sweep at n = 1357 (bs = 128) on the card over a
    world-size-1 NCCL group against the same sweep without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = dryrun.run_ranks(sharded_runs, 1, "cuda", args=("card", 1357))
    _hold_sweep(out["bell_ros2"], out["bell_ros2_ref"])

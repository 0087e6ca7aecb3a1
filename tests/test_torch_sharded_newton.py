"""The full compiled Kleinman–Newton on DIA row shards (ROADMAP item 10d)
and the 1-D complex buffer on row shards, over real process groups, against
one process and against the JAX package.  Its spawned ranks import this
file, so it imports no JAX at its top: the test that holds the result to
the JAX package imports it in its body (and skips where it is missing).

One spawn of 2 gloo ranks at n = 256 (`newton_rank`, 128 rows a rank)
runs:

* ``tests/test_torch_newton.py``'s benchmark solve (`dryrun.rail_newton`:
  ``G = lowrank(1000·B)``, closed-loop ``PerStepHeuristic(10, 12, 12)``,
  capacity 128, reltol 1e-10) on row shards, to its end (23 steps);
* the JAX dry run's Ros1 step with the 1-D complex buffer
  ``[−0.5, −1 ± 0.5i, −2]``, on complex banded cores and without cores
  (`dryrun.ros1_step_sharded`);
* the gathered `ShardedDiaOp.to_scipy` of both pencil members.

A second spawn runs the solve on one rank: bitwise the one process's.

Against one process: equal Newton steps, ADI counts, θ-stages (within
1e-12) and shift rebuilds; each rebuilt shift set within 1e-8 relative (a
Penzl Arnoldi on the closed loop carries the ~1e-14 rounding difference of
the all-reduced ``K`` into its Ritz values; 5.4e-10 measured); ``K`` and
``X`` within 1e-12; each residual within 1e-8 relative or under the
rounding floor n·eps·‖Q‖; the ``info`` the same on both ranks.  The Ros1
steps: equal ADI counts, Krylov within 2 %, X and K within 1e-10.  The one
process's Newton against the JAX package's: equal counts, ``K`` and each
residual within 1e-8 (`NEWTON_REL_TOL`), the residual's floor as above.
"""

import dataclasses
import importlib
import warnings

import numpy as np
import pytest
import torch

from differentialriccatiequations_jl_tpu_torch.lowrank import lowrank
from differentialriccatiequations_jl_tpu_torch.models.compiled import (
    PREC_BS, CappedADI, CompiledConfig, solve_gare_newton_compiled)
from differentialriccatiequations_jl_tpu_torch.models.problems import GAREProblem, GMRES
from differentialriccatiequations_jl_tpu_torch.ops.dia import dia_pencil
from differentialriccatiequations_jl_tpu_torch.parallel import dryrun
from differentialriccatiequations_jl_tpu_torch.parallel.mesh import make_mesh, shard_operator
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate

N = 256
K_TOL = 1e-12
THETA_TOL = 1e-12
SHIFT_TOL = 1e-8
NEWTON_REL_TOL = 1e-8
EPS = float(np.finfo(np.float64).eps)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _numpy_newton(out):
    X, K, info, sets, kry = out
    return (X.L @ X.D @ X.L.T).numpy(), K.numpy(), info, sets, kry


def _numpy_step(out):
    X, K, it, res, kry = out
    return (X.L @ X.D @ X.L.T).numpy(), K.numpy(), it, res, kry


def newton_rank(dev, n=N):
    """A rank's runs (see the module docstring), numpy results."""
    import torch.distributed as dist

    mesh = make_mesh(device=dev.type)
    newton = _numpy_newton(dryrun.rail_newton(dev, n, mesh))
    infos = [None] * dist.get_world_size()
    dist.all_gather_object(infos, newton[2])
    steps = {route: _numpy_step(dryrun.ros1_step_sharded(dev, n, mesh, route))
             for route in ("complex", "uncached")}
    E, A, _, _ = rail_surrogate(n)
    gathered = [(shard_operator(mesh, op, block=PREC_BS).to_scipy() - M).count_nonzero()
                for op, M in zip(dia_pencil(E, A, device=dev), (E, A))]
    return newton, all(i == infos[0] for i in infos), steps, gathered


@pytest.fixture(scope="module")
def runs():
    return dryrun.run_ranks(newton_rank, 2, "cpu")


@pytest.fixture(scope="module")
def one_process():
    return _numpy_newton(dryrun.rail_newton(torch.device("cpu"), N))


def _hold_history(got, ref, norm_Q):
    floor = N * EPS * norm_Q
    np.testing.assert_allclose(got, ref, rtol=NEWTON_REL_TOL, atol=floor)


def test_sharded_newton_matches_one_process(runs, one_process):
    (X, K, info, sets, kry), same_info, _, _ = runs
    Xr, Kr, ir, setsr, kryr = one_process
    assert same_info  # every rank returns the same info
    assert info["converged"] and ir["converged"]
    for key in ("newton_steps", "adi_iters", "shift_rebuilds", "converged"):
        assert info[key] == ir[key], key
    assert len(info["thetas"]) == len(ir["thetas"]) > 1
    np.testing.assert_allclose(info["thetas"], ir["thetas"], rtol=THETA_TOL)
    np.testing.assert_allclose(info["linesearch_lams"], ir["linesearch_lams"], rtol=THETA_TOL)
    assert len(sets) == len(setsr) == ir["shift_rebuilds"]
    for a, b in zip(sets, setsr):
        assert a.shape == b.shape
        assert np.max(np.abs(a - b)) <= SHIFT_TOL * np.max(np.abs(b))
    assert _rel(K, Kr) <= K_TOL and _rel(X, Xr) <= K_TOL
    _hold_history(info["residuals"], ir["residuals"], ir["residuals"][0])
    assert abs(kry - kryr) <= dryrun.KRYLOV_TOL * kryr


def one_rank(dev, n=N):
    """The benchmark solve on one rank's shards (the whole pencil)."""
    return _numpy_newton(dryrun.rail_newton(dev, n, make_mesh(device=dev.type)))


def test_one_rank_repeats_one_process(one_process):
    """On one rank every collective is a copy and every sharded routine
    takes the unsharded one's roundings, so the shift sets, ``K`` and the
    residuals are bitwise those of one process without a group."""
    X, K, info, sets, kry = dryrun.run_ranks(one_rank, 1, "cpu")
    Xr, Kr, ir, setsr, kryr = one_process
    assert info["residuals"] == ir["residuals"] and kry == kryr
    assert len(sets) == len(setsr) and all(np.array_equal(a, b) for a, b in zip(sets, setsr))
    assert np.array_equal(K, Kr) and np.array_equal(X, Xr)


@pytest.mark.parametrize("route", ["complex", "uncached"])
def test_sharded_complex_buffer_matches_one_process(runs, route):
    """The 1-D complex buffer on row shards: complex banded cores (their
    halo exchanges carry complex columns) and the uncached route."""
    got = runs[2][route]
    ref = _numpy_step(dryrun.ros1_step_sharded(torch.device("cpu"), N, None, route))
    dX, dK = _rel(got[0], ref[0]), _rel(got[1], ref[1])
    assert got[2] == ref[2] and got[2] > 0
    assert abs(got[4] - ref[4]) <= dryrun.KRYLOV_TOL * ref[4]
    assert dX <= dryrun.STEP_TOL and dK <= dryrun.STEP_TOL


def test_sharded_to_scipy_gathers_the_operator(runs):
    assert runs[3] == [0, 0]
    E, A, _, _ = rail_surrogate(N)
    shard = shard_operator(None, dia_pencil(E, A, device="cpu")[0], rank=0, world=2,
                           block=PREC_BS)
    with pytest.raises(NotImplementedError):
        shard.to_dense()


def test_inner_gmres_on_shards_raises():
    """The FGMRES inner solver has no row-sharded path: it raises before
    any collective."""
    E, A, B, C = rail_surrogate(N)
    E_op, A_op = dia_pencil(E, A, device="cpu")
    mesh = object()  # stands for the shards' mesh: nothing reaches a group
    E_s, A_s = (dataclasses.replace(shard_operator(None, op, rank=0, world=1, block=PREC_BS),
                                    mesh=mesh) for op in (E_op, A_op))
    prob = GAREProblem(E_s, A_s, lowrank(torch.as_tensor(B)), lowrank(torch.as_tensor(C.T)))
    with pytest.raises(NotImplementedError, match="row-sharded"):
        solve_gare_newton_compiled(prob, shifts=np.asarray([-1.0]), cfg=CompiledConfig(4, 2, 8),
                                   inner_gmres=GMRES(preconditioner=CappedADI(2, 8, 16)))


def test_one_process_newton_matches_jax(one_process):
    """The one process's Newton against the JAX package's
    `solve_gare_newton_compiled` on the same numpy inputs."""
    pytest.importorskip("jax")
    import jax.numpy as jnp

    name = "differentialriccatiequations_jl_tpu."
    jlr, jcomp, jprob, jdia = (importlib.import_module(name + m) for m in
                               ("lowrank", "models.compiled", "models.problems", "ops.dia"))
    E, A, B, C = rail_surrogate(N)
    jE, jA = jdia.dia_pencil(E, A)
    cfg = dryrun.NEWTON
    prob = jprob.GAREProblem(jE, jA, jlr.lowrank(jnp.asarray(cfg["gscale"] * B)),
                             jlr.lowrank(jnp.asarray(C.T)))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        Xj, ij = jcomp.solve_gare_newton_compiled(
            prob, shifts=jcomp.PerStepHeuristic(*cfg["shifts"]),
            cfg=jcomp.CompiledConfig(*cfg["cfg"]), capacity=cfg["capacity"],
            reltol=cfg["reltol"])
    Kj = np.asarray(((prob.G.L.T @ Xj.L) @ Xj.D) @ jE.tmm(Xj.L).T)
    _, K, it, _, _ = one_process
    for key in ("newton_steps", "adi_iters", "shift_rebuilds", "converged"):
        assert it[key] == ij[key], key
    np.testing.assert_allclose(it["thetas"], ij["thetas"], rtol=THETA_TOL)
    assert _rel(K, Kj) <= NEWTON_REL_TOL
    _hold_history(it["residuals"], ij["residuals"], ij["residuals"][0])

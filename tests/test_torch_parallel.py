"""The port's ``parallel/`` layer over real process groups, and the
constructors' device rule.  Imports no JAX: its spawned ranks import this
file, so they stay JAX-free too.

One spawn of 2 gloo ranks on the CPU (`test_two_gloo_ranks`) checks, in
one group:

* the row-sharded DIA product (`ShardedDiaOp` ``mm``/``tmm``, halo exchange
  + K1's plain version) at n = 96 and 256 against the unsharded port
  product and scipy;
* `ShardedBellSpmm` at n = 1024, bs = 16 (forward, ``transpose=True``, a
  1-D right-hand side) against both;
* parareal with 4 slabs split over the 2 ranks against the one-process run
  (`tests/test_parareal.py:149-161`): K within 1e-10, deltas within 1e-8
  relative; and its mesh checks.

Products within 1e-12 relative (the same sums; only the order of the
plain versions' diagonal or slot terms is shared).  A second spawn runs
`entry.dryrun_multichip(2, device="cpu")`, whose sharded Ros1 and Newton
steps `tests/test_torch_sharded_steps.py` covers in full.  Both spawns go
through `dryrun.run_ranks` (a group timeout, a deadline).  The validation
errors need no group.
"""

import numpy as np
import pytest
import scipy.sparse as sp
import scipy.sparse.linalg as sspla
import torch

from differentialriccatiequations_jl_tpu_torch import convert
from differentialriccatiequations_jl_tpu_torch.lowrank import lowrank, lr_with_capacity, lr_zero
from differentialriccatiequations_jl_tpu_torch.models.compiled import CompiledConfig
from differentialriccatiequations_jl_tpu_torch.models.parareal import (
    Parareal, solve_gdre_parareal)
from differentialriccatiequations_jl_tpu_torch.models.problems import GDREProblem
from differentialriccatiequations_jl_tpu_torch.models.shifts import heuristic_shifts_host
from differentialriccatiequations_jl_tpu_torch.ops.dia import dia_from_scipy, dia_pencil
from differentialriccatiequations_jl_tpu_torch.ops.operators import DenseOp, as_operator, lr_update
from differentialriccatiequations_jl_tpu_torch.ops.sparse import (
    bell_from_scipy, bell_pencil)
from differentialriccatiequations_jl_tpu_torch.parallel.dryrun import run_ranks
from differentialriccatiequations_jl_tpu_torch.parallel.mesh import (
    make_mesh, replicated, row_range, row_sharded, shard_lowrank, shard_operator, shard_tall,
    unshard_tall, use_mesh)
from differentialriccatiequations_jl_tpu_torch.parallel.sharded_ops import ShardedBellSpmm
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate

PRODUCT_TOL = 1e-12
PARAREAL_K_TOL = 1e-10
PARAREAL_DELTA_TOL = 1e-8
STEP_TOL = 1e-10
CFG = CompiledConfig(maxiters=60, compression_interval=10, r_res=48)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300)


def _parareal_problem(n=96, nsteps=8, tau=20.0):
    """`tests/test_parareal.py`'s problem (n = 96, 8 real Penzl shifts,
    capacity 96) at ``nsteps`` steps."""
    E, A, B, C = rail_surrogate(n)
    E_op, A_op = dia_pencil(E, A, device="cpu")
    shifts = np.asarray([s.real for s in heuristic_shifts_host(E, A, 8, 10, 10)])
    L0 = sspla.splu(E.tocsc()).solve(np.asarray(C).T.copy())
    X0 = lr_with_capacity(lowrank(torch.as_tensor(L0),
                                  0.01 * torch.eye(C.shape[0], dtype=torch.float64)), 96)
    prob = GDREProblem(E_op, A_op, torch.as_tensor(B), torch.as_tensor(C), X0,
                       (4500.0, 4500.0 - tau * nsteps))
    return prob, dict(dt=-tau, shifts=shifts, cfg=CFG, capacity=96, abstol=1e-13)


def _check_products(mesh):
    rng = np.random.default_rng(7)
    for n in (96, 256):
        E, A, _, _ = rail_surrogate(n)
        _, op = dia_pencil(E, A, device="cpu")
        X = torch.as_tensor(rng.standard_normal((n, 5)))
        sh = shard_operator(mesh, op)
        assert sh.rows == row_range(n, 2, mesh.get_local_rank())
        for prod, ref, M in ((sh.mm, op.mm, A), (sh.tmm, op.tmm, A.T)):
            Y = unshard_tall(mesh, prod(shard_tall(mesh, X)), n)
            assert _rel(Y, ref(X)) < PRODUCT_TOL and _rel(Y, M @ X.numpy()) < PRODUCT_TOL
    n, bs = 1024, 16
    E, A, _, _ = rail_surrogate(n)
    _, op = bell_pencil(E, A, bs=bs, device="cpu")
    X = torch.as_tensor(rng.standard_normal((n, 5)))
    v = torch.as_tensor(rng.standard_normal(n))
    for transpose, M in ((False, A), (True, A.T)):
        mm = ShardedBellSpmm(mesh, op, transpose=transpose)
        ref = op.tmm if transpose else op.mm
        for R in (X, v):
            Y = unshard_tall(mesh, mm(shard_tall(mesh, R, bs)), n, bs)
            assert Y.shape == R.shape
            assert _rel(Y, ref(R)) < PRODUCT_TOL and _rel(Y, M @ R.numpy()) < PRODUCT_TOL


def _check_parareal():
    prob, kw = _parareal_problem()
    alg = Parareal(slabs=4, max_iters=2)
    ref = solve_gdre_parareal(prob, alg=alg, **kw)
    mesh = make_mesh(2, device="cpu", axis="slab")
    sol = solve_gdre_parareal(prob, alg=alg, mesh=mesh, **kw)
    assert max(_rel(a, b) for a, b in zip(sol.K[1:], ref.K[1:])) < PARAREAL_K_TOL
    assert sol.parareal_info["deltas"] == pytest.approx(ref.parareal_info["deltas"],
                                                         rel=PARAREAL_DELTA_TOL)
    assert sol.parareal_info["fine_iters_total"] == ref.parareal_info["fine_iters_total"]
    assert sol.adi_iters == ref.adi_iters
    saved = solve_gdre_parareal(prob, alg=alg, mesh=mesh, save_state=True, **kw)
    assert len(saved.X) == len(saved.t) == 9
    assert _rel(saved.X[-1].L @ saved.X[-1].D @ saved.X[-1].L.T,
                sol.X[-1].L @ sol.X[-1].D @ sol.X[-1].L.T) < PARAREAL_K_TOL
    with pytest.raises(ValueError, match="no dimension named 'slab'"):
        solve_gdre_parareal(prob, alg=alg, mesh=make_mesh(2, device="cpu"), **kw)
    prob6, kw6 = _parareal_problem(nsteps=6)
    with pytest.raises(ValueError, match="slabs=3 not divisible"):
        solve_gdre_parareal(prob6, alg=Parareal(slabs=3), mesh=mesh, **kw6)


def _ranks(dev):
    mesh = make_mesh(device=dev.type)
    with use_mesh(mesh):  # a sharded product runs only under its mesh
        _check_products(mesh)
    _check_parareal()


def test_two_gloo_ranks():
    """The sharded products and parareal over 2 gloo ranks (one spawn);
    a failing rank's assertion is raised here."""
    run_ranks(_ranks, 2, "cpu")


def test_dryrun_multichip_cpu():
    from differentialriccatiequations_jl_tpu_torch.entry import dryrun_multichip

    res = dryrun_multichip(2, device="cpu")
    assert res["ranks"] == 2 and res["n"] == 512 and res["products_max_rel"] <= PRODUCT_TOL
    assert res["parareal_dK"] <= PARAREAL_K_TOL and res["parareal_iterations"] == 1
    for step in (res["ros1_step"], res["newton_step"]):
        assert step["dX"] <= STEP_TOL and step["dK"] <= STEP_TOL and step["adi_iters"] > 0


def test_sharded_validation():
    """`ShardedBellSpmm` rejects a block bandwidth above its halo, a halo
    above a shard's block rows and a split with an empty shard; the DIA
    shard a halo above a shard's rows; `row_range` splits ⌈n/W⌉ rows per
    rank with a shorter last shard, as `shard_lowrank` does."""
    n, bs = 256, 16
    rng = np.random.default_rng(1)
    M = sp.random(n, n, density=0.2, random_state=rng, format="csr") + sp.eye(n)
    op = bell_from_scipy(M.tocsr(), bs=bs, device="cpu")
    with pytest.raises(ValueError, match="exceeds halo 1"):
        ShardedBellSpmm(None, op, halo=1, rank=0, world=8)
    E, A, _, _ = rail_surrogate(1024)
    _, band = bell_pencil(E, A, bs=bs, device="cpu")
    with pytest.raises(ValueError, match="exceeds the 2 block-rows"):
        ShardedBellSpmm(None, band, halo=3, rank=0, world=32)
    with pytest.raises(ValueError, match="last shard would be empty"):
        ShardedBellSpmm(None, band, rank=0, world=63)
    assert ShardedBellSpmm(None, band, rank=6, world=7).rows == (960, 1024)  # 10,10,…,4
    _, dia = dia_pencil(E, A, device="cpu")
    with pytest.raises(ValueError, match="halo 32 exceeds"):
        shard_operator(None, dia, rank=0, world=40)
    with pytest.raises(ValueError, match="pass a mesh"):
        shard_operator(None, dia, rank=0)
    with pytest.raises(TypeError, match="cannot shard"):
        shard_operator(None, object(), rank=0, world=2)
    assert [row_range(10, 4, r) for r in range(4)] == [(0, 3), (3, 6), (6, 9), (9, 10)]
    assert row_range(1000, 3, 2, block=16) == (672, 1000)
    X = lowrank(torch.ones((10, 2), dtype=torch.float64))
    Xl = shard_lowrank(None, X, rank=3, world=4)
    assert Xl.L.shape == (1, 2) and Xl.D.shape == (2, 2) and Xl.k == 2
    assert [type(p).__name__ for p in row_sharded(None) + replicated(None)] == [
        "Shard", "Replicate"]


def test_make_mesh_needs_a_card_or_cpu():
    """Without a card `make_mesh` raises unless the caller asks for the CPU,
    and it needs an initialised group either way."""
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(1)
    with pytest.raises(RuntimeError, match="initialised process group"):
        make_mesh(1, device="cpu")


def test_constructors_default_to_the_card():
    """The operator and factor constructors put their output on the card
    when no device is given, and raise where there is none (no silent CPU
    fallback); ``device="cpu"`` builds on the CPU.  `lowrank`, `DenseOp`,
    `lr_update` and `as_operator` put numpy input there too; `DenseOp`
    builds on the CPU from a CPU tensor, and each of them keeps a tensor on
    its own device."""
    E, A, _, _ = rail_surrogate(64)
    data = np.ones((1, 4))
    M, U = np.eye(4), np.ones((4, 2))
    builders = [
        lambda **kw: dia_pencil(E, A, **kw)[0],
        lambda **kw: dia_from_scipy(A, **kw),
        lambda **kw: bell_pencil(E, A, bs=16, **kw)[0],
        lambda **kw: bell_from_scipy(A, bs=16, **kw),
        lambda **kw: convert.dia_op_from_numpy(data, data, (0,), 4, 4, **kw),
        lambda **kw: convert.lowrank_from_numpy(np.ones((4, 2)), np.eye(2), 2, **kw),
        lambda **kw: lr_zero(4, 2, torch.float64, **kw),
        lambda **kw: lowrank(U, np.eye(2), **kw),
        lambda **kw: DenseOp(M if not kw else torch.as_tensor(M, **kw)),
        lambda **kw: lr_update(M, 2.0, U, U.T, **kw),
        lambda **kw: as_operator(M, **kw),
    ]
    for build in builders:
        assert build(device="cpu").device.type == "cpu"
        if torch.cuda.is_available():
            assert build().device.type == "cuda"
        else:
            with pytest.raises(RuntimeError, match="no CUDA device"):
                build()
    # A tensor keeps its device; numpy factors of an update follow its
    # operator.
    Mt = torch.as_tensor(M)
    X = torch.ones((4, 1), dtype=torch.float64)
    for op in (DenseOp(Mt), as_operator(Mt), lr_update(DenseOp(Mt), 2.0, U, U.T)):
        assert op.device.type == "cpu" and op.mm(X).shape == (4, 1)
    assert lowrank(torch.as_tensor(U), np.eye(2)).L.device.type == "cpu"
    upd = lr_update(DenseOp(Mt), 2.0, U, U.T)
    assert upd.U.device.type == "cpu" and upd.V.device.type == "cpu"

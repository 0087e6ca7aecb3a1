"""Multi-rank dry run: the row-sharded products, the row-sharded compiled
Ros1 and Newton steps, and parareal over ranks.

Port of the JAX package's ``parallel/dryrun.py``.  `dryrun_multichip`
spawns ``n_devices`` ranks (`run_ranks`: one process each, a
`torch.distributed` group over ``tcp://localhost`` with a timeout, the
whole spawn under a deadline), builds a 1-D mesh (`mesh.make_mesh`) and, on
tiny shapes:

* holds the row-sharded DIA product (`sharded_ops.ShardedDiaOp`, ``mm`` and
  ``tmm``, halo exchange + K1) and the row-sharded block-ELL product
  (`sharded_ops.ShardedBellOp`, halo exchange + K2) against the unsharded
  ones;
* runs the JAX dry run's compiled Ros1 step (the pair-encoded buffer
  ``[−0.5, −1 ± 0.5i, −2]``) and its compiled Kleinman–Newton step (real
  shifts ``[−0.5, −1.5, −3]``) on row-sharded operands (`ros1_step_sharded`,
  `newton_step_sharded`) and holds each against the same step in one
  process: equal ADI iterations, Krylov iterations within 2 %, ``X`` and
  ``K`` within `STEP_TOL`;
* runs one parareal iteration with ``slabs = n_devices``, the slabs' fine
  sweeps split over the ranks (`models.parareal.solve_gdre_parareal` with
  ``mesh=``), and holds it against the same solve in one process.

The steps run at n = 256·W, where the JAX dry run takes 64·W: the compiled
steps split whole 128-row blocks over the ranks (so that each rank's
block-Jacobi blocks are the global ones), and 64·W rows cannot be split so.

For the tests and the smoke run: `ros1_sweep` is the JAX package's
sharded-sweep test configuration (``tests/test_sharded_gdre.py:140-153``);
`bell_sweep` (block-ELL, Ros1 or Ros2) and `ros2_sweep` (DIA) run
``tests/test_torch_ros2.py``'s configuration (`SWEEP`) through
`run_sweep`, which shards any pencil in its blocks (`shard_pencil`:
``bs``-row blocks for block-ELL, ``PREC_BS`` for DIA); `solve_sharded`
and `compress_sharded` run one block solve or `gram` compression on
shards; `newton_solve` runs the full compiled Kleinman–Newton on DIA row
shards and `rail_newton` ``tests/test_torch_newton.py``'s benchmark
configuration (`NEWTON`) through it, recording its shift sets
(`recording_shift_sets`).
"""

from __future__ import annotations

import contextlib
import socket
import time
import warnings

import numpy as np
import torch

#: Sharded vs unsharded products: f64 sums in the same order but for the
#: kernels' FMA contraction.
PRODUCT_TOL = 1e-12
#: Parareal over ranks vs one process: K within this, relative.
PARAREAL_TOL = 1e-10
#: Row-sharded steps vs one process: X and K within this, relative (the
#: JAX package's test, ``tests/test_sharded_gdre.py:170-175``).
STEP_TOL = 1e-10
#: Krylov iterations, sharded vs one process: the sums of the dots are
#: taken in another order, and BiCGStab may cross its bound an iteration
#: earlier or later.
KRYLOV_TOL = 0.02
#: Seconds a spawn may take before its ranks are stopped.
DEADLINE = 300.0


def free_port() -> int:
    """A free TCP port on localhost (bound to port 0, then released)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-300))


def _rank_main(rank, fn, world, port, device, args, out):
    """One spawned rank: a group with `mesh.GROUP_TIMEOUT`, ``fn(dev,
    *args)``, rank 0's result into ``out``."""
    import torch.distributed as dist

    from .mesh import GROUP_TIMEOUT

    torch.set_num_threads(1)
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(rank % torch.cuda.device_count())
        dev = torch.device("cuda", torch.cuda.current_device())
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank, timeout=GROUP_TIMEOUT)
    try:
        result = fn(dev, *args)
        if rank == 0:
            out.put(("result", result))
    finally:
        dist.destroy_process_group()


def _stop(ranks) -> None:
    for p in ranks.processes:
        if p.is_alive():
            p.terminate()
    for p in ranks.processes:
        p.join(5)
        if p.is_alive():
            p.kill()
            p.join(5)


def run_ranks(fn, world: int, device=None, args=(), deadline: float = DEADLINE):
    """Spawn ``world`` ranks on ``device`` (default the card: one GPU per
    rank, NCCL; ``"cpu"``: gloo), each running ``fn(dev, *args)`` inside an
    initialised process group (``fn`` makes its meshes with
    `mesh.make_mesh`); return rank 0's result.  ``fn`` must be importable
    (a module-level function), and its result is pickled: return host values
    (numbers, numpy arrays).  Raises if a rank fails, and `TimeoutError`
    once ``deadline`` seconds have passed, after stopping every rank."""
    import torch.multiprocessing as mp

    from ..config import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < world:
        raise RuntimeError(f"{world} ranks need {world} GPUs, found "
                           f"{torch.cuda.device_count()}")
    out = mp.get_context("spawn").SimpleQueue()
    t_end = time.monotonic() + deadline
    ranks = mp.start_processes(_rank_main, args=(fn, world, free_port(), dev.type, args, out),
                               nprocs=world, join=False, start_method="spawn")
    got = None
    try:
        # Drain the queue while waiting: a writer blocks on a full pipe.
        # join raises as soon as a rank fails.
        while not ranks.join(timeout=1):
            if got is None and not out.empty():
                got = out.get()
            if time.monotonic() > t_end:
                raise TimeoutError(f"{world} ranks still running after {deadline:.0f} s")
    finally:
        _stop(ranks)
    if got is None and not out.empty():
        got = out.get()
    if got is None:
        raise RuntimeError("rank 0 returned no result")
    return got[1]


def _check_products(mesh, dev, n, bs):
    """Sharded DIA (mm, tmm) and block-ELL (mm, tmm) products on the Rail
    surrogate against the unsharded ones; returns the worst relative
    difference."""
    from ..ops.dia import dia_pencil
    from ..ops.sparse import bell_pencil
    from ..utils.testmat import rail_surrogate
    from .mesh import shard_operator, shard_tall, unshard_tall, use_mesh

    E, A, _, _ = rail_surrogate(n)
    X = torch.as_tensor(np.random.default_rng(3).standard_normal((n, 5)), device=dev)
    worst = 0.0
    for fmt, (_, op) in (("dia", dia_pencil(E, A, device=dev)),
                         ("bell", bell_pencil(E, A, bs=bs, device=dev))):
        block = 1 if fmt == "dia" else bs
        sh = shard_operator(mesh, op)
        X_l = shard_tall(mesh, X, block)
        for name, prod, ref in (("mm", sh.mm, op.mm), ("tmm", sh.tmm, op.tmm)):
            with use_mesh(mesh):
                Y_l = prod(X_l)
            Y = unshard_tall(mesh, Y_l, n, block)
            rel = _rel(Y, ref(X))
            if not rel <= PRODUCT_TOL:
                raise AssertionError(f"sharded {fmt} {name}: rel {rel:.3e} > {PRODUCT_TOL}")
            worst = max(worst, rel)
    return worst


# --- the row-sharded compiled steps -------------------------------------------


def shard_block(op) -> int:
    """The rows a rank's shard of ``op`` holds whole blocks of: a block-ELL
    operator's ``bs``, ``PREC_BS`` for a DIA one (so that its block-Jacobi
    blocks are the global ones)."""
    from ..models.compiled import PREC_BS
    from ..ops.sparse import BellOp

    return op.bs if isinstance(op, BellOp) else PREC_BS


def shard_pencil(mesh, E_op, A_op, B, C):
    """``E``, ``A`` split in whole blocks (`shard_block`), ``B`` split by
    rows and ``C`` by columns in the same blocks."""
    from .mesh import shard_operator, shard_tall

    block = shard_block(E_op)
    return (shard_operator(mesh, E_op, block=block), shard_operator(mesh, A_op, block=block),
            shard_tall(mesh, B, block), shard_tall(mesh, C.T, block).T)


def gather_state(mesh, X, K, n, block=None):
    """The whole ``X`` (its ``L`` gathered) and ``K`` (its columns
    gathered) of a row-sharded step split in ``block``-row blocks (default
    ``PREC_BS``); as they are without a mesh."""
    from ..lowrank import LowRank
    from ..models.compiled import PREC_BS
    from .mesh import unshard_tall

    if mesh is None:
        return X, K
    block = PREC_BS if block is None else block
    return (LowRank(L=unshard_tall(mesh, X.L, n, block), D=X.D, k=X.k),
            unshard_tall(mesh, K.T.contiguous(), n, block).T)


def _counted(run):
    """``run()`` and the Krylov iterations it took."""
    from ..ops import blocklinear

    k0 = blocklinear.krylov_iterations
    out = run()
    return out, blocklinear.krylov_iterations - k0


def rail_x0(E, C, dev, capacity: int, dtype=torch.float64):
    """``X0 = lowrank(E⁻¹Cᵀ, 0.01·I)`` at ``capacity`` on ``dev``, f64 (or
    ``dtype``)."""
    import scipy.sparse.linalg as spla

    from ..lowrank import lowrank, lr_with_capacity

    L0 = spla.splu(E.tocsc()).solve(np.asarray(C).T.copy())
    return lr_with_capacity(lowrank(torch.as_tensor(L0, dtype=dtype, device=dev),
                                    0.01 * torch.eye(C.shape[0], dtype=dtype, device=dev)),
                            capacity)


def _dryrun_pencil(dev, n):
    """The JAX dry run's pencil and start: the Rail surrogate, X0 =
    lowrank(E⁻¹Cᵀ, 0.01·I) at capacity 64, in the default dtype
    (`config.default_dtype`, f64 unless set)."""
    from ..config import default_dtype
    from ..ops.dia import dia_pencil
    from ..utils.testmat import rail_surrogate

    dt = default_dtype()
    E, A, B, C = rail_surrogate(n)
    E_op, A_op = dia_pencil(E, A, dtype=dt, device=dev)
    return (E_op, A_op, torch.as_tensor(B, dtype=dt, device=dev),
            torch.as_tensor(C, dtype=dt, device=dev), rail_x0(E, C, dev, 64, dt))


def ros1_step_sharded(dev, n, mesh=None, route="pair"):
    """The JAX dry run's compiled Ros1 step (its ``parallel/dryrun.py:45-80``:
    τ = 20, the buffer ``[−0.5, −1 ± 0.5i, −2]``, `CompiledConfig(8, 4,
    16)`, abstol 1e-8) at ``n``, on operands split over ``mesh`` (in one
    process without one).  ``route``: ``"pair"`` the pair-encoded buffer
    on banded cores (the JAX dry run's), ``"complex"`` the 1-D complex
    buffer on complex banded cores, ``"uncached"`` the 1-D complex buffer
    without cores.  Returns (X, K gathered, ADI iterations, residual,
    Krylov iterations)."""
    from ..entry import SHIFTS
    from ..models.compiled import (
        PREC_BS, CompiledConfig, build_dia_shift_ops, pair_encode_shifts, ros1_step_compiled)
    from ..ops.operators import lin_comb
    from .mesh import shard_lowrank

    tau, cfg = 20.0, CompiledConfig(maxiters=8, compression_interval=4, r_res=16)
    E, A, B, C, X0 = _dryrun_pencil(dev, n)
    if mesh is not None:
        E, A, B, C = shard_pencil(mesh, E, A, B, C)
        X0 = shard_lowrank(mesh, X0, PREC_BS)
    shifts = pair_encode_shifts(SHIFTS) if route == "pair" else SHIFTS
    lus = None if route == "uncached" else build_dia_shift_ops(
        E, lin_comb(A, -1.0 / (2.0 * tau), E), shifts)
    (X, K, iters, res), kry = _counted(lambda: ros1_step_compiled(
        E, A, B, C, X0, tau, shifts, 1e-8, cfg, lus))
    return (*gather_state(mesh, X, K, n), iters, float(res), kry)


def newton_step_sharded(dev, n, mesh=None):
    """The JAX dry run's compiled Kleinman–Newton step (its
    ``parallel/dryrun.py:82-100``: shifts ``[−0.5, −1.5, −3]``, G =
    lowrank(B) and Q = lowrank(Cᵀ) at capacity 16, the GARE residual at X0
    as the entry residual, inner abstol 1e-3) at ``n``, on operands split
    over ``mesh`` (in one process without one).  Returns (X, K gathered,
    ADI iterations, ADI residual, Krylov iterations); ``K`` is the feedback
    at the new X."""
    from ..lowrank import lowrank, lr_with_capacity
    from ..models.compiled import (
        PREC_BS, CompiledConfig, _newton_step_compiled, build_dia_shift_ops)
    from ..models.residuals import residual_gare_lowrank
    from ..models.rosenbrock_lowrank import feedback_K
    from .mesh import shard_lowrank

    cfg = CompiledConfig(maxiters=8, compression_interval=4, r_res=16)
    E, A, B, C, X0 = _dryrun_pencil(dev, n)
    G = lr_with_capacity(lowrank(B), 16)
    Q = lr_with_capacity(lowrank(C.T.contiguous()), 16)
    if mesh is not None:
        E, A, B, C = shard_pencil(mesh, E, A, B, C)
        X0, G, Q = (shard_lowrank(mesh, Y, PREC_BS) for Y in (X0, G, Q))
    shifts = np.asarray([-0.5, -1.5, -3.0])
    lus = build_dia_shift_ops(E, A, shifts)
    K0 = feedback_K(E, B, X0)
    res = residual_gare_lowrank(E, A, G, Q, X0, r_out=cfg.r_res)
    (X, iters, ares), kry = _counted(lambda: _newton_step_compiled(
        E, A, B, X0, K0, res, shifts, 1e-3, cfg, lus))
    return (*gather_state(mesh, X, feedback_K(E, B, X), n), iters, float(ares), kry)


@contextlib.contextmanager
def recording_shift_sets():
    """Within the block, every shift buffer that the compiled solvers build
    shifted cores for (`models.compiled.build_step_shift_solvers`) is
    appended, as a host copy, to the list it yields: a Newton solve's
    initial and rebuilt shift sets, in order."""
    from ..models import compiled

    sets, build = [], compiled.build_step_shift_solvers

    def recording(E, F_base, shifts, *args, **kw):
        sets.append(np.array(shifts))
        return build(E, F_base, shifts, *args, **kw)

    compiled.build_step_shift_solvers = recording
    try:
        yield sets
    finally:
        compiled.build_step_shift_solvers = build


def newton_solve(E_op, A_op, G, Q, mesh=None, **kw):
    """`solve_gare_newton_compiled` on ``GAREProblem(E, A, G, Q)`` (``kw``
    its keywords), with DIA ``E``, ``A`` split over ``mesh`` first in
    ``PREC_BS``-row blocks and ``G``, ``Q`` by rows in the same blocks (in
    one process without one).  Returns (X, ``K = BᵀXE`` with ``B = G.L``,
    both gathered; info; the shift sets of its rebuilds; Krylov
    iterations)."""
    from ..models.compiled import PREC_BS, solve_gare_newton_compiled
    from ..models.problems import GAREProblem
    from ..models.rosenbrock_lowrank import feedback_K
    from .mesh import shard_lowrank, shard_operator

    n = E_op.n
    if mesh is not None:
        E_op, A_op = (shard_operator(mesh, op, block=PREC_BS) for op in (E_op, A_op))
        G, Q = (shard_lowrank(mesh, Y, PREC_BS) for Y in (G, Q))
    with recording_shift_sets() as sets:
        (X, info), kry = _counted(lambda: solve_gare_newton_compiled(
            GAREProblem(E_op, A_op, G, Q), **kw))
    return (*gather_state(mesh, X, feedback_K(E_op, G.L, X), n), info, sets, kry)


#: `rail_newton`'s configuration: ``tests/test_torch_newton.py``'s benchmark
#: solve (``G = lowrank(1000·B)``, ``Q = lowrank(Cᵀ)``, closed-loop shifts
#: ``PerStepHeuristic(10, 12, 12)``, `CompiledConfig(120, 10, 32)`, capacity
#: 128, reltol 1e-10).
NEWTON = dict(gscale=1000.0, shifts=(10, 12, 12), cfg=(120, 10, 32), capacity=128,
              reltol=1e-10)


def rail_newton(dev, n, mesh=None, maxiters=60, **config):
    """`NEWTON`'s compiled Kleinman–Newton (any entry overridden by
    ``config``) on the Rail surrogate's DIA pencil at ``n``, at most
    ``maxiters`` Newton steps, on operands split over ``mesh`` (in one
    process without one).  Returns `newton_solve`'s result."""
    from ..lowrank import lowrank
    from ..models.compiled import CompiledConfig, PerStepHeuristic
    from ..ops.dia import dia_pencil
    from ..utils.testmat import rail_surrogate

    c = {**NEWTON, **config}
    E, A, B, C = rail_surrogate(n)
    E_op, A_op = dia_pencil(E, A, device=dev)
    G = lowrank(torch.as_tensor(c["gscale"] * B, device=dev))
    Q = lowrank(torch.as_tensor(C.T.copy(), device=dev))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")  # the step cap's "did not converge"
        return newton_solve(E_op, A_op, G, Q, mesh, shifts=PerStepHeuristic(*c["shifts"]),
                            cfg=CompiledConfig(*c["cfg"]), capacity=c["capacity"],
                            maxiters=maxiters, reltol=c["reltol"])


def run_sweep(method, E_op, A_op, B, C, X0, shifts, mesh=None, *, tau, nsteps, cfg,
              capacity, abstol=None, observer=None):
    """``solve_gdre_ros{1,2}_compiled`` (``method`` "ros1" or "ros2") from
    t = 4500 in ``nsteps`` steps of ``τ`` on whole operands, split over
    ``mesh`` first if given (`shard_pencil`, ``X0`` in the same blocks).
    Returns (the final X and every K, gathered; ADI and Krylov
    iterations)."""
    from ..models.compiled import solve_gdre_ros1_compiled, solve_gdre_ros2_compiled
    from ..models.problems import GDREProblem
    from .mesh import shard_lowrank

    n, block = E_op.n, shard_block(E_op)
    if mesh is not None:
        E_op, A_op, B, C = shard_pencil(mesh, E_op, A_op, B, C)
        X0 = shard_lowrank(mesh, X0, block)
    prob = GDREProblem(E_op, A_op, B, C, X0, (4500.0, 4500.0 - nsteps * tau))
    solve = {"ros1": solve_gdre_ros1_compiled, "ros2": solve_gdre_ros2_compiled}[method]
    sol, kry = _counted(lambda: solve(prob, dt=-tau, shifts=shifts, cfg=cfg,
                                      capacity=capacity, abstol=abstol, observer=observer))
    X = gather_state(mesh, sol.X[-1], sol.K[-1], n, block)[0]
    Ks = [gather_state(mesh, sol.X[-1], K, n, block)[1] for K in sol.K]
    return X, Ks, sol.adi_iters, kry


def ros1_sweep(dev, n, mesh=None):
    """The JAX package's sharded-sweep test (``tests/test_sharded_gdre.py:
    140-153``) at ``n``: the Rail surrogate, 8 real Penzl shifts
    ``heuristic_shifts_host(E, A, 8, 10, 10)``, X0 = lowrank(E⁻¹Cᵀ, 0.01·I)
    at capacity 96, `CompiledConfig(60, 10, 48)`, tspan (4500, 4440),
    dt = −20, abstol 1e-12, on DIA operands split over ``mesh`` (in one
    process without one).  Returns (the final X and every K, gathered; ADI
    and Krylov iterations)."""
    from ..models.compiled import CompiledConfig
    from ..models.shifts import heuristic_shifts_host
    from ..ops.dia import dia_pencil
    from ..utils.testmat import rail_surrogate

    E, A, B, C = rail_surrogate(n)
    shifts = np.asarray([s.real for s in heuristic_shifts_host(E, A, 8, 10, 10)])
    E_op, A_op = dia_pencil(E, A, device=dev)
    return run_sweep("ros1", E_op, A_op, torch.as_tensor(B, device=dev),
                     torch.as_tensor(C, device=dev), rail_x0(E, C, dev, 96), shifts, mesh,
                     tau=20.0, nsteps=3, cfg=CompiledConfig(60, 10, 48), capacity=96,
                     abstol=1e-12)


#: The configuration of `bell_sweep` and `ros2_sweep`, ``tests/test_torch_
#: ros2.py``'s: τ = 10, 3 steps, capacity 64, `CompiledConfig(60, 10, 16)`,
#: 8 Penzl shifts of the step's pencil; block-ELL in 16-row blocks (6 block
#: rows at its n = 96).
SWEEP = dict(bs=16, tau=10.0, nsteps=3, capacity=64, cfg=(60, 10, 16), nshifts=8)


def sweep_shifts(E, A, method: str, tau: float, nshifts: int) -> np.ndarray:
    """The real parts of ``nshifts`` Penzl shifts (`heuristic_shifts_host`,
    20 + 20 Arnoldi steps) of the sweep's pencil ``(E, A − E/(2τ))`` (Ros1)
    or ``(E, γτA − E/2)`` (Ros2)."""
    import scipy.sparse as sp

    from ..models.compiled import _ROS2_GAMMA
    from ..models.shifts import heuristic_shifts_host

    F = _ROS2_GAMMA * tau * A - 0.5 * E if method == "ros2" else A - E / (2.0 * tau)
    return np.asarray([s.real for s in heuristic_shifts_host(E, sp.csr_matrix(F), nshifts,
                                                            20, 20)])


def _rail_sweep(dev, n, mesh, method, fmt, config):
    from ..models.compiled import CompiledConfig
    from ..ops.dia import dia_pencil
    from ..ops.sparse import bell_pencil
    from ..utils.testmat import rail_surrogate

    c = {**SWEEP, **config}
    E, A, B, C = rail_surrogate(n)
    shifts = sweep_shifts(E, A, method, c["tau"], c["nshifts"])
    E_op, A_op = (bell_pencil(E, A, bs=c["bs"], device=dev) if fmt == "bell"
                  else dia_pencil(E, A, device=dev))
    return run_sweep(method, E_op, A_op, torch.as_tensor(B, device=dev),
                     torch.as_tensor(C, device=dev), rail_x0(E, C, dev, c["capacity"]), shifts,
                     mesh, tau=c["tau"], nsteps=c["nsteps"], cfg=CompiledConfig(*c["cfg"]),
                     capacity=c["capacity"])


def bell_sweep(dev, n, mesh=None, method="ros2", **config):
    """The block-ELL Ros1 or Ros2 sweep (``method``) on the Rail surrogate
    at ``n`` (`SWEEP`, any entry overridden by ``config``; X0 =
    lowrank(E⁻¹Cᵀ, 0.01·I), abstol n·eps·‖C‖), on operands split over
    ``mesh`` in ``bs``-row blocks (in one process without one).  Returns
    (the final X and every K, gathered; ADI and Krylov iterations)."""
    return _rail_sweep(dev, n, mesh, method, "bell", config)


def ros2_sweep(dev, n, mesh=None, **config):
    """`bell_sweep`'s Ros2 sweep on DIA operands, split over ``mesh`` in
    ``PREC_BS``-row blocks."""
    return _rail_sweep(dev, n, mesh, "ros2", "dia", config)


def solve_sharded(mesh, op, W, alg):
    """``prepare(op, alg).solve(W)`` (`ops.blocklinear`) on the rank's
    shards of ``op`` and ``W`` (`shard_block`), under ``mesh``, gathered;
    in one process without a mesh.  Returns (the solution, Krylov
    iterations)."""
    from ..ops.blocklinear import prepare
    from .mesh import shard_operator, shard_tall, unshard_tall, use_mesh

    n, block = op.shape[0], shard_block(op)
    if mesh is not None:
        op, W = shard_operator(mesh, op, block=block), shard_tall(mesh, W, block)
    with use_mesh(mesh):
        x, kry = _counted(lambda: prepare(op, alg).solve(W))
    return (x if mesh is None else unshard_tall(mesh, x, n, block)), kry


def compress_sharded(mesh, X):
    """``lr_compress(method="gram")`` of ``X`` split over ``mesh`` in
    ``PREC_BS``-row blocks, gathered; in one process without a mesh."""
    from ..lowrank import LowRank, lr_compress
    from ..models.compiled import PREC_BS
    from .mesh import shard_lowrank, unshard_tall, use_mesh

    if mesh is None:
        return lr_compress(X, method="gram")
    with use_mesh(mesh):
        Y = lr_compress(shard_lowrank(mesh, X, PREC_BS), method="gram")
    return LowRank(L=unshard_tall(mesh, Y.L, X.n, PREC_BS), D=Y.D, k=Y.k)


def lr_dense(X) -> torch.Tensor:
    return X.L @ X.D @ X.L.T


def compare_steps(name, sharded, ref) -> dict:
    """Hold a sharded step's (X, K, ADI iterations, residual, Krylov
    iterations) against one process's: equal ADI iterations, Krylov
    iterations within `KRYLOV_TOL`, X and K within `STEP_TOL`.  Returns the
    differences."""
    X, K, it, _, kry = sharded
    Xr, Kr, itr, _, kryr = ref
    dX, dK = _rel(lr_dense(X), lr_dense(Xr)), _rel(K, Kr)
    if not (it == itr and abs(kry - kryr) <= KRYLOV_TOL * kryr
            and dX <= STEP_TOL and dK <= STEP_TOL):
        raise AssertionError(f"sharded {name}: ADI {it} vs {itr}, Krylov {kry} vs {kryr}, "
                             f"X {dX:.3e}, K {dK:.3e} (limit {STEP_TOL})")
    return {"adi_iters": it, "krylov": (kry, kryr), "dX": dX, "dK": dK}


def _parareal_problem(dev, n=96, slabs=2, tau=20.0):
    """The JAX dry run's parareal configuration (its
    ``parallel/dryrun.py:110-126``): the n=96 Rail surrogate, τ = 20, one
    step per slab, 3 real shifts, capacity 64."""
    import scipy.sparse.linalg as spla

    from ..lowrank import lowrank, lr_with_capacity
    from ..models.problems import GDREProblem
    from ..ops.dia import dia_pencil
    from ..utils.testmat import rail_surrogate

    E, A, B, C = rail_surrogate(n)
    E_op, A_op = dia_pencil(E, A, device=dev)
    q = C.shape[0]
    L0 = spla.splu(E.tocsc()).solve(np.asarray(C).T.copy())
    X0 = lr_with_capacity(lowrank(torch.as_tensor(L0, device=dev),
                                  0.01 * torch.eye(q, dtype=torch.float64, device=dev)), 64)
    t = lambda M: torch.as_tensor(M, device=dev)  # noqa: E731
    return GDREProblem(E_op, A_op, t(B), t(C), X0, (4500.0, 4500.0 - tau * slabs)), tau


def _run_parareal(mesh, dev, slabs):
    from ..models.compiled import CompiledConfig
    from ..models.parareal import Parareal, solve_gdre_parareal

    prob, tau = _parareal_problem(dev, slabs=slabs)
    kw = dict(dt=-tau, shifts=np.asarray([-0.5, -1.5, -3.0]),
              cfg=CompiledConfig(maxiters=8, compression_interval=4, r_res=16),
              capacity=64, alg=Parareal(slabs=slabs, max_iters=1), abstol=1e-8)
    sol = solve_gdre_parareal(prob, mesh=mesh, **kw)
    ref = solve_gdre_parareal(prob, **kw)
    dK = max(_rel(a, b) for a, b in zip(sol.K[1:], ref.K[1:]))
    if not (dK <= PARAREAL_TOL and np.isfinite(sol.adi_res_max)):
        raise AssertionError(f"parareal over {mesh.size()} ranks: K {dK:.3e} from one "
                             f"process (limit {PARAREAL_TOL}), res {sol.adi_res_max}")
    return dK, sol.parareal_info


def _dryrun_rank(dev):
    import torch.distributed as dist

    from .mesh import make_mesh

    world = dist.get_world_size()
    n = 256 * world
    mesh = make_mesh(world, device=dev.type)
    worst = _check_products(mesh, dev, n, 16)
    steps = {name: compare_steps(name, run(dev, n, mesh), run(dev, n))
             for name, run in (("ros1", ros1_step_sharded), ("newton", newton_step_sharded))}
    dK, info = _run_parareal(make_mesh(world, device=dev.type, axis="slab"), dev, world)
    return worst, steps, dK, info["iterations"], info["fine_iters_total"]


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Spawn ``n_devices`` ranks on ``device`` (default the card: one GPU per
    rank, NCCL; ``"cpu"``: gloo) and run the sharded products, the sharded
    Ros1 and Newton steps and one parareal iteration over them (see the
    module docstring); print and return the result.  Raises if a rank fails
    or the run outlasts `DEADLINE` seconds."""
    from ..config import resolve_device

    worst, steps, dK, iters, fine_iters = run_ranks(_dryrun_rank, n_devices, device)
    res = {"ranks": n_devices, "device": resolve_device(device).type,
           "n": 256 * n_devices, "products_max_rel": worst, "ros1_step": steps["ros1"],
           "newton_step": steps["newton"], "parareal_dK": dK,
           "parareal_iterations": iters, "parareal_fine_iters": fine_iters}
    r, nt = steps["ros1"], steps["newton"]
    print(f"dryrun_multichip: {n_devices} ranks on {res['device']}: sharded DIA and "
          f"block-ELL products within {worst:.2e} of the unsharded ones; at "
          f"n={res['n']} the sharded Ros1 step ({r['adi_iters']} ADI iterations) X "
          f"{r['dX']:.2e}, K {r['dK']:.2e} and Newton step ({nt['adi_iters']} ADI "
          f"iterations) X {nt['dX']:.2e} from one process; parareal ({n_devices} slabs, "
          f"{iters} iteration) K within {dK:.2e} of one process")
    return res

"""Multi-rank dry run: the row-sharded products and parareal over ranks.

Port of the JAX package's ``parallel/dryrun.py``.  `dryrun_multichip`
spawns ``n_devices`` ranks (one process each, a `torch.distributed` group
over ``tcp://localhost``), builds a 1-D mesh (`mesh.make_mesh`) and, on tiny
shapes:

* holds the row-sharded DIA product (`sharded_ops.ShardedDiaOp`, ``mm`` and
  ``tmm``, halo exchange + K1) and the row-sharded block-ELL product
  (`sharded_ops.ShardedBellSpmm`, halo exchange + K2) against the unsharded
  ones;
* runs one parareal iteration with ``slabs = n_devices``, the slabs' fine
  sweeps split over the ranks (`models.parareal.solve_gdre_parareal` with
  ``mesh=``), and holds it against the same solve in one process.

Not run yet: the row-sharded compiled Ros1 and Newton steps of the JAX
package's dry run (its ``parallel/dryrun.py:45-94``), whose tall-skinny
contractions, Krylov dots and compressions would all become cross-rank
reductions.
"""

from __future__ import annotations

import socket

import numpy as np
import torch

#: What the dry run leaves out, printed with its result.
NOT_RUN = ("the row-sharded compiled Ros1 and Newton steps (the JAX package's "
           "parallel/dryrun.py:45-94) are not ported yet")
#: Sharded vs unsharded products: f64 sums in the same order but for the
#: kernels' FMA contraction.
PRODUCT_TOL = 1e-12
#: Parareal over ranks vs one process: K within this, relative.
PARAREAL_TOL = 1e-10


def free_port() -> int:
    """A free TCP port on localhost (bound to port 0, then released)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rel(a: torch.Tensor, b: torch.Tensor) -> float:
    return float(torch.linalg.norm(a - b) / max(float(torch.linalg.norm(b)), 1e-300))


def _check_products(mesh, dev, n, bs):
    """Sharded DIA (mm, tmm) and block-ELL (mm, tmm) products on the Rail
    surrogate against the unsharded ones; returns the worst relative
    difference."""
    from ..ops.dia import dia_pencil
    from ..ops.sparse import bell_pencil
    from ..utils.testmat import rail_surrogate
    from .mesh import shard_operator, shard_tall, unshard_tall

    E, A, _, _ = rail_surrogate(n)
    X = torch.as_tensor(np.random.default_rng(3).standard_normal((n, 5)), device=dev)
    worst = 0.0
    for fmt, (_, op) in (("dia", dia_pencil(E, A, device=dev)),
                         ("bell", bell_pencil(E, A, bs=bs, device=dev))):
        block = 1 if fmt == "dia" else bs
        sh = shard_operator(mesh, op)
        X_l = shard_tall(mesh, X, block)
        for name, prod, ref in (("mm", sh.mm, op.mm), ("tmm", sh.tmm, op.tmm)):
            Y = unshard_tall(mesh, prod(X_l), n, block)
            rel = _rel(Y, ref(X))
            if not rel <= PRODUCT_TOL:
                raise AssertionError(f"sharded {fmt} {name}: rel {rel:.3e} > {PRODUCT_TOL}")
            worst = max(worst, rel)
    return worst


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


def _rank(rank, world, port, device, out):
    import torch.distributed as dist

    from .mesh import make_mesh

    torch.set_num_threads(1)
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"tcp://localhost:{port}",
                            world_size=world, rank=rank)
    try:
        mesh = make_mesh(world, device=device)
        if dev.type == "cuda":
            dev = torch.device("cuda", torch.cuda.current_device())
        worst = _check_products(mesh, dev, 64 * world, 16)
        meshs = make_mesh(world, device=device, axis="slab")
        dK, info = _run_parareal(meshs, dev, world)
        if rank == 0:
            out.put((worst, dK, info["iterations"], info["fine_iters_total"]))
    finally:
        dist.destroy_process_group()


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Spawn ``n_devices`` ranks on ``device`` (default the card: one GPU per
    rank, NCCL; ``"cpu"``: gloo), run the sharded products and one parareal
    iteration over them (see the module docstring), print and return the
    result.  Raises if a rank fails."""
    import torch.multiprocessing as mp

    from ..config import resolve_device

    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() < n_devices:
        raise RuntimeError(f"{n_devices} ranks need {n_devices} GPUs, found "
                           f"{torch.cuda.device_count()}")
    out = mp.get_context("spawn").SimpleQueue()
    ranks = mp.start_processes(_rank, args=(n_devices, free_port(), dev.type, out),
                               nprocs=n_devices, join=False, start_method="spawn")
    result = None
    # Drain the queue while waiting: a writer blocks on a full pipe.  join
    # raises as soon as a rank fails.
    while not ranks.join(timeout=1):
        if result is None and not out.empty():
            result = out.get()
    worst, dK, iters, fine_iters = result if result is not None else out.get()
    res = {"ranks": n_devices, "device": dev.type, "products_max_rel": worst,
           "parareal_dK": dK, "parareal_iterations": iters,
           "parareal_fine_iters": fine_iters, "not_run": NOT_RUN}
    print(f"dryrun_multichip: {n_devices} ranks on {dev.type}: sharded DIA and "
          f"block-ELL products within {worst:.2e} of the unsharded ones; parareal "
          f"({n_devices} slabs, {iters} iteration) K within {dK:.2e} of one process; "
          f"not run: {NOT_RUN}")
    return res

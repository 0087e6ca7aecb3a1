"""Device-mesh sharding for the DRE solver stack.

Port of the JAX package's ``parallel/mesh.py``.  Its single abstraction is a
1-D ``jax.sharding.Mesh`` with the problem dimension **row-partitioned**;
here it is a 1-D `torch.distributed.device_mesh.DeviceMesh` over an
initialised process group, one rank per device (NCCL with one GPU per rank
on the card, gloo on the CPU):

* operators are split by rows: a DIA operator's diagonals by columns of its
  storage, a block-ELL operator by block rows (`shard_operator`);
* tall-skinny factors ``L (n, r)`` and operands are split by rows
  (`shard_tall`, `shard_lowrank`; the placement `row_sharded`);
* small inner factors ``D`` and shift buffers are held whole by every rank
  (`shard_replicated`; the placement `replicated`).

Each rank holds its row shard as a plain tensor.  JAX's ``shard_map`` needs
equal shards, hence the JAX package's ``pad_to=``; point-to-point sends do
not, so rows split unevenly here: ``⌈n/W⌉`` rows (or blocks of rows) per
rank and a shorter last shard (`row_range`), with no padding.  The compiled
steps split whole 128-row blocks (``block=PREC_BS``), so that each rank's
block-Jacobi blocks are the global ones.

**Reductions over rows.**  JAX's GSPMD inserts a ``psum`` wherever a product
contracts over the problem dimension.  Here that is written out: every such
contraction (``BᵀL``, ``WᵀW``, the Krylov dots, the SMW's small systems, the
TSQR of `lowrank.lr_compress`) goes through `row_allreduce` or
`row_allgather`, which reduce over the ranks of the mesh made active by
`use_mesh` (JAX's ``with mesh:``), and are the identity without one.  The
compiled steps enter the mesh of their row-sharded operator themselves
(`on_operator_mesh`): sharded operands select the sharded path.  A row
shard's product raises outside ``use_mesh(its mesh)``, so none runs
without the reductions around it.  A feedback
``K = BᵀXE`` of a sharded step comes out split by columns.
"""

from __future__ import annotations

import collections
import contextlib
import datetime
import functools

import torch

from ..config import resolve_device

AXIS = "x"
#: Every process group of the port gets this timeout: a rank whose peers
#: never join a collective raises instead of hanging.
GROUP_TIMEOUT = datetime.timedelta(seconds=60)
#: Collectives run by the row-sharded paths in this process, by kind:
#: ``all_reduce`` (`row_allreduce`), ``all_gather`` (`row_allgather`) and
#: ``halo_exchange`` (`sharded_ops.halo_exchange`, one per product).
collectives = collections.Counter()
_active = None  # the mesh of `use_mesh`


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` the mesh that `row_allreduce` and `row_allgather`
    reduce over (``None``: no mesh, they are the identity) until the block
    ends."""
    global _active
    prev, _active = _active, mesh
    try:
        yield mesh
    finally:
        _active = prev


def active_mesh():
    """The mesh of the innermost `use_mesh`, or ``None``."""
    return _active


def mesh_of(op):
    """The mesh of a row-sharded operator (through a low-rank update's
    base), or ``None`` for an unsharded one."""
    from ..ops.operators import LowRankUpdateOp

    return getattr(op.A if isinstance(op, LowRankUpdateOp) else op, "mesh", None)


def on_operator_mesh(fn):
    """Run ``fn(E, ...)`` under ``use_mesh(mesh_of(E))``: with a row-sharded
    ``E`` every reduction over rows inside it is an all-reduce over the
    mesh's ranks, with an unsharded one none."""
    @functools.wraps(fn)
    def run(E, *args, **kw):
        with use_mesh(mesh_of(E)):
            return fn(E, *args, **kw)
    return run


def on_problem_mesh(fn):
    """Run ``fn(prob, ...)`` under ``use_mesh(mesh_of(prob.E))``: the
    whole-solver counterpart of `on_operator_mesh`."""
    @functools.wraps(fn)
    def run(prob, *args, **kw):
        with use_mesh(mesh_of(prob.E)):
            return fn(prob, *args, **kw)
    return run


def row_allreduce(t: torch.Tensor) -> torch.Tensor:
    """The sum of ``t`` over the ranks of the active mesh (a new tensor),
    or ``t`` itself without one."""
    if _active is None:
        return t
    import torch.distributed as dist

    t = t.clone(memory_format=torch.contiguous_format)
    dist.all_reduce(t, group=_active.get_group())
    collectives["all_reduce"] += 1
    return t


def row_allgather(t: torch.Tensor) -> list[torch.Tensor]:
    """Every rank's ``t`` (all of one shape), in rank order, over the active
    mesh; ``[t]`` without one."""
    if _active is None:
        return [t]
    import torch.distributed as dist

    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(_active.size())]
    dist.all_gather(parts, t, group=_active.get_group())
    collectives["all_gather"] += 1
    return parts


def row_norm(t: torch.Tensor) -> torch.Tensor:
    """Frobenius norm of a tensor split by rows (or columns) over the
    active mesh; ``torch.linalg.norm`` without one or with one rank (whose
    shard is the whole tensor: a one-rank run then takes the unsharded
    run's roundings, as `lowrank._tsqr` does)."""
    if _active is None or _active.size() == 1:
        return torch.linalg.norm(t)
    return torch.sqrt(row_allreduce(torch.linalg.norm(t) ** 2))


def make_mesh(n_devices: int | None = None, device=None, axis: str = AXIS):
    """A 1-D `DeviceMesh` named ``axis`` over the initialised default
    process group, whose size must be ``n_devices`` (default: the group's).

    ``device`` defaults to the card (`config.resolve_device`: it raises
    where there is none).  On the card the group must be NCCL and every rank
    needs its own GPU: NCCL puts no two ranks on one GPU, so fewer GPUs than
    ranks raises rather than falling back.  ``"cpu"`` needs a gloo group."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    dev = resolve_device(device)
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("make_mesh needs an initialised process group "
                           "(torch.distributed.init_process_group)")
    W = dist.get_world_size()
    if n_devices is not None and n_devices != W:
        raise ValueError(f"a mesh of {n_devices} ranks over a group of {W}")
    backend = dist.get_backend()
    if dev.type == "cuda":
        if backend != "nccl":
            raise ValueError(f"a mesh on the card needs an NCCL group, got {backend}")
        count = torch.cuda.device_count()
        if count < W:
            raise RuntimeError(f"{W} ranks need {W} GPUs, found {count}: NCCL "
                               "puts no two ranks on one GPU")
        torch.cuda.set_device(dist.get_rank() % count)
    elif dev.type == "cpu":
        if backend != "gloo":
            raise ValueError(f"a mesh on the CPU needs a gloo group, got {backend}")
    else:
        raise ValueError(f"no mesh for device {dev}")
    return DeviceMesh(dev.type, list(range(W)), mesh_dim_names=(axis,))


def row_sharded(mesh):
    """The placement of a row-split tensor (``P("x", None)`` in JAX)."""
    from torch.distributed.tensor import Shard

    del mesh
    return (Shard(0),)


def replicated(mesh):
    """The placement of a tensor every rank holds whole (``P()``)."""
    from torch.distributed.tensor import Replicate

    del mesh
    return (Replicate(),)


def rank_and_size(mesh, rank: int | None = None, world: int | None = None):
    """``(rank, world)`` from ``mesh``, or given (emulated shards in one
    process: ``mesh=None`` with both given)."""
    if mesh is not None:
        rank = mesh.get_local_rank() if rank is None else rank
        world = mesh.size() if world is None else world
    if rank is None or world is None:
        raise ValueError("pass a mesh, or rank= and world=")
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    return rank, world


def row_range(n: int, world: int, rank: int, block: int = 1) -> tuple[int, int]:
    """Rows ``[r0, r1)`` of ``rank``: ``⌈⌈n/block⌉/world⌉`` blocks of
    ``block`` rows per rank, the last shard shorter.  Raises where a shard
    would be empty."""
    nb = -(-n // block)
    per = -(-nb // world)
    if (world - 1) * per >= nb:
        raise ValueError(f"{nb} rows (blocks of {block}) cannot be split over "
                         f"{world} ranks: the last shard would be empty")
    return rank * per * block, min((rank + 1) * per * block, n)


def _mesh_device(mesh, like: torch.Tensor):
    if mesh is None:
        return like.device
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def shard_operator(mesh, op, rank: int | None = None, world: int | None = None,
                   block: int = 1):
    """The rank's row shard of ``op``: a `ShardedDiaOp` (the diagonals over
    its rows, split in ``block``-row blocks: ``PREC_BS`` for the compiled
    steps) or a `ShardedBellOp` (its block rows, split in blocks of the
    operator's ``bs`` whatever ``block`` says, block columns rebased to the
    halo-extended operand), each with its halo width ``H``.  ``op`` is the
    whole operator, on the rank's device."""
    from ..ops.dia import DiaOp
    from ..ops.sparse import BellOp
    from .sharded_ops import ShardedBellOp, ShardedDiaOp

    rank, world = rank_and_size(mesh, rank, world)
    if isinstance(op, DiaOp):
        return ShardedDiaOp.from_op(mesh, op, rank, world, block)
    if isinstance(op, BellOp):
        return ShardedBellOp.from_op(mesh, op, rank, world)
    raise TypeError(f"cannot shard operator {type(op)}")


def shard_tall(mesh, M: torch.Tensor, block: int = 1, rank: int | None = None,
               world: int | None = None) -> torch.Tensor:
    """The rank's rows of a tall ``(n, ...)`` tensor (`row_range` with
    ``block``-row blocks: 1 for DIA, the block size for block-ELL)."""
    rank, world = rank_and_size(mesh, rank, world)
    r0, r1 = row_range(M.shape[0], world, rank, block)
    return M[r0:r1].to(_mesh_device(mesh, M)).contiguous()


def shard_lowrank(mesh, X, block: int = 1, rank: int | None = None,
                  world: int | None = None):
    """``X`` (a `LowRank`) with its outer factor split by rows, its inner
    factor whole."""
    from ..lowrank import LowRank

    return LowRank(L=shard_tall(mesh, X.L, block, rank, world),
                   D=shard_replicated(mesh, X.D), k=X.k)


def shard_replicated(mesh, M) -> torch.Tensor:
    """``M`` whole on the rank's device."""
    M = torch.as_tensor(M)
    return M.to(_mesh_device(mesh, M))


def unshard_tall(mesh, M_l: torch.Tensor, n: int, block: int = 1) -> torch.Tensor:
    """The whole ``(n, ...)`` tensor from every rank's rows ``M_l`` (an
    all-gather at the largest shard's shape, then trimmed)."""
    import torch.distributed as dist

    world = mesh.size()
    per = -(-(-(-n // block)) // world) * block
    buf = torch.zeros((per,) + tuple(M_l.shape[1:]), dtype=M_l.dtype, device=M_l.device)
    buf[:M_l.shape[0]] = M_l
    parts = [torch.empty_like(buf) for _ in range(world)]
    dist.all_gather(parts, buf, group=mesh.get_group())
    return torch.cat([p[:r1 - r0] for r, p in enumerate(parts)
                      for r0, r1 in [row_range(n, world, r, block)]])

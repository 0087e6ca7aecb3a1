"""Row-sharded DIA and block-ELL SpMMs with an explicit halo exchange.

Port of the JAX package's ``parallel/sharded_ops.py`` (`ShardedBellSpmm`)
and of its row-sharded DIA product ``ops/dia.py::_dia_mm_halo``.  The rows
are split over the ranks of a 1-D mesh (`mesh.row_range`); a banded
operator couples each shard only to ``H`` rows (DIA: ``H = max|offset|``;
block-ELL: ``H`` block rows, its block bandwidth) of each neighbour, so each
rank sends its first and last ``H`` rows to its neighbours and receives
theirs, both directions posted together (`dist.batch_isend_irecv`) so the
order cannot deadlock.  Ranks 0 and W−1 have no neighbour beyond the matrix
and take zeros there (the JAX version wraps around, harmlessly only because
the out-of-range weights are zero).

The local product on the halo-extended operand (``nl + 2H`` rows) goes
through the shard's own kernel: K1 (`kernels.dia_spmm`) with the shard's
diagonals zero-padded by ``H`` columns on each side, or K2
(`kernels.bell_spmm`) with block columns rebased to the extended operand and
``2H`` zero block rows appended so the kernel's output has the operand's
rows; on CPU tensors their plain versions.  The JAX package computes these
products in plain XLA; the port routes them through its kernels because its
operators do so on the card anyway.

Each operator also takes ``mesh=None`` with ``rank=`` and ``world=``: the
shard of one rank, built in one process, whose `extend` slices the
halo-extended operand from a whole one and whose `local_mm` runs the local
product (emulated shards: the exchange's result without the exchange).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import bell_spmm as k2
from ..kernels import dia_spmm as k1
from .mesh import rank_and_size, row_range


def _smallest_shard(n: int, world: int) -> int:
    per = -(-n // world)
    return min(per, n - (world - 1) * per)


def halo_exchange(X_l: torch.Tensor, H: int, mesh) -> torch.Tensor:
    """``[rows of the previous rank's last H | X_l | the next rank's first
    H]``, zeros where there is no neighbour."""
    import torch.distributed as dist

    rank, world = mesh.get_local_rank(), mesh.size()
    prev = X_l.new_zeros((H,) + tuple(X_l.shape[1:]))
    nxt = X_l.new_zeros((H,) + tuple(X_l.shape[1:]))
    group = mesh.get_group()
    ops = []
    if H and rank > 0:
        peer = dist.get_global_rank(group, rank - 1)
        ops += [dist.P2POp(dist.isend, X_l[:H].contiguous(), peer, group),
                dist.P2POp(dist.irecv, prev, peer, group)]
    if H and rank < world - 1:
        peer = dist.get_global_rank(group, rank + 1)
        ops += [dist.P2POp(dist.isend, X_l[X_l.shape[0] - H:].contiguous(), peer, group),
                dist.P2POp(dist.irecv, nxt, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([prev, X_l, nxt])


def _extend(X: torch.Tensor, r0: int, r1: int, H: int) -> torch.Tensor:
    """Rows ``[r0 − H, r1 + H)`` of a whole operand, zeros outside it."""
    n = X.shape[0]
    lo, hi = max(r0 - H, 0), min(r1 + H, n)
    return F.pad(X[lo:hi], (0, 0) * (X.dim() - 1) + (lo - (r0 - H), (r1 + H) - hi))


def _dia_mm_halo(data_l, offsets, X_l, H, mesh):
    """Row-sharded DIA SpMM: the halo exchange, then K1 on the extended
    operand with the shard's padded diagonals ``data_l`` (``(ndiag,
    nl + 2H)``); returns the shard's ``nl`` rows."""
    X_ext = halo_exchange(X_l, H, mesh)
    return k1.dia_mm(data_l, offsets, X_ext)[H:H + X_l.shape[0]]


@dataclasses.dataclass(frozen=True)
class ShardedDiaOp:
    """One rank's row shard ``[r0, r1)`` of a `DiaOp`: its diagonals over
    those rows with ``H`` zero columns on each side (``data``, and
    ``data_t`` for the transpose), products `mm`/`tmm` on the rank's rows of
    the operand."""

    data: torch.Tensor  # (ndiag, nl + 2H)
    data_t: torch.Tensor  # (ndiag, nl + 2H)
    offsets: tuple
    n: int
    rows: tuple  # (r0, r1)
    H: int
    mesh: object = None

    @classmethod
    def from_op(cls, mesh, op, rank: int, world: int) -> "ShardedDiaOp":
        r0, r1 = row_range(op.n, world, rank)
        H = max((abs(o) for o in op.offsets), default=0)
        if world > 1 and H > _smallest_shard(op.n, world):
            raise ValueError(f"halo {H} exceeds the {_smallest_shard(op.n, world)} "
                             "rows of the smallest shard; use fewer ranks")

        def pad(d):
            return F.pad(d[:, r0:r1], (H, H)).contiguous()

        return cls(data=pad(op.data), data_t=pad(op.data_t), offsets=op.offsets,
                   n=op.n, rows=(r0, r1), H=H, mesh=mesh)

    def extend(self, X: torch.Tensor) -> torch.Tensor:
        """The halo-extended operand the exchange delivers, sliced from the
        whole ``X``."""
        return _extend(X, *self.rows, self.H)

    def local_mm(self, X_ext: torch.Tensor, t: bool = False) -> torch.Tensor:
        """The shard's rows of ``A @ X`` (``Aᵀ @ X`` if ``t``) from the
        halo-extended operand ``X_ext`` (``(nl + 2H, q)`` or ``(nl + 2H,)``)."""
        if X_ext.dim() == 1:
            return self.local_mm(X_ext[:, None], t)[:, 0]
        if t:
            offs = tuple(-o for o in self.offsets)
            Y = k1.dia_mm(self.data_t, offs, X_ext)
        else:
            Y = k1.dia_mm(self.data, self.offsets, X_ext)
        return Y[self.H:self.H + self.rows[1] - self.rows[0]]

    def _mm(self, X_l, t):
        squeeze = X_l.dim() == 1
        if squeeze:
            X_l = X_l[:, None]
        if self.mesh is None:
            raise ValueError("an emulated shard has no exchange: use extend "
                             "and local_mm")
        if t:
            Y = _dia_mm_halo(self.data_t, tuple(-o for o in self.offsets), X_l,
                             self.H, self.mesh)
        else:
            Y = _dia_mm_halo(self.data, self.offsets, X_l, self.H, self.mesh)
        return Y[:, 0] if squeeze else Y

    def mm(self, X_l: torch.Tensor) -> torch.Tensor:
        """The rank's rows of ``A @ X`` from its rows ``X_l`` of ``X``."""
        return self._mm(X_l, False)

    def tmm(self, X_l: torch.Tensor) -> torch.Tensor:
        """The rank's rows of ``Aᵀ @ X`` from its rows ``X_l`` of ``X``."""
        return self._mm(X_l, True)


class ShardedBellSpmm:
    """``Y = A @ X`` for a row-sharded banded `BellOp`, on each rank's rows.

    Parameters
    ----------
    mesh : 1-D `DeviceMesh` (`mesh.make_mesh`), or ``None`` with ``rank=``
        and ``world=`` for an emulated shard.
    op : the whole `BellOp`, on the rank's device; its block bandwidth must
        not exceed the halo width ``halo`` (validated at construction).
    transpose : build the product with the transposed structure (``AᵀX``).

    Block rows split as `mesh.row_range` does (``⌈nb/W⌉`` per rank, the last
    shard shorter); a shard must hold at least ``halo`` block rows.
    """

    def __init__(self, mesh, op, halo: int | None = None, transpose: bool = False,
                 rank: int | None = None, world: int | None = None):
        self.mesh = mesh
        rank, world = rank_and_size(mesh, rank, world)
        cols = (op.cols_t if transpose else op.cols).cpu().numpy().astype(np.int64)
        data = op.data_t if transpose else op.data
        nb, K, bs, _ = data.shape
        b0, b1 = row_range(nb, world, rank)  # raises where a shard is empty
        per = -(-nb // world)
        rows = np.arange(nb)[:, None]
        band = np.abs(cols - rows)
        # Padded slots point at block 0 with all-zero data; exclude them
        # from the bandwidth estimate.
        real = (data != 0).flatten(2).any(dim=2).cpu().numpy()
        real_band = int(band[real].max()) if real.any() else 0
        H = real_band if halo is None else halo
        if real_band > H:
            raise ValueError(f"block bandwidth {real_band} exceeds halo {H}")
        self.halo = H = max(1, H)
        if H > _smallest_shard(nb, world):
            raise ValueError(f"halo {H} exceeds the {_smallest_shard(nb, world)} "
                             "block-rows of the smallest shard; use fewer ranks")
        # Neutralize padded slots: point them at the local diagonal so the
        # rebased index stays in range (their data is zero).
        cols = np.where(real, cols, rows)
        shard_start = (rows // per) * per
        shard_rows = np.minimum(shard_start + per, nb) - shard_start
        cols_reb = cols - shard_start + H
        if (cols_reb < 0).any() or (cols_reb >= shard_rows + 2 * H).any():
            raise ValueError("operator bandwidth exceeds one shard + halo; use "
                             "fewer ranks")
        nbl = b1 - b0
        # 2H zero block rows after the shard's: K2 then writes as many rows
        # as the extended operand has, of which the first nbl·bs are kept.
        cols_l = np.zeros((nbl + 2 * H, K), np.int32)
        cols_l[:nbl] = cols_reb[b0:b1]
        dev = data.device
        self.cols = torch.as_tensor(cols_l, device=dev)
        self.data = torch.cat([data[b0:b1], data.new_zeros((2 * H, K, bs, bs))]).contiguous()
        self.n, self.bs, self.nbl = op.n, bs, nbl
        self.rows = row_range(op.n, world, rank, bs)

    def extend(self, X: torch.Tensor) -> torch.Tensor:
        """The halo-extended operand (``(nbl + 2H)·bs`` rows) the exchange
        delivers, sliced from the whole ``X``."""
        r0 = self.rows[0]
        Xp = F.pad(X, (0, 0) * (X.dim() - 1) + (0, -(-self.n // self.bs) * self.bs - self.n))
        return _extend(Xp, r0, r0 + self.nbl * self.bs, self.halo * self.bs)

    def local_mm(self, X_ext: torch.Tensor) -> torch.Tensor:
        """The shard's rows of ``A @ X`` from the extended operand (2-D or
        1-D)."""
        if X_ext.dim() == 1:
            return self.local_mm(X_ext[:, None])[:, 0]
        Y = k2.bell_mm(self.cols, self.data, X_ext)
        return Y[:self.rows[1] - self.rows[0]]

    def __call__(self, X_l: torch.Tensor) -> torch.Tensor:
        """The rank's rows of ``A @ X`` from its rows ``X_l`` of ``X``."""
        squeeze = X_l.dim() == 1
        if squeeze:
            X_l = X_l[:, None]
        if self.mesh is None:
            raise ValueError("an emulated shard has no exchange: use extend "
                             "and local_mm")
        nl = X_l.shape[0]
        X_l = F.pad(X_l, (0, 0, 0, self.nbl * self.bs - nl))
        Y = self.local_mm(halo_exchange(X_l, self.halo * self.bs, self.mesh))
        return Y[:, 0] if squeeze else Y


class ShardedBellOp:
    """One rank's block-row shard of a `BellOp`: `mm` and `tmm` by a
    `ShardedBellSpmm` each (``fwd``, ``bwd``), on the rank's rows."""

    def __init__(self, mesh, op, rank: int | None = None, world: int | None = None):
        self.fwd = ShardedBellSpmm(mesh, op, None, False, rank, world)
        self.bwd = ShardedBellSpmm(mesh, op, None, True, rank, world)
        self.n, self.rows = op.n, self.fwd.rows

    def mm(self, X_l: torch.Tensor) -> torch.Tensor:
        return self.fwd(X_l)

    def tmm(self, X_l: torch.Tensor) -> torch.Tensor:
        return self.bwd(X_l)

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

The local product on the halo-extended operand (``nl + 2H`` rows, or
columns of a lane-major state) goes
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
from ..ops.dia import DiaOp, dia_scipy
from ..ops.sparse import BellOp
from .mesh import active_mesh, collectives, rank_and_size, row_range, unshard_tall


def _smallest_shard(n: int, world: int, block: int = 1) -> int:
    return min(r1 - r0 for r0, r1 in (row_range(n, world, r, block) for r in range(world)))


def halo_exchange(X_l: torch.Tensor, H: int, mesh, dim: int = 0) -> torch.Tensor:
    """``[the previous rank's last H | X_l | the next rank's first H]``
    along ``dim`` (0: rows of an ``(nl, q)`` operand; 1: columns of a
    lane-major ``(q, nl)`` one), zeros where there is no neighbour.  A
    complex operand travels as its real view."""
    import torch.distributed as dist

    if X_l.is_complex():
        return torch.view_as_complex(halo_exchange(torch.view_as_real(X_l), H, mesh, dim))

    rank, world = mesh.get_local_rank(), mesh.size()
    shape = list(X_l.shape)
    shape[dim] = H
    prev, nxt = X_l.new_zeros(shape), X_l.new_zeros(shape)
    group = mesh.get_group()
    ops = []
    nl = X_l.shape[dim]
    # The slices are strided along dim 1: the sends need their own copies.
    if H and rank > 0:
        peer = dist.get_global_rank(group, rank - 1)
        ops += [dist.P2POp(dist.isend, X_l.narrow(dim, 0, H).contiguous(), peer, group),
                dist.P2POp(dist.irecv, prev, peer, group)]
    if H and rank < world - 1:
        peer = dist.get_global_rank(group, rank + 1)
        ops += [dist.P2POp(dist.isend, X_l.narrow(dim, nl - H, H).contiguous(), peer, group),
                dist.P2POp(dist.irecv, nxt, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    collectives["halo_exchange"] += 1
    return torch.cat([prev, X_l, nxt], dim=dim)


def _exchange(mesh, X_l: torch.Tensor, H: int, dim: int) -> torch.Tensor:
    """`halo_exchange` for a shard's product, refused where it cannot span
    the ranks: for an emulated shard (no mesh) and outside
    ``use_mesh(mesh)``, where the reductions around the product would sum
    this rank alone."""
    if mesh is None:
        raise ValueError("an emulated shard has no exchange: use extend "
                         "and local_mm")
    if active_mesh() is not mesh:
        raise RuntimeError("a row-sharded product outside use_mesh(its mesh): "
                           "the reductions around it would not span the ranks")
    return halo_exchange(X_l, H, mesh, dim)


def _extend(X: torch.Tensor, r0: int, r1: int, H: int) -> torch.Tensor:
    """Rows ``[r0 − H, r1 + H)`` of a whole operand, zeros outside it."""
    n = X.shape[0]
    lo, hi = max(r0 - H, 0), min(r1 + H, n)
    return F.pad(X[lo:hi], (0, 0) * (X.dim() - 1) + (lo - (r0 - H), (r1 + H) - hi))


@dataclasses.dataclass(frozen=True)
class ShardedDiaOp(DiaOp):
    """One rank's row shard ``[r0, r1)`` of a `DiaOp`: its diagonals over
    those rows with ``H`` zero columns on each side (``data``, and
    ``data_t`` for the transpose), products on the rank's rows of the
    operand: `mm`/`tmm` on ``(nl, q)``, `mmT` on a lane-major ``(q, nl)``
    state (the Krylov solvers' layout).  Each product exchanges ``H`` rows
    (columns) with each neighbour (`halo_exchange`) and runs K1 on the
    extended operand.  It raises outside ``use_mesh(mesh)``: there the
    reductions over rows around it (`mesh.row_allreduce`) would sum this
    rank alone.

    It is the `DiaOp` it shards wherever the compiled steps read one:
    ``n`` and ``shape`` are global, ``N`` is the rank's ``nl`` (the length
    of its lane-major states), `diag` and `diag_blocks` are its own rows'
    (the global blocks when ``r0`` is a multiple of the block size), and
    `adjoint`, `ops.dia.dia_lin_comb` and ``dataclasses.replace`` keep the
    shard.  `to_scipy` gathers the whole operator (a collective); there is
    no `to_dense`."""

    rows: tuple = (0, 0)  # (r0, r1)
    H: int = 0
    mesh: object = None
    block: int = 1  # the rows come in whole blocks of this many (`row_range`)

    @classmethod
    def from_op(cls, mesh, op, rank: int, world: int, block: int = 1) -> "ShardedDiaOp":
        r0, r1 = row_range(op.n, world, rank, block)
        H = max((abs(o) for o in op.offsets), default=0)
        smallest = _smallest_shard(op.n, world, block)
        if world > 1 and H > smallest:
            raise ValueError(f"halo {H} exceeds the {smallest} rows of the smallest "
                             "shard; use fewer ranks")

        def pad(d):
            return F.pad(d[:, r0:r1], (H, H)).contiguous()

        return cls(data=pad(op.data), data_t=pad(op.data_t), offsets=op.offsets,
                   n=op.n, nnz_=op.nnz_, symmetric=op.symmetric, rows=(r0, r1), H=H,
                   mesh=mesh, block=block)

    @property
    def N(self) -> int:
        return self.rows[1] - self.rows[0]

    def _local(self) -> DiaOp:
        """The diagonals over the rank's rows, couplings to the halo
        dropped."""
        s = slice(self.H, self.H + self.N)
        return DiaOp(data=self.data[:, s], data_t=self.data_t[:, s], offsets=self.offsets,
                     n=self.N, nnz_=self.nnz_)

    def diag(self) -> torch.Tensor:
        return self._local().diag()

    def diag_blocks(self, bs: int = 128, pad_identity: bool = True) -> torch.Tensor:
        """The ``(⌈nl/bs⌉, bs, bs)`` diagonal blocks of the rank's rows (as
        `DiaOp.diag_blocks`).  Raises where the shard cuts a block: then
        they would not be the global operator's."""
        r0, r1 = self.rows
        if r0 % bs or (r1 % bs and r1 != self.n):
            raise ValueError(f"rows [{r0}, {r1}) cut a {bs}-row block: shard the "
                             f"operator with block={bs}")
        return self._local().diag_blocks(bs, pad_identity)

    def to_dense(self):
        raise NotImplementedError("a row shard has no whole form: gather the operator")

    def gather_rows(self, M_l: torch.Tensor) -> torch.Tensor:
        """The whole ``(n, ...)`` tensor from every rank's rows ``M_l``, split
        as this shard's rows are (an all-gather: every rank calls it)."""
        if self.mesh is None:
            raise ValueError("an emulated shard has no gather")
        return unshard_tall(self.mesh, M_l, self.n, self.block)

    def to_scipy(self):
        """scipy.sparse CSR copy of the whole operator, on every rank: the
        ranks' diagonals gathered (`gather_rows`), then `DiaOp.to_scipy`."""
        s = slice(self.H, self.H + self.N)
        data_t = self.gather_rows(self.data_t[:, s].T).T
        return dia_scipy(data_t, self.offsets, self.n)

    def extend(self, X: torch.Tensor) -> torch.Tensor:
        """The halo-extended operand the exchange delivers, sliced from the
        whole ``X``."""
        return _extend(X, *self.rows, self.H)

    def local_mm(self, X_ext: torch.Tensor, t: bool = False) -> torch.Tensor:
        """The shard's rows of ``A @ X`` (``Aᵀ @ X`` if ``t``) from the
        halo-extended operand ``X_ext`` (``(nl + 2H, q)`` or ``(nl + 2H,)``)."""
        if X_ext.dim() == 1:
            return self.local_mm(X_ext[:, None], t)[:, 0]
        offsets = tuple(-o for o in self.offsets) if t else self.offsets
        Y = self._product(lambda d, x: k1.dia_mm(d, offsets, x), X_ext, dim=1, t=t)
        return Y[self.H:self.H + self.N]

    def _exchange(self, X_l: torch.Tensor, dim: int) -> torch.Tensor:
        return _exchange(self.mesh, X_l, self.H, dim)

    def _mm(self, X_l, t):
        if X_l.dim() == 1:
            return self._mm(X_l[:, None], t)[:, 0]
        return self.local_mm(self._exchange(X_l, 0), t)

    def mm(self, X_l: torch.Tensor) -> torch.Tensor:
        """The rank's rows of ``A @ X`` from its rows ``X_l`` of ``X``."""
        return self._mm(X_l, False)

    def tmm(self, X_l: torch.Tensor) -> torch.Tensor:
        """The rank's rows of ``Aᵀ @ X`` from its rows ``X_l`` of ``X``."""
        return self._mm(X_l, True)

    def mmT(self, Xt_l: torch.Tensor) -> torch.Tensor:
        """Lane-major: the rank's columns of ``(A @ Xtᵀ)ᵀ`` from its
        columns ``Xt_l`` (``(q, nl)``) of ``Xt``."""
        Y = self._product(lambda d, x: k1.dia_mm_t(d, self.offsets, x),
                          self._exchange(Xt_l, 1), dim=0)
        return Y[:, self.H:self.H + self.N]

    def mmT_axpby(self, Xt_l: torch.Tensor, Z: torch.Tensor, alpha, beta) -> torch.Tensor:
        return alpha * self.mmT(Xt_l) + beta * Z


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
    shard shorter); a shard must hold at least ``halo`` block rows.  The
    product raises outside ``use_mesh(mesh)``.  `of` is the product of a
    `ShardedBellOp`'s stored structure.
    """

    def __init__(self, mesh, op, halo: int | None = None, transpose: bool = False,
                 rank: int | None = None, world: int | None = None):
        rank, world = rank_and_size(mesh, rank, world)
        cols = (op.cols_t if transpose else op.cols).cpu().numpy().astype(np.int64)
        data = op.data_t if transpose else op.data
        nb, K, bs, _ = data.shape
        b0, b1 = row_range(nb, world, rank)  # raises where a shard is empty
        per = -(-nb // world)
        rows = np.arange(nb)[:, None]
        # Padded slots follow a block row's sorted pattern and point at block
        # 0 with all-zero data (`ops.sparse._build_structure`).  They are
        # told by the pattern, not by the data, so that pattern-sharing
        # operators (a pencil's E and A) rebase alike and combine.
        has_data = (data != 0).flatten(1).any(dim=1).cpu().numpy()[:, None]
        real = (cols != 0) | ((np.arange(K)[None, :] == 0) & has_data)
        band = np.abs(cols - rows)
        real_band = int(band[real].max()) if real.any() else 0
        H = real_band if halo is None else halo
        if real_band > H:
            raise ValueError(f"block bandwidth {real_band} exceeds halo {H}")
        H = max(1, H)
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
        self._set(mesh, torch.as_tensor(cols_l, device=data.device),
                  torch.cat([data[b0:b1], data.new_zeros((2 * H, K, bs, bs))]).contiguous(),
                  H, row_range(op.n, world, rank, bs), op.n)

    def _set(self, mesh, cols, data, halo, rows, n):
        self.mesh, self.cols, self.data, self.halo, self.rows, self.n = (
            mesh, cols, data, halo, rows, n)
        self.bs = data.shape[-1]
        self.nbl = -(-(rows[1] - rows[0]) // self.bs)

    @classmethod
    def of(cls, op: "ShardedBellOp", t: bool = False) -> "ShardedBellSpmm":
        """The product of ``op``'s stored structure (its transposed one if
        ``t``), without a copy."""
        self = cls.__new__(cls)
        self._set(op.mesh, op.cols_t if t else op.cols, op.data_t if t else op.data,
                  op.H, op.rows, op.n)
        return self

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
        if X_l.dim() == 1:
            return self(X_l[:, None])[:, 0]
        X_l = F.pad(X_l, (0, 0, 0, self.nbl * self.bs - X_l.shape[0]))
        return self.local_mm(_exchange(self.mesh, X_l, self.halo * self.bs, 0))


@dataclasses.dataclass(frozen=True)
class ShardedBellOp(BellOp):
    """One rank's block-row shard ``[r0, r1)`` of a `BellOp`: ``cols``,
    ``data`` and ``cols_t``, ``data_t`` hold the rank's block rows of the
    forward and transposed structures, their block columns rebased to the
    halo-extended operand (``[H block rows of the previous rank | the
    rank's | H of the next]``), with ``2H`` block rows after them that no
    kept output reads (`ShardedBellSpmm`); ``diag_`` covers the rank's
    rows.  `mm` and `tmm` take the rank's rows of the operand, exchange
    ``H·bs`` rows with each neighbour and run K2 on the extended operand
    (`ShardedBellSpmm.of`); they raise outside ``use_mesh(mesh)``.

    It is the `BellOp` it shards wherever the compiled steps read one: ``n``
    and ``shape`` are global, ``nb`` is the rank's block rows, `diag_blocks`
    its own diagonal blocks (identity on the last rank's rows beyond
    ``n``), and `adjoint`, `ops.sparse.bell_lin_comb`, `bell_scale`,
    `ops.operators.op_astype` and ``dataclasses.replace`` keep the shard.
    Real storage only."""

    rows: tuple = (0, 0)  # (r0, r1)
    H: int = 0  # halo, in block rows
    mesh: object = None

    @classmethod
    def from_op(cls, mesh, op, rank: int, world: int) -> "ShardedBellOp":
        fwd, bwd = (ShardedBellSpmm(mesh, op, None, t, rank, world) for t in (False, True))
        if fwd.halo != bwd.halo:  # a nonsymmetric pattern: one halo for both
            H = max(fwd.halo, bwd.halo)
            fwd, bwd = (ShardedBellSpmm(mesh, op, H, t, rank, world) for t in (False, True))
        r0, r1 = fwd.rows
        return cls(cols=fwd.cols, data=fwd.data, cols_t=bwd.cols, data_t=bwd.data,
                   diag_=op.diag_[r0:r1].contiguous(), n=op.n, bs=op.bs, rows=fwd.rows,
                   H=fwd.halo, mesh=mesh)

    @property
    def nb(self) -> int:
        return -(-(self.rows[1] - self.rows[0]) // self.bs)

    def same_pattern(self, other: BellOp) -> bool:
        """`BellOp.same_pattern`, and the same rank's rows and halo."""
        return (super().same_pattern(other) and self.rows == other.rows
                and self.H == other.H)

    def diag_blocks(self) -> torch.Tensor:
        """The ``(nb, bs, bs)`` diagonal blocks of the rank's block rows:
        block row ``i`` at rebased block column ``i + H``; identity on the
        last rank's rows beyond ``n``, as `BellOp.diag_blocks`."""
        nb = self.nb
        row = torch.arange(nb, device=self.device)[:, None] + self.H
        hit = (self.cols[:nb] == row).to(self.dtype)
        blocks = torch.einsum("ik,ikab->iab", hit, self.data[:nb])
        pad = nb * self.bs - (self.rows[1] - self.rows[0])
        if pad:
            r = torch.arange(self.bs - pad, self.bs, device=self.device)
            blocks[-1, r, r] += 1
        return blocks

    def to_dense(self):
        raise NotImplementedError("a row shard has no whole form: gather the operator")

    def extend(self, X: torch.Tensor) -> torch.Tensor:
        """The halo-extended operand the exchange delivers, sliced from the
        whole ``X``."""
        return ShardedBellSpmm.of(self).extend(X)

    def local_mm(self, X_ext: torch.Tensor, t: bool = False) -> torch.Tensor:
        """The shard's rows of ``A @ X`` (``Aᵀ @ X`` if ``t``) from the
        halo-extended operand."""
        return ShardedBellSpmm.of(self, t).local_mm(X_ext)

    def mm(self, X_l: torch.Tensor) -> torch.Tensor:
        """The rank's rows of ``A @ X`` from its rows ``X_l`` of ``X``."""
        return ShardedBellSpmm.of(self)(X_l)

    def tmm(self, X_l: torch.Tensor) -> torch.Tensor:
        """The rank's rows of ``Aᵀ @ X`` from its rows ``X_l`` of ``X``."""
        if self.data_t is None:
            raise ValueError("this BellOp stores no transposed structure")
        return ShardedBellSpmm.of(self, True)(X_l)

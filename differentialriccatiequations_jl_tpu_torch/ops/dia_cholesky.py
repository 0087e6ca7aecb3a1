"""Block-tridiagonal Cholesky factor of a symmetric-definite `DiaOp`, for
direct solves on the operator's device.

Cut into blocks of ``b`` rows, where ``b`` is the smallest multiple of 128
that is at least the operator's largest ``|offset|``, a banded matrix is
block-tridiagonal: diagonal blocks ``Dᵢ`` and sub-diagonal blocks
``Cᵢ = M[i+1, i]`` (the last block padded with identity).

The factor is the Cholesky factor of the matrix with its blocks in
odd–even (cyclic-reduction) order, so that each level of it is batched.  At
a level of ``m`` blocks the even blocks couple only to their odd
neighbours:

* the even diagonal blocks are factored together, ``D₂ₖ = LₖLₖᵀ``, and
  kept inverted, ``Lₖ⁻¹``;
* each even block's couplings to its odd neighbours are kept as
  ``WLₖ = Lₖ⁻¹M[2k, 2k−1]`` and ``WRₖ = Lₖ⁻¹M[2k, 2k+1]``;
* the Schur complement on the odd blocks, ``D − WᵀW``, is block-tridiagonal
  again, with ``m/2`` blocks: the next level.

A solve runs the levels down (``uₖ = Lₖ⁻¹x₂ₖ``, the odd blocks less
``Wᵀu``) and back up (``y₂ₖ = Lₖ⁻ᵀ(uₖ − W y_odd)``): every product of a
level is one batched product, and only the ``2·log₂(nb)`` levels run in
sequence, where the natural block order would take ``2·nb`` dependent
``b × b`` products.  The factor keeps three sets of ``b × b`` blocks in all
(the inverted diagonal factors and the two couplings), ``3·nb·b²`` values.
Always float64.

Used by `models.shifts.heuristic_shifts_card` for the closed-loop Penzl
Arnoldi (the SuperLU solves of `heuristic_shifts_host`, on the card).
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .dia import DiaOp


class NotDefinite(ValueError):
    """The block Cholesky met a diagonal block that is not positive definite."""


def cholesky_block_size(op: DiaOp) -> int:
    """The smallest multiple of 128 that holds the operator's largest
    ``|offset|``: the matrix is block-tridiagonal in blocks of that size."""
    widest = max((abs(o) for o in op.offsets), default=0)
    return 128 * max(1, -(-widest // 128))


def _sub_blocks(op: DiaOp, b: int) -> torch.Tensor:
    """``(nb − 1, b, b)`` blocks ``M[(i+1)·b:, i·b:]`` below the diagonal
    (rows past ``n`` are zero): ``A[r, r + off] = data[d, r]`` for each
    negative offset lands in row ``s < −off`` of block ``i + 1`` and column
    ``s + b + off`` of block ``i``."""
    nb = -(-op.n // b)
    C = op.data.new_zeros((nb - 1, b, b))
    for d, off in enumerate(op.offsets):
        if off >= 0:
            continue
        w = F.pad(op.data[d, :op.n], (0, nb * b - op.n)).reshape(nb, b)
        s = torch.arange(-off, device=op.device)
        C[:, s, s + b + off] = w[1:, :-off]
    return C


@dataclasses.dataclass
class DiaCholesky:
    """The factor's levels (`dia_cholesky`); `solve` applies ``M⁻¹``."""

    # Per level of m blocks: (Lₖ⁻¹ of its ⌈m/2⌉ even blocks, WLₖ for k ≥ 1,
    # WRₖ for the ⌊m/2⌋ evens with a right neighbour).
    levels: list
    n: int
    b: int
    sign: float  # the factor is of sign·M

    @property
    def nbytes(self) -> int:
        return sum(t.numel() * t.element_size() for lev in self.levels for t in lev)

    def solve(self, X: torch.Tensor) -> torch.Tensor:
        """``M⁻¹X`` for ``X`` of shape ``(n,)`` or ``(n, q)`` (or padded to
        ``(nb·b, …)``); the result has ``X``'s rows."""
        squeeze = X.dim() == 1
        Xq = X[:, None] if squeeze else X
        rows, nb = Xq.shape[0], -(-self.n // self.b)
        Xp = F.pad(Xq.to(torch.float64), (0, 0, 0, nb * self.b - rows))
        Y = _sweep(self.levels, Xp.reshape(nb, self.b, -1)).reshape(nb * self.b, -1)[:rows]
        if self.sign != 1.0:
            Y = Y * self.sign
        return Y[:, 0] if squeeze else Y


def _sweep(levels, X: torch.Tensor) -> torch.Tensor:
    """``M⁻¹X`` for ``X (m, b, q)`` through the levels from the first."""
    if not levels:
        return X
    Linv, WL, WR = levels[0]
    m = X.shape[0]
    no = m // 2
    ne = m - no
    U = torch.bmm(Linv, X[0::2])
    Xo = X[1::2] - torch.bmm(WR.mT, U[:no])
    if ne > 1:
        Xo[:ne - 1].baddbmm_(WL.mT, U[1:], alpha=-1.0)
    Yo = _sweep(levels[1:], Xo)
    U[:no].baddbmm_(WR, Yo, alpha=-1.0)
    if ne > 1:
        U[1:].baddbmm_(WL, Yo[:ne - 1], alpha=-1.0)
    Y = torch.empty_like(X)
    Y[0::2] = torch.bmm(Linv.mT, U)
    Y[1::2] = Yo
    return Y


def dia_cholesky(op: DiaOp, negate: bool = False) -> DiaCholesky:
    """Block-tridiagonal Cholesky factor of ``op`` (of ``−op`` with
    ``negate``), which must be symmetric and definite; in float64 whatever
    the operator's dtype.  Raises `NotDefinite` where a diagonal block of the
    factorization is not positive definite (one device read, at the end)."""
    b = cholesky_block_size(op)
    sign = -1.0 if negate else 1.0
    op = dataclasses.replace(op, data=sign * op.data.to(torch.float64))
    D = op.diag_blocks(b)  # identity in the padding rows
    C = _sub_blocks(op, b)
    eye = torch.eye(b, dtype=D.dtype, device=D.device)
    levels, infos = [], []
    while True:
        m = D.shape[0]
        no = m // 2
        L, info = torch.linalg.cholesky_ex(D[0::2])
        infos.append(info)
        Linv = torch.linalg.solve_triangular(L, eye.expand(m - no, b, b), upper=False)
        del L
        WL = torch.bmm(Linv[1:], C[1::2])  # M[2k, 2k−1] = C[2k−1]
        WR = torch.bmm(Linv[:no], C[0::2].mT)  # M[2k, 2k+1] = C[2k]ᵀ
        levels.append((Linv, WL, WR))
        if no == 0:
            break
        # The odd blocks' Schur complement: block-tridiagonal in m/2 blocks.
        S = torch.baddbmm(D[1::2], WR.mT, WR, alpha=-1.0)
        S[:m - no - 1].baddbmm_(WL.mT, WL, alpha=-1.0)
        C = -torch.bmm(WR[1:].mT, WL[:no - 1])
        D = S
    if bool(torch.cat(infos).any()):
        raise NotDefinite(f"a {b}×{b} diagonal block of the {op.n}-row operator's "
                          "block Cholesky is not positive definite")
    return DiaCholesky(levels=levels, n=op.n, b=b, sign=sign)

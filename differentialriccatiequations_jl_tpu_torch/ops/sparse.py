"""Block-ELL sparse operators — the non-banded sparse path.

Port of the JAX package's ``ops/sparse.py``.  The matrix is tiled in
``bs × bs`` blocks and each block row stores a fixed number ``K`` of
column-block slots:

* ``cols: (nb, K) int32`` — block-column index per slot (0 for padding),
* ``data: (nb, K, bs, bs)`` — dense blocks (zeros for padding).

Transposed products use an explicitly built transposed structure
(``cols_t``, ``data_t``), so ``AᵀX`` runs through the same product.  Every
product goes through kernel K2 (`kernels.bell_spmm`): on a CUDA tensor in
f32 and f64 alike, complex operators and operands in real arithmetic
(`kernels.complex_route`), on a CPU tensor through its plain version.  Operators
built with `bell_pencil` share one block pattern, so ``Aᵀ + μEᵀ`` is a
single data combine.  Construction runs on the host in numpy.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..config import resolve_device
from ..kernels import bell_spmm as k2
from ..kernels import complex_route


@dataclasses.dataclass(frozen=True)
class BellOp(complex_route.SplitStorage):
    """Block-ELL sparse matrix with an explicit transposed structure.

    ``cols_t``/``data_t`` may be ``None`` for an operator that is only
    multiplied, never transposed (the shifted operators of
    `models.compiled.SparseShiftOps`); `tmm` then raises.
    """

    cols: torch.Tensor  # (nb, K) int32
    data: torch.Tensor  # (nb, K, bs, bs)
    cols_t: torch.Tensor | None  # (nb, Kt) int32
    data_t: torch.Tensor | None  # (nb, Kt, bs, bs)
    diag_: torch.Tensor  # (n,)
    n: int
    bs: int

    @property
    def shape(self):
        return (self.n, self.n)

    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def nb(self) -> int:
        return self.data.shape[0]

    @property
    def nnz(self) -> int:
        """Stored entries (dense blocks)."""
        return self.data.numel()

    def diag(self) -> torch.Tensor:
        return self.diag_

    def same_pattern(self, other: "BellOp") -> bool:
        """Whether ``other`` can combine with this operator block by block
        (`bell_lin_comb`): of the same kind, block pattern and sizes."""
        return (type(other) is type(self) and self.cols.shape == other.cols.shape
                and self.n == other.n and self.bs == other.bs)

    def diag_blocks(self) -> torch.Tensor:
        """(nb, bs, bs) diagonal blocks — block-Jacobi preconditioner data.

        Padded slots point at block 0, so in block row 0 they also hit; they
        hold zeros, so the sum is unchanged (the JAX package's semantics).
        Unlike the JAX package, the rows of the last block beyond ``n`` get
        identity, so the block stays regular when ``n % bs ≠ 0`` (the JAX
        block is singular there and its inverse is ``inf``).
        """
        nb = self.nb
        row = torch.arange(nb, device=self.device)[:, None]
        hit = (self.cols == row).to(self.dtype)
        blocks = torch.einsum("ik,ikab->iab", hit, self.data)
        pad = nb * self.bs - self.n
        if pad:
            r = torch.arange(self.bs - pad, self.bs, device=self.device)
            blocks[-1, r, r] += 1
        return blocks

    def mm(self, X: torch.Tensor) -> torch.Tensor:
        return _bell_mm(self, X, t=False)

    def tmm(self, X: torch.Tensor) -> torch.Tensor:
        if self.data_t is None:
            raise ValueError("this BellOp stores no transposed structure")
        return _bell_mm(self, X, t=True)

    def adjoint(self) -> "BellOp":
        return dataclasses.replace(self, cols=self.cols_t, data=self.data_t,
                                   cols_t=self.cols, data_t=self.data)

    def to_dense(self) -> torch.Tensor:
        nb, K, bs, _ = self.data.shape
        M = self.data.new_zeros((nb * bs, nb * bs))
        cols = self.cols.cpu().tolist()
        for i in range(nb):
            for k in range(K):
                c = cols[i][k]
                M[i * bs:(i + 1) * bs, c * bs:(c + 1) * bs] += self.data[i, k]
        return M[:self.n, :self.n]


def _bell_mm(op: BellOp, X, t: bool):
    """``A @ X`` (``Aᵀ @ X`` if ``t``) for ``X: (n, q)`` or ``(n,)``."""
    squeeze = X.dim() == 1
    if squeeze:
        X = X[:, None]
    cols = op.cols_t if t else op.cols
    Y = op._product(lambda d, x: k2.bell_mm(cols, d, x), X, dim=1, t=t)[:op.n]
    return Y[:, 0] if squeeze else Y


# --- construction (host side) -------------------------------------------------


def _block_pattern(coo, nb, bs):
    """Unique (block-row → sorted block-cols) pattern, vectorized over nnz."""
    keys = np.unique((coo.row // bs).astype(np.int64) * nb + (coo.col // bs))
    bi, bj = keys // nb, keys % nb
    pat = {}
    for i, j in zip(bi, bj):  # loops over blocks (≤ nb·K), not nonzeros
        pat.setdefault(int(i), []).append(int(j))
    return pat


def _build_structure(M_csr, nb, bs, pattern, dtype):
    """Scatter CSR entries into the ``(nb, K, bs, bs)`` slot buffer (numpy).

    One vectorized assignment over the nonzeros; the Python loops run over
    the block pattern only.
    """
    K = max((len(v) for v in pattern.values()), default=1)
    K = max(K, 1)
    cols = np.zeros((nb, K), np.int32)
    slot_mat = np.full((nb, nb), -1, np.int8 if K < 127 else np.int32)
    for i, js in pattern.items():
        for s, j in enumerate(sorted(js)):
            cols[i, s] = j
            slot_mat[i, j] = s
    M_csr.sum_duplicates()  # canonical ⇒ plain fancy assignment is exact
    coo = M_csr.tocoo()
    bi = coo.row // bs
    bj = coo.col // bs
    slots = slot_mat[bi, bj].astype(np.int64)
    if (slots < 0).any():
        raise ValueError("matrix entry outside the supplied block pattern")
    data = np.zeros((nb, K, bs, bs), dtype)
    data[bi, slots, coo.row % bs, coo.col % bs] = coo.data.astype(dtype)
    return cols, data


def bell_from_scipy(M, bs: int = 128, dtype: torch.dtype | None = None,
                    pattern=None, pattern_t=None, device=None) -> BellOp:
    """Convert a scipy sparse matrix to `BellOp` (host-side, setup only) on
    ``device`` (default the card: `config.resolve_device`)."""
    import scipy.sparse as sp

    device = resolve_device(device)
    M = sp.csr_matrix(M)
    n = M.shape[0]
    np_dt = M.dtype if dtype is None else torch.empty((), dtype=dtype).numpy().dtype
    nb = -(-n // bs)
    pat = pattern if pattern is not None else _block_pattern(M.tocoo(), nb, bs)
    Mt = M.T.tocsr()
    pat_t = pattern_t if pattern_t is not None else _block_pattern(Mt.tocoo(), nb, bs)

    def dev(a):
        return torch.as_tensor(a, device=device)

    cols, data = _build_structure(M, nb, bs, pat, np_dt)
    cols, data = dev(cols), dev(data)  # one host slot buffer alive at a time
    cols_t, data_t = _build_structure(Mt, nb, bs, pat_t, np_dt)
    cols_t, data_t = dev(cols_t), dev(data_t)
    diag = np.zeros(n, np_dt)
    d = M.diagonal()
    diag[:len(d)] = d
    return BellOp(cols=cols, data=data, cols_t=cols_t, data_t=data_t,
                  diag_=dev(diag), n=n, bs=bs)


def bell_pencil(E, A, bs: int = 128, dtype: torch.dtype | None = None, device=None):
    """Build (E_op, A_op) on the **union** block pattern so shifted combines
    ``A + cE`` are pure data arithmetic; on ``device`` (default the card)."""
    import scipy.sparse as sp

    device = resolve_device(device)
    E = sp.csr_matrix(E)
    A = sp.csr_matrix(A)
    nb = -(-E.shape[0] // bs)
    U = (E != 0) + (A != 0)
    pat = _block_pattern(U.tocoo(), nb, bs)
    pat_t = _block_pattern(U.T.tocoo(), nb, bs)
    E_op = bell_from_scipy(E, bs, dtype, pattern=pat, pattern_t=pat_t, device=device)
    A_op = bell_from_scipy(A, bs, dtype, pattern=pat, pattern_t=pat_t, device=device)
    return E_op, A_op


# --- algebra on shared patterns ----------------------------------------------


def _combine(a, c, b):
    """``a + c·b``, or ``None`` where either side stores nothing."""
    return None if a is None or b is None else a + c * b


def bell_lin_comb(A: BellOp, c, E: BellOp) -> BellOp:
    """``A + c·E`` for pattern-sharing operators (see `bell_pencil`), row
    shards of them (`parallel.sharded_ops.ShardedBellOp`) included: the
    result is ``A`` with the combined data."""
    if not A.same_pattern(E):
        raise ValueError("bell_lin_comb requires pattern-sharing operators "
                         "(build them with bell_pencil)")
    return dataclasses.replace(A, data=_combine(A.data, c, E.data),
                               data_t=_combine(A.data_t, c, E.data_t),
                               diag_=A.diag_ + c * E.diag_)


def bell_scale(A: BellOp, c) -> BellOp:
    return dataclasses.replace(A, data=c * A.data,
                               data_t=None if A.data_t is None else c * A.data_t,
                               diag_=c * A.diag_)


def shifted_bell(E: BellOp, A: BellOp, mu) -> BellOp:
    """Operator ``Aᵀ + μEᵀ`` as a `BellOp` (fused data combine)."""
    return bell_lin_comb(A.adjoint(), mu, E.adjoint())

"""DIA (diagonal-storage) sparse operators — the banded/stencil fast path.

Port of the JAX package's ``ops/dia.py``.  A banded matrix is stored as one
vector per structural diagonal:

* ``offsets: (ndiag,)`` ascending ints — ``A[i, i + off_d] = data[d, i]``,
* ``data: (ndiag, N)`` — zero where ``i + off_d`` falls outside the matrix.

Transposes use a pre-shifted copy ``data_t[d, i] = data[d, i - off_d]`` with
negated offsets, so ``AᵀX`` runs through the same product.  Every product
goes through kernel K1 (`kernels.dia_spmm`): on a CUDA tensor in f32 and
f64 alike, complex operators and operands in real arithmetic
(`kernels.complex_route`), on a CPU tensor through its plain version.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..config import resolve_device
from ..kernels import complex_route
from ..kernels import dia_spmm as k1


@dataclasses.dataclass(frozen=True)
class DiaOp(complex_route.SplitStorage):
    """Banded sparse matrix in diagonal storage.

    ``data``/``data_t`` may be padded beyond ``n`` columns; padded entries
    are zero.  ``symmetric`` is a tri-state structure hint set at
    construction (`dia_from_scipy` checks the host matrix): ``True`` ⇒
    exactly symmetric, ``False`` ⇒ known nonsymmetric, ``None`` ⇒ unknown.
    Krylov selection uses it: CG on the negated shifted pencil is only
    valid when the pencil is symmetric.
    """

    data: torch.Tensor  # (ndiag, N) with N >= n
    data_t: torch.Tensor  # (ndiag, N): data_t[d, i] = data[d, i - offsets[d]]
    offsets: tuple  # ints, ascending
    n: int
    nnz_: int  # structural nonzeros (csr-equivalent), set at construction
    symmetric: bool | None = None

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
    def N(self) -> int:
        return self.data.shape[1]

    @property
    def nnz(self) -> int:
        """Structural (csr-equivalent) nonzeros — the honest nnz/s unit."""
        return self.nnz_

    def diag(self) -> torch.Tensor:
        if 0 not in self.offsets:
            return self.data.new_zeros((self.n,))
        return self.data[self.offsets.index(0), :self.n]

    def diag_blocks(self, bs: int = 128, pad_identity: bool = True) -> torch.Tensor:
        """(nb, bs, bs) diagonal blocks (block-Jacobi preconditioner data).

        Couplings crossing a block boundary are dropped.  ``pad_identity=False``
        omits the identity in the padding rows (n..Np) so blocks of pencil
        members can be linearly combined without double-counting it.
        """
        nb = -(-self.n // bs)
        Np = nb * bs
        blocks = self.data.new_zeros((nb, bs, bs))
        for d, off in enumerate(self.offsets):
            if abs(off) >= bs:
                continue
            w = F.pad(self.data[d, :self.n], (0, Np - self.n)).reshape(nb, bs)
            r = torch.arange(max(0, -off), bs - max(0, off), device=self.device)
            blocks[:, r, r + off] += w[:, r]
        if pad_identity:
            # identity in the padding rows keeps the blocks regular
            pad = (torch.arange(Np, device=self.device).reshape(nb, bs)
                   >= self.n).to(self.dtype)
            r = torch.arange(bs, device=self.device)
            blocks[:, r, r] += pad
        return blocks

    def mm(self, X: torch.Tensor) -> torch.Tensor:
        return _dia_mm(self, X, t=False)

    def tmm(self, X: torch.Tensor) -> torch.Tensor:
        return _dia_mm(self, X, t=True)

    def mmT(self, Xt: torch.Tensor) -> torch.Tensor:
        """Lane-major SpMM ``(A @ Xtᵀ)ᵀ`` on a ``(q, N)`` operand; the
        Krylov solvers keep their whole state in this layout."""
        return self._product(lambda d, x: k1.dia_mm_t(d, self.offsets, x), Xt, dim=0)

    def mmT_axpby(self, Xt: torch.Tensor, Z: torch.Tensor, alpha, beta) -> torch.Tensor:
        """``α·(A @ Xtᵀ)ᵀ + β·Z`` in lane-major layout, the epilogue fused
        into the kernel (after it, on the complex route)."""
        if self._by_parts(Xt):
            return alpha * self.mmT(Xt) + beta * Z
        return k1.dia_mm_t(self.data, self.offsets, Xt, Z=Z, alpha=alpha,
                           beta=beta)

    def adjoint(self) -> "DiaOp":
        # Reverse so the (negated) offsets stay ascending.
        return dataclasses.replace(
            self, data=torch.flip(self.data_t, [0]), data_t=torch.flip(self.data, [0]),
            offsets=tuple(-o for o in reversed(self.offsets)))

    def to_scipy(self):
        """scipy.sparse CSR copy (host-side helpers only)."""
        return dia_scipy(self.data_t, self.offsets, self.n)

    def to_dense(self) -> torch.Tensor:
        n = self.n
        M = self.data.new_zeros((n, n))
        for d, off in enumerate(self.offsets):
            i0, i1 = max(0, -off), min(n, n - off)
            if i1 <= i0:
                continue
            rows = torch.arange(i0, i1, device=self.device)
            M[rows, rows + off] += self.data[d, i0:i1]
        return M


def dia_scipy(data_t: torch.Tensor, offsets, n: int):
    """scipy.sparse CSR matrix from transposed diagonal storage: scipy's DIA
    convention indexes diagonals by column, which is ``data_t``."""
    import scipy.sparse as sp

    return sp.dia_matrix((data_t[:, :n].cpu().numpy(), np.asarray(offsets, np.int64)),
                         shape=(n, n)).tocsr()


def _dia_mm(op: DiaOp, X, t: bool):
    """``A @ X`` (``Aᵀ @ X`` if ``t``) for ``X: (n, q)``, ``(N, q)`` or
    ``(n,)``."""
    squeeze = X.dim() == 1
    if squeeze:
        X = X[:, None]
    if X.shape[0] != op.N:
        X = F.pad(X, (0, 0, 0, op.N - X.shape[0]))
    offsets = tuple(-o for o in op.offsets) if t else op.offsets
    Y = op._product(lambda d, x: k1.dia_mm(d, offsets, x), X, dim=1, t=t)[:op.n]
    return Y[:, 0] if squeeze else Y


# --- construction (host side) -------------------------------------------------


def _dia_arrays(M_csr, offsets, n, N, dtype):
    """Scatter CSR entries into (ndiag, N) diagonal storage (numpy)."""
    coo = M_csr.tocoo()
    coo.sum_duplicates()
    diff = coo.col.astype(np.int64) - coo.row.astype(np.int64)
    off_arr = np.asarray(offsets, np.int64)
    d_idx = np.searchsorted(off_arr, diff)
    if (d_idx >= len(off_arr)).any() or (off_arr[d_idx] != diff).any():
        raise ValueError("matrix entry outside the supplied diagonal set")
    data = np.zeros((len(offsets), N), dtype)
    data[d_idx, coo.row] = coo.data.astype(dtype)
    data_t = np.zeros_like(data)
    for d, off in enumerate(offsets):
        if off >= 0:
            data_t[d, off:] = data[d, :N - off] if off else data[d]
        else:
            data_t[d, :N + off] = data[d, -off:]
    return data, data_t


def dia_offsets(M) -> tuple:
    """The set of structurally nonzero diagonals of a scipy sparse matrix."""
    coo = M.tocoo()
    return tuple(int(o) for o in np.unique(coo.col.astype(np.int64) - coo.row))


def _scipy_symmetric(M) -> bool:
    """Exact symmetry of a host sparse matrix (setup-time, O(nnz))."""
    d = (M - M.T).tocoo()
    return bool(d.nnz == 0 or np.all(d.data == 0))


def dia_from_scipy(M, dtype: torch.dtype | None = None, offsets=None,
                   device=None) -> DiaOp:
    """Convert a scipy sparse matrix to `DiaOp` (host-side, setup only) on
    ``device`` (default the card: `config.resolve_device`)."""
    import scipy.sparse as sp

    device = resolve_device(device)
    M = sp.csr_matrix(M)
    n = M.shape[0]
    np_dt = M.dtype if dtype is None else torch.empty((), dtype=dtype).numpy().dtype
    offs = tuple(offsets) if offsets is not None else dia_offsets(M)
    data, data_t = _dia_arrays(M, offs, n, n, np_dt)
    return DiaOp(data=torch.as_tensor(data, device=device),
                 data_t=torch.as_tensor(data_t, device=device),
                 offsets=offs, n=n, nnz_=int(M.nnz),
                 symmetric=_scipy_symmetric(M))


def dia_pencil(E, A, dtype: torch.dtype | None = None, device=None):
    """Build (E_op, A_op) on the **union** diagonal set so shifted combines
    ``A + cE`` are pure data arithmetic; on ``device`` (default the card)."""
    import scipy.sparse as sp

    device = resolve_device(device)
    E = sp.csr_matrix(E)
    A = sp.csr_matrix(A)
    U = ((E != 0) + (A != 0)).tocsr()
    offs = dia_offsets(U)
    nnz_union = int(U.nnz)
    E_op = dia_from_scipy(E, dtype, offsets=offs, device=device)
    A_op = dia_from_scipy(A, dtype, offsets=offs, device=device)
    return (dataclasses.replace(E_op, nnz_=nnz_union),
            dataclasses.replace(A_op, nnz_=nnz_union))


def is_banded(M, max_diags: int = 64) -> bool:
    """Heuristic: is DIA storage efficient for this matrix?"""
    try:
        return len(dia_offsets(M)) <= max_diags
    except (AttributeError, TypeError, ValueError):  # not a scipy sparse matrix
        return False


# --- algebra on shared diagonal sets -------------------------------------------


def _same_pattern(a: DiaOp, b: DiaOp) -> bool:
    return type(a) is type(b) and a.offsets == b.offsets and a.n == b.n and a.N == b.N


def _combined_symmetry(a, b):
    if a is True and b is True:
        return True
    if a is False or b is False:
        return False
    return None


def dia_lin_comb(A: DiaOp, c, E: DiaOp) -> DiaOp:
    """``A + c·E`` for diagonal-set-sharing operators (see `dia_pencil`),
    row shards of them (`parallel.sharded_ops.ShardedDiaOp`) included."""
    if not _same_pattern(A, E):
        raise ValueError("dia_lin_comb requires operators sharing a diagonal "
                         "set (build them with dia_pencil)")
    return dataclasses.replace(A, data=A.data + c * E.data, data_t=A.data_t + c * E.data_t,
                               symmetric=_combined_symmetry(A.symmetric, E.symmetric))


def dia_scale(A: DiaOp, c) -> DiaOp:
    return dataclasses.replace(A, data=c * A.data, data_t=c * A.data_t)


def shifted_dia(E: DiaOp, A: DiaOp, mu) -> DiaOp:
    """Operator ``Aᵀ + μEᵀ`` as a `DiaOp` (fused data combine)."""
    return dia_lin_comb(A.adjoint(), mu, E.adjoint())


@dataclasses.dataclass(frozen=True)
class DiaPairOp:
    """All-real stacked form of the complex shifted operator ``F + i·b·Eᵀ``
    (``F = Aᵀ + a·Eᵀ``, shift ``μ = a + b·i``): the complex system
    ``(F + i·bEᵀ)(Vr + i·Vi) = W`` is the real 2n block system
    ``[[F, −bEᵀ], [bEᵀ, F]] [Vr; Vi] = [W; 0]``.  Lane-major states stack
    real and imaginary parts along the q axis, ``(2q, N)``, so each
    application is four real DIA SpMMs and K1 stays real-only."""

    F: DiaOp  # Aᵀ + a·Eᵀ (real part of the shifted operator)
    Et: DiaOp  # Eᵀ
    b: float  # imaginary part of the shift

    @property
    def dtype(self):
        return self.F.dtype

    @property
    def N(self) -> int:
        return self.F.N

    def mmT(self, Xt: torch.Tensor) -> torch.Tensor:
        q = Xt.shape[0] // 2
        Xr, Xi = Xt[:q], Xt[q:]
        b = self.b
        return torch.cat([
            self.F.mmT(Xr) - b * self.Et.mmT(Xi),
            b * self.Et.mmT(Xr) + self.F.mmT(Xi),
        ])

    def mm(self, X: torch.Tensor) -> torch.Tensor:
        """Column-stacked form: ``X`` is ``(n, 2q)`` with real | imag
        column blocks."""
        q = X.shape[1] // 2
        Xr, Xi = X[:, :q], X[:, q:]
        b = self.b
        return torch.cat([
            self.F.mm(Xr) - b * self.Et.mm(Xi),
            b * self.Et.mm(Xr) + self.F.mm(Xi),
        ], dim=1)

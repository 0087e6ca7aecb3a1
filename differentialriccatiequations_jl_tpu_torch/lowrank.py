"""Low-rank symmetric indefinite (LDLᵀ) factorizations.

Port of the JAX package's ``lowrank.py``, keeping its padded-capacity
layout so outputs compare one to one (and CUDA-graph capture stays possible
later):

    ``X ≈ L[:, :k] @ D[:k, :k] @ L[:, :k].T``

* ``L: (n, r)`` — outer factor, columns ``>= k`` are exactly zero,
* ``D: (r, r)`` — symmetric inner factor, zero outside ``[:k, :k]``,
* ``k`` — active (storage) rank, a host ``int``.

The JAX package traces ``k``; here it lives on the host, so column placement
is plain slicing.  `lr_compress` reads the new rank back from the device
(one sync per compression).

Under a mesh (`parallel.mesh.use_mesh`) ``L`` is split by rows over its
ranks and ``D`` is whole on each: `lr_norm` and `lr_dot` all-reduce their
small Gram products, and `lr_compress` orthogonalizes by a TSQR or by the
Cholesky factor of an all-reduced Gram matrix.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch
import torch.nn.functional as F

from .config import COMPRESSION_RTOL_FACTOR, as_tensor, resolve_device
from .parallel.mesh import active_mesh, row_allgather, row_allreduce


@dataclasses.dataclass(frozen=True)
class LowRank:
    """Padded low-rank factorization ``L[:, :k] D[:k, :k] L[:, :k]ᵀ``."""

    L: torch.Tensor  # (n, r)
    D: torch.Tensor  # (r, r)
    k: int  # active rank

    @property
    def n(self) -> int:
        return self.L.shape[0]

    @property
    def r(self) -> int:
        """Buffer width (storage capacity)."""
        return self.L.shape[1]

    @property
    def dtype(self) -> torch.dtype:
        return self.L.dtype

    @property
    def device(self) -> torch.device:
        return self.L.device

    def to_dense(self) -> torch.Tensor:
        return lr_to_dense(self)


def _mask_cols(L: torch.Tensor, k: int) -> torch.Tensor:
    """Zero columns with index >= k."""
    return F.pad(L[:, :k], (0, L.shape[1] - min(k, L.shape[1])))


def _mask_inner(D: torch.Tensor, k: int) -> torch.Tensor:
    """Zero entries outside the leading [:k, :k] block."""
    pad = D.shape[0] - min(k, D.shape[0])
    return F.pad(D[:k, :k], (0, pad, 0, pad))


def lowrank(L, D=None, k: int | None = None, *, device=None) -> LowRank:
    """Construct a `LowRank` from (possibly unpadded) factors.

    ``D`` may be a matrix, a 1-D vector of diagonal entries, or ``None``
    (identity).  ``k`` defaults to the full width of ``L``; with ``k`` the
    factors are masked to establish the zero-padding invariant.  A tensor
    ``L`` keeps its device; a numpy one goes to ``device`` (default the
    card: `config.resolve_device`).  ``D`` follows ``L``.
    """
    L = as_tensor(L, device)
    r = L.shape[1]
    if D is None:
        D = torch.eye(r, dtype=L.dtype, device=L.device)
    else:
        D = torch.as_tensor(D, dtype=L.dtype, device=L.device)
        if D.dim() == 1:
            D = torch.diag(D)
    if tuple(D.shape) != (r, r):
        raise ValueError(f"inner factor must be ({r},{r}), got {tuple(D.shape)}")
    if k is None:
        return LowRank(L=L, D=D, k=r)
    k = int(k)
    return LowRank(L=_mask_cols(L, k), D=_mask_inner(D, k), k=k)


def lr_zero(n: int, r: int, dtype: torch.dtype, device=None) -> LowRank:
    """Rank-0 factorization with storage capacity ``r`` on ``device``
    (default the card: `config.resolve_device`)."""
    device = resolve_device(device)
    return LowRank(L=torch.zeros((n, r), dtype=dtype, device=device),
                   D=torch.zeros((r, r), dtype=dtype, device=device), k=0)


def lr_scale(alpha: float, X: LowRank) -> LowRank:
    """``alpha * X`` (the inner factor scaled)."""
    return LowRank(L=X.L, D=alpha * X.D, k=X.k)


def lr_neg(X: LowRank) -> LowRank:
    return lr_scale(-1.0, X)


def lr_with_capacity(X: LowRank, r_new: int) -> LowRank:
    """Return ``X`` with the buffer grown/shrunk to width ``r_new``.

    Shrinking below the active rank truncates storage columns (run
    `lr_compress` first to make truncation numerically meaningful).
    """
    r = X.r
    if r_new == r:
        return X
    if r_new > r:
        pad = r_new - r
        return LowRank(L=F.pad(X.L, (0, pad)), D=F.pad(X.D, (0, pad, 0, pad)),
                       k=X.k)
    return LowRank(L=X.L[:, :r_new], D=X.D[:r_new, :r_new], k=min(X.k, r_new))


def _shift_cols(L: torch.Tensor, offset: int) -> torch.Tensor:
    """Shift columns right by ``offset``, dropping overflow."""
    return F.pad(L, (offset, 0))[:, :L.shape[1]]


def _shift_diag(D: torch.Tensor, offset: int) -> torch.Tensor:
    """Shift the inner factor diagonally by ``offset``."""
    r = D.shape[0]
    return F.pad(D, (offset, 0, offset, 0))[:r, :r]


def lr_add(X: LowRank, Y: LowRank, r_out: int | None = None) -> LowRank:
    """Lazy sum ``X + Y``: append ``Y``'s active term after ``X``'s.

    The output buffer width is ``r_out`` (default ``max(X.r, Y.r)``).
    Columns of ``Y`` beyond the remaining capacity are **dropped**, with a
    `RuntimeWarning`; callers compress before capacity is exceeded.  The
    compiled paths, which drop columns by design, call `lr_append`.
    """
    r_out = r_out if r_out is not None else max(X.r, Y.r)
    if X.k + Y.k > r_out:
        warnings.warn(
            f"lr_add: combined active rank {X.k + Y.k} exceeds output capacity "
            f"{r_out}; trailing columns dropped — compress first or enlarge "
            f"r_out", RuntimeWarning, stacklevel=2)
    return lr_append(X, Y, r_out)


def lr_append(X: LowRank, Y: LowRank, r_out: int | None = None) -> LowRank:
    """`lr_add` without the capacity warning: columns of ``Y`` beyond
    ``r_out`` are dropped silently."""
    if X.n != Y.n:
        raise ValueError(f"outer dimensions must match, got {X.n} and {Y.n}")
    r_out = r_out if r_out is not None else max(X.r, Y.r)
    Xb = lr_with_capacity(X, r_out)
    Yb = lr_with_capacity(Y, r_out)
    off = min(Xb.k, r_out)
    L = Xb.L + _shift_cols(Yb.L, off)
    D = Xb.D + _shift_diag(Yb.D, off)
    return LowRank(L=L, D=D, k=min(Xb.k + Yb.k, r_out))


def lr_sub(X: LowRank, Y: LowRank, r_out: int | None = None) -> LowRank:
    return lr_add(X, lr_neg(Y), r_out=r_out)


def lr_concat_terms(terms, r_out: int | None = None) -> LowRank:
    """Concatenate several factorizations into one fresh sum."""
    acc = terms[0]
    if r_out is not None:
        acc = lr_with_capacity(acc, r_out)
    for t in terms[1:]:
        acc = lr_add(acc, t, r_out=acc.r if r_out is None else r_out)
    return acc


def lr_to_dense(X: LowRank) -> torch.Tensor:
    """Materialize the ``n × n`` matrix (testing only)."""
    return X.L @ X.D @ X.L.T


def lr_norm(X: LowRank) -> torch.Tensor:
    """Frobenius norm without forming the n×n matrix:
    ``‖L D Lᵀ‖²_F = tr((D·LᵀL)²)``.  Padded zero columns contribute nothing."""
    DM = X.D @ row_allreduce(X.L.T @ X.L)
    return torch.sqrt(torch.clamp(torch.trace(DM @ DM), min=0.0))


def lr_dot(X: LowRank, Y: LowRank) -> torch.Tensor:
    """Frobenius inner product ``tr(X Y) = tr(D₁ M D₂ Mᵀ)`` with the small
    ``M = L₁ᵀL₂``; padded columns contribute zeros."""
    M = row_allreduce(X.L.T @ Y.L)
    return torch.trace(X.D @ M @ Y.D @ M.T)


def lr_rank(X: LowRank) -> int:
    """Active storage rank."""
    return X.k


def _robust_eigh(S: torch.Tensor):
    """`eigh` hardened against entry magnitudes spanning ~30 orders:
    normalize by the largest entry and flush relative ~eps² entries to
    zero — far below any compression threshold."""
    scale = S.abs().max()
    safe = torch.where(scale > 0, scale, torch.ones_like(scale))
    tiny = torch.finfo(S.dtype).eps ** 2
    Sx = S / safe
    Sx = torch.where(Sx.abs() < tiny, torch.zeros_like(Sx), Sx)
    lam, V = torch.linalg.eigh(Sx)
    return lam * safe, V


def _tsqr(L: torch.Tensor):
    """``Q, R`` of a reduced QR of ``L`` split by rows over the active mesh
    (TSQR): each rank's Householder QR ``L_l = Q_l R_l``, an all-gather of
    the ``R_l`` (``min(nl, r)`` rows each), the QR of their stack
    ``Q_s R``, run by every rank on the same input, and the rank's rows
    ``Q_l · Q_s[its block]`` of ``Q``.  ``R`` is the same on every rank.
    Without a mesh, or with one rank, the plain QR."""
    mesh = active_mesh()
    if mesh is None or mesh.size() == 1:
        return torch.linalg.qr(L)
    Q_l, R_l = torch.linalg.qr(L)
    m_l, r = R_l.shape
    # R_l padded to r rows, its row count in an extra row: one all-gather.
    buf = R_l.new_zeros((r + 1, r))
    buf[:m_l] = R_l
    buf[r, 0] = m_l
    parts = row_allgather(buf)
    sizes = [int(m) for m in torch.stack([p[r, 0] for p in parts]).tolist()]
    Q_s, R = torch.linalg.qr(torch.cat([p[:m] for p, m in zip(parts, sizes)]))
    off = sum(sizes[:mesh.get_local_rank()])
    return Q_l @ Q_s[off:off + m_l], R


def _gram(L: torch.Tensor):
    """``(LᵀL, n)`` of ``L`` split by rows over the active mesh: both in
    one all-reduce, the global row count ``n`` as a device scalar (no host
    read).  Without a mesh ``LᵀL`` and the host int ``L.shape[0]``."""
    if active_mesh() is None:
        return L.T @ L, L.shape[0]
    r = L.shape[1]
    buf = torch.cat([L.T @ L, L.new_zeros((1, r))])
    buf[r, 0] = L.shape[0]
    buf = row_allreduce(buf)
    return buf[:r], buf[r, 0]


def _ridge_factor(n, dtype: torch.dtype):
    """``1 + √n`` as the gram route scales its ridge: in double, then in
    ``dtype`` (a host ``n``'s rounding, for a device scalar too)."""
    if isinstance(n, int):
        return 1.0 + n ** 0.5
    return (1.0 + n.double().sqrt()).to(dtype)


def lr_compress(X: LowRank, r_out: int | None = None,
                method: str | None = None) -> LowRank:
    """Column compression: orthogonalization + eigendecomposition + cut.

    * ``method="qr"`` — Householder QR of ``L`` (the f64 default);
    * ``method="gram"`` — Cholesky of the Gram matrix ``LᵀL`` with the
      adaptive ridge (the f32 default): factor with a flat ``10·eps`` ridge
      and take the ``(1 + √n)``-scaled ridge only where that breaks down.

    Truncation keeps eigenvalues with ``|λ| > 100 · max|λ| · eps``; kept
    columns are packed to the front, sorted by decreasing magnitude (stable
    sort, as ``jnp.argsort``).  Reads the new rank back to the host: one
    sync per compression.

    Under a mesh, ``L`` split by rows: the QR is a TSQR (`_tsqr`), the Gram
    matrix an all-reduce (`_gram`), so every rank computes the same
    Cholesky factor (the ridge retry included), eigendecomposition, cut and
    rank from the same small matrix, and keeps its rows of the new ``L``.
    """
    L, D = X.L, X.D
    n, r = L.shape
    finfo = torch.finfo(L.dtype)
    if method is None:
        method = "gram" if L.dtype == torch.float32 else "qr"
    R = None
    if method == "qr":
        # Q: (n, m), R: (m, r); m = min(n, r), the full-rank route through
        # the smaller dimension where r > n.
        Q, R = _tsqr(L)
        m = R.shape[0]
        S = R @ D @ R.T
    elif method == "gram":
        m = r
        Q = None
        M, n = _gram(L)
        maxdiag = torch.diagonal(M).max()
        flat = torch.clamp(10.0 * finfo.eps * maxdiag, min=finfo.tiny)
        ridge = torch.clamp(_ridge_factor(n, M.dtype) * flat, min=finfo.tiny)
        eye = torch.eye(r, dtype=M.dtype, device=M.device)
        Lc0, info0 = torch.linalg.cholesky_ex(M + flat * eye)
        Lc1, _ = torch.linalg.cholesky_ex(M + ridge * eye)
        bad = (info0 != 0) | ~torch.isfinite(Lc0).all()
        R = torch.where(bad, Lc1, Lc0).T  # L ≈ Q R, R upper triangular
        S = R @ D @ R.T
    else:
        raise ValueError(f"unknown compression method {method!r}")
    S = 0.5 * (S + S.T)
    lam, V = _robust_eigh(S)  # ascending by value
    order = torch.argsort(-lam.abs(), stable=True)
    lam = lam[order]
    V = V[:, order]
    cut = torch.clamp(COMPRESSION_RTOL_FACTOR * lam.abs().max() * finfo.eps,
                      min=finfo.tiny)
    keep = lam.abs() > cut
    k_new = int(keep.sum())  # host sync: the rank is a host int
    lam = torch.where(keep, lam, torch.zeros_like(lam))
    Vk = V * keep[None, :].to(V.dtype)
    if Q is None:
        # L R⁻¹ Vk with R upper triangular (gram route)
        L_new = L @ torch.linalg.solve_triangular(R, Vk, upper=True)
    else:
        L_new = Q @ Vk  # (n, m)
    D_new = torch.diag(lam)
    r_out = r_out if r_out is not None else r
    if m < r_out:
        L_new = F.pad(L_new, (0, r_out - m))
        D_new = F.pad(D_new, (0, r_out - m, 0, r_out - m))
    elif m > r_out:
        L_new = L_new[:, :r_out]
        D_new = D_new[:r_out, :r_out]
        k_new = min(k_new, r_out)
    return LowRank(L=L_new, D=D_new, k=k_new)


def round_up(k: int, bucket: int = 16) -> int:
    """Bucket a storage width (the JAX package's recompile guard; here it
    keeps the widths, and so the arithmetic, the same as there)."""
    return max(bucket, -(-int(k) // bucket) * bucket)


def lr_slice_active(X: LowRank, bucket: int = 16) -> LowRank:
    """Shrink the buffer to the (bucketed) active rank, so that wide
    assemblies downstream scale with the numerical rank and not with the
    storage capacity.  Compressed factorizations keep their active columns
    in front, so this is a slice."""
    return lr_with_capacity(X, min(X.r, round_up(max(X.k, 1), bucket)))

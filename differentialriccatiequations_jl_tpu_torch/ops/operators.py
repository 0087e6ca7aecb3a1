"""Linear operators: dense and low-rank-updated, and their algebra over the
banded (`ops.dia`) and block-ELL (`ops.sparse`) kinds.

Port of the JAX package's ``ops/operators.py``.  The contract every
operator meets:

* ``op.mm(X)``  — ``A @ X``,
* ``op.tmm(X)`` — ``Aᵀ @ X``,
* ``op.to_dense()``,
* ``restrict(op, Q)`` — ``Qᵀ A Q`` (the Galerkin projection of the
  projection shifts).
"""

from __future__ import annotations

import dataclasses

import torch

from ..config import as_tensor
from ..parallel.mesh import row_allreduce
from .dia import DiaOp, dia_lin_comb, dia_scale
from .sparse import BellOp, bell_lin_comb, bell_scale


@dataclasses.dataclass(frozen=True)
class DenseOp:
    """Dense n×n operator.  A tensor ``M`` keeps its device; a numpy one
    goes to the card (`config.as_tensor`): pass a CPU tensor to build on
    the CPU."""

    M: torch.Tensor

    def __post_init__(self):
        object.__setattr__(self, "M", as_tensor(self.M))

    @property
    def shape(self):
        return tuple(self.M.shape)

    @property
    def dtype(self):
        return self.M.dtype

    @property
    def device(self):
        return self.M.device

    @property
    def nnz(self) -> int:
        return self.M.shape[0] * self.M.shape[1]

    def mm(self, X: torch.Tensor) -> torch.Tensor:
        return self.M @ X

    def tmm(self, X: torch.Tensor) -> torch.Tensor:
        return self.M.T @ X

    def to_dense(self) -> torch.Tensor:
        return self.M

    def adjoint(self) -> "DenseOp":
        return DenseOp(self.M.T)


@dataclasses.dataclass(frozen=True)
class LowRankUpdateOp:
    """Lazy ``A + α⁻¹ U V`` with low-rank ``U (n, m)``, ``V (m, n)``: kept
    lazy so Sherman–Morrison–Woodbury solves reuse the base operator's
    solver where only the feedback term ``B K`` changes.  Over a row-sharded
    base, ``U`` is split by rows and ``V`` by columns, and the products'
    contractions over n are all-reduced (`parallel.mesh.row_allreduce`)."""

    A: object  # base operator (DenseOp / DiaOp / BellOp)
    alpha: float | torch.Tensor  # scalar
    U: torch.Tensor  # (n, m)
    V: torch.Tensor  # (m, n)

    @property
    def shape(self):
        return self.A.shape

    @property
    def dtype(self):
        return self.A.dtype

    @property
    def device(self):
        return self.A.device

    def mm(self, X: torch.Tensor) -> torch.Tensor:
        return self.A.mm(X) + (1.0 / self.alpha) * (self.U @ row_allreduce(self.V @ X))

    def tmm(self, X: torch.Tensor) -> torch.Tensor:
        return self.A.tmm(X) + (1.0 / self.alpha) * (self.V.T @ row_allreduce(self.U.T @ X))

    def to_dense(self) -> torch.Tensor:
        return self.A.to_dense() + (1.0 / self.alpha) * (self.U @ self.V)

    def adjoint(self) -> "LowRankUpdateOp":
        # (A + α⁻¹UV)ᵀ = Aᵀ + α⁻¹ Vᵀ Uᵀ
        return LowRankUpdateOp(self.A.adjoint(), self.alpha, self.V.T, self.U.T)


def _scalar(alpha):
    return alpha if isinstance(alpha, torch.Tensor) else float(alpha)


def lr_update(A, alpha, U: torch.Tensor, V: torch.Tensor, device=None) -> LowRankUpdateOp:
    """``A + α⁻¹UV``.  Numpy ``A`` goes to ``device`` (`as_operator`), numpy
    ``U`` and ``V`` to the operator's device unless ``device`` is given;
    tensors keep theirs."""
    A = as_operator(A, device)
    dev = A.device if device is None else device
    return LowRankUpdateOp(A, _scalar(alpha), as_tensor(U, dev), as_tensor(V, dev))


def as_operator(A, device=None):
    """Coerce a raw tensor or array to an operator; pass operators through.
    A tensor keeps its device, a numpy array goes to ``device`` (default the
    card: `config.resolve_device`)."""
    if hasattr(A, "mm") and not isinstance(A, torch.Tensor):
        return A
    return DenseOp(as_tensor(A, device))


def restrict(op, Q: torch.Tensor) -> torch.Tensor:
    """Galerkin projection ``Qᵀ A Q`` (a small matrix)."""
    if isinstance(op, LowRankUpdateOp):
        core = restrict(op.A, Q)
        return core + (1.0 / op.alpha) * ((Q.T @ op.U) @ (op.V @ Q))
    return Q.T @ as_operator(op).mm(Q)


def operator_nnz(op) -> int:
    """Number of stored entries — the unit of nnz/s throughput."""
    if isinstance(op, LowRankUpdateOp):
        return operator_nnz(op.A) + op.U.numel() + op.V.numel()
    return op.nnz


def lin_comb(A, c, E):
    """Operator for ``A + c·E`` (e.g. the Rosenbrock coefficient
    ``A − E/(2τ)``).  Low-rank updates distribute over the base; dense
    bases combine eagerly; banded bases combine on their shared diagonals,
    block-ELL bases on their shared block pattern, row shards of banded
    bases on their rows' diagonals."""
    A = as_operator(A)
    E = as_operator(E)
    if isinstance(A, LowRankUpdateOp):
        return LowRankUpdateOp(lin_comb(A.A, c, E), A.alpha, A.U, A.V)
    if isinstance(A, DenseOp) and isinstance(E, DenseOp):
        return DenseOp(A.M + c * E.M)
    if isinstance(A, DiaOp) and isinstance(E, DiaOp):
        return dia_lin_comb(A, c, E)
    if isinstance(A, BellOp) and isinstance(E, BellOp):
        return bell_lin_comb(A, c, E)
    raise TypeError(f"lin_comb of {type(A).__name__} and {type(E).__name__} "
                    "is not supported")


def scale_op(A, c):
    """Operator for ``c·A``."""
    A = as_operator(A)
    if isinstance(A, LowRankUpdateOp):
        raise TypeError("scale the base and update separately")
    if isinstance(A, DenseOp):
        return DenseOp(c * A.M)
    if isinstance(A, DiaOp):
        return dia_scale(A, c)
    if isinstance(A, BellOp):
        return bell_scale(A, c)
    raise TypeError(f"cannot scale operator {type(A).__name__}")


def op_astype(op, dtype: torch.dtype):
    """Cast an operator's stored data to ``dtype``."""
    if isinstance(op, LowRankUpdateOp):
        alpha = op.alpha.to(dtype) if isinstance(op.alpha, torch.Tensor) else op.alpha
        return LowRankUpdateOp(op_astype(op.A, dtype), alpha,
                               op.U.to(dtype), op.V.to(dtype))
    if isinstance(op, DenseOp):
        return DenseOp(op.M.to(dtype))
    if isinstance(op, DiaOp):
        return dataclasses.replace(op, data=op.data.to(dtype),
                                   data_t=op.data_t.to(dtype))
    if isinstance(op, BellOp):
        return dataclasses.replace(
            op, data=op.data.to(dtype),
            data_t=None if op.data_t is None else op.data_t.to(dtype),
            diag_=op.diag_.to(dtype))
    raise TypeError(f"cannot cast operator {type(op)}")

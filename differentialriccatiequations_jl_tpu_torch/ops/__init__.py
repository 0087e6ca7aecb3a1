"""Operators and block linear solvers: dense, low-rank-updated, banded
(DIA) and block-ELL operators, the shifted pencils ``Aᵀ + μEᵀ`` and the
solvers prepared for them (the JAX package's ``ops`` names)."""

from .operators import (
    DenseOp,
    LowRankUpdateOp,
    lr_update,
    as_operator,
    restrict,
    operator_nnz,
)
from .blocklinear import (
    BlockLinearProblem,
    Backslash,
    ShermanMorrisonWoodbury,
    Krylov,
    prepare,
    solve_blocklinear,
)
from .shifted import shifted_operator, prepare_shifted, solve_shifted, default_inner_alg
from .dia import (
    DiaOp,
    dia_from_scipy,
    dia_pencil,
    dia_lin_comb,
    dia_scale,
    shifted_dia,
    is_banded,
)

__all__ = [
    "DiaOp",
    "dia_from_scipy",
    "dia_pencil",
    "dia_lin_comb",
    "dia_scale",
    "shifted_dia",
    "is_banded",
    "DenseOp",
    "LowRankUpdateOp",
    "lr_update",
    "as_operator",
    "restrict",
    "operator_nnz",
    "BlockLinearProblem",
    "Backslash",
    "ShermanMorrisonWoodbury",
    "Krylov",
    "prepare",
    "solve_blocklinear",
    "shifted_operator",
    "prepare_shifted",
    "solve_shifted",
    "default_inner_alg",
]

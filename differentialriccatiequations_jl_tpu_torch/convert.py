"""Build port objects from the JAX package's arrays, given as numpy arrays.

Lets a test feed both packages identical operators, factors and
precomputed shift tables (so, for example, block-inverse rounding is not
compared twice).  Never imports JAX: callers pass ``np.asarray(...)`` of the
JAX leaves, and static fields as plain Python values.
"""

from __future__ import annotations

import numpy as np
import torch

from .lowrank import LowRank
from .models.compiled import DiaShiftOps, SparseShiftOps
from .models.problems import GAREProblem
from .ops.blocklinear import Krylov
from .ops.dia import DiaOp
from .ops.sparse import BellOp


def _t(a, device):
    return None if a is None else torch.tensor(np.asarray(a), device=device)


def dia_op_from_numpy(data, data_t, offsets, n, nnz, symmetric=None,
                      device=None) -> DiaOp:
    """`DiaOp` from its diagonal storage."""
    return DiaOp(data=_t(data, device), data_t=_t(data_t, device),
                 offsets=tuple(int(o) for o in offsets), n=int(n),
                 nnz_=int(nnz), symmetric=symmetric)


def lowrank_from_numpy(L, D, k, device=None) -> LowRank:
    """`LowRank` from padded factors and the active rank."""
    return LowRank(L=_t(L, device), D=_t(D, device), k=int(k))


def gare_problem_from_numpy(E: dict, A: dict, G, Q, device=None) -> GAREProblem:
    """`GAREProblem` on banded operators: ``E`` and ``A`` are the keyword
    arguments of `dia_op_from_numpy` (the ``DiaOp`` storage), ``G`` and
    ``Q`` the ``(L, D, k)`` of the low-rank factors."""
    return GAREProblem(dia_op_from_numpy(**E, device=device),
                       dia_op_from_numpy(**A, device=device),
                       lowrank_from_numpy(*G, device=device),
                       lowrank_from_numpy(*Q, device=device))


def krylov_from(cfg) -> Krylov | None:
    """Port `Krylov` config from any object carrying the same fields (the
    JAX package's ``Krylov`` dataclass included)."""
    if cfg is None:
        return None
    return Krylov(method=cfg.method, tol=float(cfg.tol), atol=float(cfg.atol),
                  maxiter=int(cfg.maxiter), negate=bool(cfg.negate))


def dia_shift_ops_from_numpy(data, data_t, prec_inv, offsets, n, nnz, cfg,
                             et_data=None, et_data_t=None, pair_prec_re=None,
                             pair_prec_im=None, pair_index=None, pair_cfg=None,
                             device=None) -> DiaShiftOps:
    """`DiaShiftOps` from every leaf of the JAX package's ``DiaShiftOps``,
    the pair tables included."""
    return DiaShiftOps(
        data=_t(data, device), data_t=_t(data_t, device),
        prec_inv=_t(prec_inv, device),
        offsets=tuple(int(o) for o in offsets), n=int(n), nnz_=int(nnz),
        cfg=krylov_from(cfg),
        et_data=_t(et_data, device), et_data_t=_t(et_data_t, device),
        pair_prec_re=_t(pair_prec_re, device),
        pair_prec_im=_t(pair_prec_im, device),
        pair_index=(None if pair_index is None
                    else tuple(int(i) for i in np.asarray(pair_index))),
        pair_cfg=krylov_from(pair_cfg))


def bell_op_from_numpy(cols, data, cols_t, data_t, diag, n, bs,
                       device=None) -> BellOp:
    """`BellOp` from its block-ELL storage (``cols`` as int32)."""
    return BellOp(cols=_t(np.asarray(cols, np.int32), device), data=_t(data, device),
                  cols_t=_t(np.asarray(cols_t, np.int32), device),
                  data_t=_t(data_t, device), diag_=_t(diag, device),
                  n=int(n), bs=int(bs))


def sparse_shift_ops_from_numpy(cols, data, diag, prec_inv, n, bs, cfg,
                                device=None) -> SparseShiftOps:
    """`SparseShiftOps` from the leaves of the JAX package's
    ``SparseShiftOps`` that the port stores (its ``cols_t``/``data_t`` are
    left out, as `models.compiled.build_sparse_shift_ops` leaves them)."""
    return SparseShiftOps(cols=_t(np.asarray(cols, np.int32), device),
                          data=_t(data, device), diag_=_t(diag, device),
                          prec_inv=_t(prec_inv, device), n=int(n), bs=int(bs),
                          cfg=krylov_from(cfg))

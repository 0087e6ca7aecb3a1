"""Build port objects from the JAX package's arrays, given as numpy arrays,
and port configs from the JAX package's configs.

Lets a test feed both packages identical operators, factors, problems,
precomputed shift tables (so, for example, block-inverse rounding is not
compared twice) and algorithm configs.  Never imports JAX: callers pass
``np.asarray(...)`` of the JAX leaves and static fields as plain Python
values; `config_from` reads a config's fields by name.  Every
``*_from_numpy`` builds its tensors on ``device``, by default the card
(`config.resolve_device`: it raises where there is none).
"""

from __future__ import annotations

import numpy as np
import torch

from .config import resolve_device
from .lowrank import LowRank
from .models import problems, shifts
from .models.compiled import CappedADI, CompiledConfig, DiaShiftOps, ShiftLUs, SparseShiftOps
from .models.lyapunov_dense import SignFunctionCache
from .models.problems import GALEProblem, GAREProblem, GDREProblem
from .ops.blocklinear import Backslash, Krylov, ShermanMorrisonWoodbury
from .ops.dia import DiaOp
from .ops.operators import DenseOp
from .ops.sparse import BellOp


def _t(a, device):
    return None if a is None else torch.tensor(np.asarray(a), device=resolve_device(device))


def dia_op_from_numpy(data, data_t, offsets, n, nnz, symmetric=None,
                      device=None) -> DiaOp:
    """`DiaOp` from its diagonal storage."""
    return DiaOp(data=_t(data, device), data_t=_t(data_t, device),
                 offsets=tuple(int(o) for o in offsets), n=int(n),
                 nnz_=int(nnz), symmetric=symmetric)


def lowrank_from_numpy(L, D, k, device=None) -> LowRank:
    """`LowRank` from padded factors and the active rank."""
    return LowRank(L=_t(L, device), D=_t(D, device), k=int(k))


def dense_op_from_numpy(M, device=None) -> DenseOp:
    """`DenseOp` from a dense matrix."""
    return DenseOp(_t(M, device))


def _op(spec, device):
    """An operator from its leaves: a dict of `dia_op_from_numpy` keywords
    (it has ``offsets``) or of `bell_op_from_numpy` keywords (it has
    ``cols``), or a dense matrix."""
    if isinstance(spec, dict):
        make = dia_op_from_numpy if "offsets" in spec else bell_op_from_numpy
        return make(**spec, device=device)
    return dense_op_from_numpy(spec, device)


def gale_problem_from_numpy(E, A, C, device=None) -> GALEProblem:
    """`GALEProblem`: ``E`` and ``A`` as `_op` takes them, ``C`` the
    ``(L, D, k)`` of the low-rank right-hand side."""
    return GALEProblem(_op(E, device), _op(A, device), lowrank_from_numpy(*C, device=device))


def gdre_problem_from_numpy(E, A, B, C, X0, tspan, device=None) -> GDREProblem:
    """`GDREProblem`: ``E`` and ``A`` as `_op` takes them, ``X0`` the
    ``(L, D, k)`` of the low-rank initial value."""
    return GDREProblem(_op(E, device), _op(A, device), _t(B, device), _t(C, device),
                       lowrank_from_numpy(*X0, device=device), tspan)


def gare_problem_from_numpy(E, A, G, Q, device=None) -> GAREProblem:
    """`GAREProblem`: ``E`` and ``A`` as `_op` takes them, ``G`` and ``Q``
    the ``(L, D, k)`` of the low-rank factors."""
    return GAREProblem(_op(E, device), _op(A, device),
                       lowrank_from_numpy(*G, device=device),
                       lowrank_from_numpy(*Q, device=device))


def krylov_from(cfg) -> Krylov | None:
    """Port `Krylov` config from any object carrying the same fields (the
    JAX package's ``Krylov`` dataclass included)."""
    if cfg is None:
        return None
    return Krylov(method=cfg.method, tol=float(cfg.tol), atol=float(cfg.atol),
                  maxiter=int(cfg.maxiter), restart=int(cfg.restart),
                  preconditioner=cfg.preconditioner, negate=bool(cfg.negate),
                  solve_dtype=cfg.solve_dtype, refine_iters=int(cfg.refine_iters))


_FORCING = {"quadratic_forcing": problems.quadratic_forcing,
            "superlinear_forcing": problems.superlinear_forcing}


def config_from(cfg):
    """The port's config for one of the JAX package's (or ``None``), read
    field by field; dispatches on the class name: `ADI`, `GMRES` (its
    ``preconditioner`` converted in turn), `CappedADI`, `CompiledConfig` (its
    ``inner_alg`` converted in turn), `Newton`, `Ros1`,
    `Ros2`, `Parareal`, the four shift strategies, `Krylov`, `ShermanMorrisonWoodbury`
    and `Backslash`.  A strategy's list of precomputed shift values becomes
    a tuple of Python ``complex``; the named forcing functions become the
    port's."""
    if cfg is None:
        return None
    name = type(cfg).__name__
    if name == "ADI":
        return problems.ADI(
            maxiters=cfg.maxiters, reltol=cfg.reltol, abstol=cfg.abstol,
            shifts=config_from(cfg.shifts), ignore_initial_guess=cfg.ignore_initial_guess,
            inner_alg=config_from(cfg.inner_alg),
            compression_interval=cfg.compression_interval, compression=cfg.compression,
            warn_convergence=cfg.warn_convergence, capacity=cfg.capacity)
    if name == "GMRES":
        return problems.GMRES(
            maxiters=cfg.maxiters, maxrestarts=cfg.maxrestarts, reltol=cfg.reltol,
            abstol=cfg.abstol, ignore_initial_guess=cfg.ignore_initial_guess,
            compression=cfg.compression, preconditioner=config_from(cfg.preconditioner),
            warn_convergence=cfg.warn_convergence)
    if name == "CappedADI":
        return CappedADI(maxiters=cfg.maxiters, r_in=cfg.r_in, capacity=cfg.capacity)
    if name == "CompiledConfig":
        return CompiledConfig(maxiters=cfg.maxiters, compression_interval=cfg.compression_interval,
                              r_res=cfg.r_res, inner_alg=config_from(cfg.inner_alg))
    if name == "Newton":
        forcing = _FORCING.get(getattr(cfg.inexact_forcing, "__name__", None),
                               cfg.inexact_forcing)
        return problems.Newton(
            inner_alg=config_from(cfg.inner_alg), maxiters=cfg.maxiters,
            reltol=cfg.reltol, abstol=cfg.abstol, inexact=cfg.inexact,
            inexact_hybrid=cfg.inexact_hybrid, inexact_forcing=forcing,
            linesearch=cfg.linesearch)
    if name in ("Ros1", "Ros2"):
        return getattr(problems, name)(inner_alg=config_from(cfg.inner_alg))
    if name == "Parareal":
        return problems.Parareal(slabs=cfg.slabs, max_iters=cfg.max_iters,
                                 reltol=cfg.reltol, plateau_factor=cfg.plateau_factor)
    if name == "Projection":
        return shifts.Projection(cfg.n_history)
    if name == "Heuristic":
        return shifts.Heuristic(cfg.nshifts, cfg.kp, cfg.km, alg_E=config_from(cfg.alg_E),
                                alg_A=config_from(cfg.alg_A))
    if name == "Cyclic":
        inner = cfg.inner
        if type(inner).__name__ in ("Projection", "Heuristic", "Cyclic", "Wrapped"):
            return shifts.Cyclic(config_from(inner))
        return shifts.Cyclic(tuple(complex(v) for v in np.asarray(inner).ravel()))
    if name == "Wrapped":
        return shifts.Wrapped(cfg.func, config_from(cfg.inner))
    if name == "Krylov":
        return krylov_from(cfg)
    if name == "ShermanMorrisonWoodbury":
        return ShermanMorrisonWoodbury(outer=config_from(cfg.outer),
                                       inner=config_from(cfg.inner))
    if name == "Backslash":
        return Backslash()
    raise TypeError(f"no port config for {cfg!r}")


def dia_shift_ops_from_numpy(data, data_t, prec_inv, offsets, n, nnz, cfg,
                             et_data=None, et_data_t=None, pair_prec_re=None,
                             pair_prec_im=None, pair_index=None, pair_cfg=None,
                             device=None) -> DiaShiftOps:
    """`DiaShiftOps` from every leaf of the JAX package's ``DiaShiftOps``,
    the pair tables included."""
    data, data_t = _t(data, device), _t(data_t, device)
    return DiaShiftOps(
        data=data, data_t=data_t, prec_inv=_t(prec_inv, device),
        base=DiaOp(data=data[0], data_t=data_t[0], offsets=tuple(int(o) for o in offsets),
                   n=int(n), nnz_=int(nnz)),
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
    data, diag = _t(data, device), _t(diag, device)
    base = BellOp(cols=_t(np.asarray(cols, np.int32), device), data=data[0], cols_t=None,
                  data_t=None, diag_=diag[0], n=int(n), bs=int(bs))
    return SparseShiftOps(data=data, diag_=diag, prec_inv=_t(prec_inv, device), base=base,
                          cfg=krylov_from(cfg))


def _lapack_pivots(piv, device):
    """JAX's 0-based LU pivots as torch's 1-based (LAPACK) int32 ones."""
    return torch.tensor(np.asarray(piv, np.int32) + 1, device=resolve_device(device))


def sign_cache_from_numpy(E_lu, E_piv, Minvs, cs, device=None) -> SignFunctionCache:
    """`SignFunctionCache` from the JAX package's leaves (0-based pivots)."""
    return SignFunctionCache(E_lu=_t(E_lu, device), E_piv=_lapack_pivots(E_piv, device),
                             Minvs=_t(Minvs, device), cs=_t(cs, device))


def shift_lus_from_numpy(lu, piv, device=None) -> ShiftLUs:
    """`ShiftLUs` from the JAX package's batched LUs (0-based pivots)."""
    return ShiftLUs(lu=_t(lu, device), piv=_lapack_pivots(piv, device))

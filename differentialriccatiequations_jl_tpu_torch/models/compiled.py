"""The LRSIF Ros1 GDRE time step on a banded pencil: ADI with precomputed
shifted DIA operators.

Port of the slice of the JAX package's ``models/compiled.py`` that one
Ros1 step runs (`ros1_step_compiled` → `adi_compiled` → block-Jacobi
preconditioned Krylov solves over `DiaShiftOps` with an SMW feedback
correction → `lr_compress`).  The JAX package compiles the step into one
``jit`` with a ``lax.while_loop``; here PyTorch runs eagerly, so the loop
and its branches are Python control flow:

* the shift buffer is a host numpy array, so choosing between the real
  step and the pair (double) step costs no sync;
* the ranks ``k`` are host ints (`lowrank.LowRank`), so the capacity test
  costs no sync; each compression reads its new rank back (one sync);
* the ADI convergence test ``res > abstol`` syncs once per ADI iteration,
  and each Krylov iteration syncs once (``ops.blocklinear``).

Supported shift buffers: all-real 1-D ``(ns,)`` and the pair encoding
``(ns, 2)`` of ``(Re μ, |Im μ|)`` rows (`pair_encode_shifts`), whose
conjugate-pair slots run the all-real stacked double step.  A 1-D complex
buffer raises: in the JAX package it is a CPU-only route, and the pair
encoding keeps kernel K1 real-only.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from ..lowrank import LowRank, _mask_cols, lr_add, lr_compress
from ..ops.blocklinear import (
    DenseLUSolver, Krylov, KrylovSolver, PairBlockPrec, PairSMWSolver,
    SMWSolver, block_jacobi_inverses)
from ..ops.dia import DiaOp, DiaPairOp
from ..ops.operators import LowRankUpdateOp, lin_comb, lr_update
from .residuals import residual_gale_lowrank


#: Block size of the block-Jacobi preconditioner.
PREC_BS = 128


@dataclasses.dataclass(frozen=True)
class CompiledConfig:
    """Configuration of the ADI/Rosenbrock step."""

    maxiters: int = 60
    compression_interval: int = 10
    r_res: int = 32  # residual factor width (≥ numerical residual rank)


@dataclasses.dataclass(frozen=True)
class DiaShiftOps:
    """Precomputed shifted banded operators ``A₀ᵀ + μₛEᵀ`` in DIA storage
    with block-Jacobi preconditioner inverses, one slot per shift.

    For pair-encoded buffers ``data`` holds the *real part* ``A₀ᵀ + aₛEᵀ``
    and the extras hold the ``Eᵀ`` DIA data and stacked-real complex
    block inverses for the conjugate-pair slots; `pair_solver` then solves
    the double step's complex system as an all-real 2n block system
    (`ops.dia.DiaPairOp`)."""

    data: torch.Tensor  # (ns, ndiag, N): the shifted operators, pre-transposed
    data_t: torch.Tensor  # (ns, ndiag, N)
    prec_inv: torch.Tensor  # (ns, nb, bs, bs) block-Jacobi inverses
    offsets: tuple
    n: int
    nnz_: int
    cfg: Krylov
    # Pair-encoded (all-real double step) extras; None without pair slots.
    et_data: torch.Tensor | None = None  # (ndiag, N): Eᵀ
    et_data_t: torch.Tensor | None = None
    pair_prec_re: torch.Tensor | None = None  # (n_pairs, nb, bs, bs)
    pair_prec_im: torch.Tensor | None = None
    pair_index: tuple | None = None  # (ns,) slot → pair row (0 if real)
    pair_cfg: Krylov | None = None  # Krylov for the stacked-real pair system

    def _dia(self, idx: int) -> DiaOp:
        return DiaOp(data=self.data[idx], data_t=self.data_t[idx],
                     offsets=self.offsets, n=self.n, nnz_=self.nnz_)

    def core_solver(self, idx: int) -> KrylovSolver:
        return KrylovSolver(op=self._dia(idx), prec=self.prec_inv[idx],
                            cfg=self.cfg)

    def pair_solver(self, idx: int, b: float) -> KrylovSolver:
        """Stacked-real solver for slot ``idx`` holding a conjugate pair
        ``a ± b·i``: the 2n system ``[[F, −bEᵀ], [bEᵀ, F]]`` with
        ``F = data[idx]`` (already shifted by ``a``)."""
        if self.et_data is None:
            raise ValueError("shift buffer was not pair-encoded")
        Et = DiaOp(data=self.et_data, data_t=self.et_data_t,
                   offsets=self.offsets, n=self.n, nnz_=self.nnz_)
        pi = self.pair_index[idx]
        return KrylovSolver(
            op=DiaPairOp(F=self._dia(idx), Et=Et, b=float(b)),
            prec=PairBlockPrec(re=self.pair_prec_re[pi],
                               im=self.pair_prec_im[pi]),
            cfg=self.pair_cfg)


def default_dia_krylov(dtype: torch.dtype, complex_shifts: bool) -> Krylov:
    """Natural Krylov config for shifted banded pencils: CG on the negated
    (SPD) operator for real shift sets on symmetric pencils, BiCGStab for
    complex shift buffers (complex-symmetric, not Hermitian)."""
    eps = float(torch.finfo(dtype).eps)
    if complex_shifts:
        return Krylov(method="bicgstab", tol=10 * eps, maxiter=400, negate=False)
    return Krylov(method="cg", tol=10 * eps, maxiter=400, negate=True)


def _pair_krylov(cfg: Krylov) -> Krylov:
    """The stacked-real pair system is real nonsymmetric (skew coupling):
    BiCGStab without negation, same tolerances."""
    return dataclasses.replace(cfg, method="bicgstab", negate=False)


def _shifted_dia_data(At_data, At_data_t, Et_data, Et_data_t, shifts):
    """``Aᵀ + μₛEᵀ`` data for every shift, batched: ``(ns, ndiag, N)``."""
    mu = shifts[:, None, None]
    return At_data + mu * Et_data, At_data_t + mu * Et_data_t


def _shift_block_inverses(blkA, blkE, shifts):
    """Per-shift block-Jacobi inverses of ``blk(A) + μ·blk(E)``, batched
    over shifts and blocks: ``(ns, nb, bs, bs)``."""
    return block_jacobi_inverses(blkA + shifts[:, None, None, None] * blkE)


def _pair_block_inverses(blkA, blkE, ab):
    """Stacked-real complex block-Jacobi inverses for conjugate-pair shift
    slots: for ``μ = a + b·i`` the complex diagonal block is
    ``M = (blkA + a·blkE) + i·(b·blkE)``; its inverse ``P + i·Q`` is read
    off the inverse of the real 2bs×2bs block ``[[R, −I], [I, R]]``.
    Batched over blocks, one pair at a time (transient (nb, 2bs, 2bs))."""
    bs = blkA.shape[-1]
    P, Q = [], []
    for a, b in ab.tolist():
        R = blkA + a * blkE
        I_ = b * blkE
        T = torch.cat([torch.cat([R, -I_], dim=-1),
                       torch.cat([I_, R], dim=-1)], dim=-2)
        Tinv = torch.linalg.inv(T)
        P.append(Tinv[:, :bs, :bs])
        Q.append(Tinv[:, bs:, :bs])
    return torch.stack(P), torch.stack(Q)


def build_dia_shift_ops(E: DiaOp, A0: DiaOp, shifts,
                        block_cache: dict | None = None) -> DiaShiftOps:
    """Assemble the per-shift shifted DIA operators ``A₀ᵀ + μₛEᵀ`` and their
    block-Jacobi inverses (``PREC_BS``-wide blocks).  ``E``/``A0``:
    diagonal-set-sharing `DiaOp`s (see `ops.dia.dia_pencil`).  ``shifts``:
    host array, 1-D real or the ``(ns, 2)`` pair encoding; the shifts take
    the operators' dtype.

    ``block_cache``: optional dict reused across calls with the same pencil;
    it caches the pencil members' diagonal blocks so a rebuild costs one
    batched add + one batched inverse."""
    shifts = np.asarray(shifts)
    if np.iscomplexobj(shifts):
        raise ValueError("complex 1-D shift buffers are not supported; "
                         "pair-encode them with pair_encode_shifts")
    pair_encoded = shifts.ndim == 2
    has_pairs = pair_encoded and bool(np.any(shifts[:, 1] != 0))
    # Any conjugate pair means a nonsymmetric pencil, and so does a
    # known-nonsymmetric operator: then every slot uses BiCGStab.  All-real
    # buffers on symmetric pencils keep CG.
    nonsym = A0.symmetric is False or E.symmetric is False
    krylov_cfg = default_dia_krylov(E.dtype, has_pairs or nonsym)

    At, Et = A0.adjoint(), E.adjoint()
    dt, dev = At.dtype, At.device
    a_host = shifts[:, 0] if pair_encoded else shifts
    a_part = torch.as_tensor(a_host, dtype=dt, device=dev)
    data, data_t = _shifted_dia_data(At.data, At.data_t, Et.data, Et.data_t,
                                     a_part)

    key = ("pencil_blocks", PREC_BS, str(dt))
    if block_cache is not None and key in block_cache:
        blkA, blkE = block_cache[key]
    else:
        blkA = At.diag_blocks(PREC_BS)
        blkE = Et.diag_blocks(PREC_BS, pad_identity=False)
        if block_cache is not None:
            block_cache[key] = (blkA, blkE)
    inv = _shift_block_inverses(blkA, blkE, a_part)

    pair_kw = {}
    if has_pairs:
        # Compact pair tables: stacked-real block inverses only for the
        # conjugate-pair slots; slot → pair row map.
        pair_rows = np.nonzero(shifts[:, 1] != 0)[0]
        pidx = np.zeros(shifts.shape[0], np.int64)
        pidx[pair_rows] = np.arange(pair_rows.size)
        P, Qm = _pair_block_inverses(blkA, blkE, shifts[pair_rows])
        pair_kw = dict(et_data=Et.data, et_data_t=Et.data_t,
                       pair_prec_re=P, pair_prec_im=Qm,
                       pair_index=tuple(int(i) for i in pidx),
                       pair_cfg=_pair_krylov(krylov_cfg))
    return DiaShiftOps(data=data, data_t=data_t, prec_inv=inv,
                       offsets=At.offsets, n=At.n, nnz_=At.nnz_,
                       cfg=krylov_cfg, **pair_kw)


def _small_dense_solver(S: torch.Tensor):
    """Prepared solver for a small dense system (LU)."""
    lu, piv = torch.linalg.lu_factor(S)
    return DenseLUSolver(lu=lu, piv=piv)


def _wrap_smw(core, A, dtype):
    """SMW correction for the feedback update around a prepared core.

    ``A⁻¹U`` is solved anew on every call (every ADI step), as in the JAX
    package."""
    if not isinstance(A, LowRankUpdateOp):
        return core
    U = A.V.T.to(dtype)
    Vt = A.U.T.to(dtype)
    AinvU = core.solve(U)
    m = U.shape[1]
    S = A.alpha * torch.eye(m, dtype=dtype, device=U.device) + Vt @ AinvU
    return SMWSolver(base=core, AinvU=AinvU, V=Vt, schur=_small_dense_solver(S))


def _wrap_smw_pair(core, A, dtype):
    """SMW correction around a *stacked-real pair* core solver: the
    closed-loop update ``α⁻¹UV`` is real, the shifted base complex, so
    ``A⁻¹U = P + iQ`` comes from one stacked solve and the Schur complement
    is factored in its real 2m×2m block form."""
    if not isinstance(A, LowRankUpdateOp):
        return core
    U = A.V.T.to(dtype)
    Vt = A.U.T.to(dtype)
    m = U.shape[1]
    AinvU_st = core.solve(torch.cat([U, torch.zeros_like(U)], dim=1))
    P, Q = AinvU_st[:, :m], AinvU_st[:, m:]
    Sr = A.alpha * torch.eye(m, dtype=dtype, device=U.device) + Vt @ P
    Si = Vt @ Q
    S2 = torch.cat([torch.cat([Sr, -Si], dim=1),
                    torch.cat([Si, Sr], dim=1)], dim=0)
    return PairSMWSolver(base=core, AinvU_re=P, AinvU_im=Q, V=Vt,
                         schur=_small_dense_solver(S2))


def _residual_norm(W: torch.Tensor, T: torch.Tensor) -> torch.Tensor:
    """‖W T Wᵀ‖_F via the Gram form ``tr((T·WᵀW)²)`` (the JAX package's
    ``models/adi.py::_residual_norm``)."""
    TM = T @ (W.T @ W)
    return torch.sqrt(torch.clamp(torch.trace(TM @ TM), min=0.0))


def adi_compiled(E, A, W0, T0, w_k: int, X0: LowRank, shifts, abstol: float,
                 cfg: CompiledConfig, shift_lus: DiaShiftOps):
    """Low-rank ADI over a cyclic shift buffer.

    Args:
      E, A: operators (A may be a `LowRankUpdateOp` closed-loop coefficient).
      W0, T0: residual factors — residual = W T Wᵀ, W: (n, r_res) with
        ``w_k`` active leading columns; increments add ``w_k`` (or
        ``2·w_k``) columns to ``X``.
      X0: warm-start iterate; ``W0 T0 W0ᵀ`` must be the GALE residual at it.
      shifts: host array, 1-D real or ``(ns, 2)`` pair-encoded.
      abstol: absolute residual tolerance.
      shift_lus: `DiaShiftOps` built for ``shifts``.

    Compression runs every ``cfg.compression_interval`` iterations and
    whenever the next increment would overflow the capacity ``X0.r``; a
    numerical rank above the capacity is truncated.

    Returns (X, W, iters, res_norm).
    """
    shifts = np.asarray(shifts)
    if np.iscomplexobj(shifts):
        raise ValueError("complex 1-D shift buffers are not supported; "
                         "pair-encode them with pair_encode_shifts")
    nshifts = shifts.shape[0]
    pair_encoded = shifts.ndim == 2
    q = W0.shape[1]
    dt = W0.dtype
    sdt = shift_lus.data.dtype

    def real_step(mu, idx, W, T, X):
        solver = _wrap_smw(shift_lus.core_solver(idx), A, sdt)
        V = solver.solve(W.to(sdt)).to(dt)
        incr = LowRank(L=V, D=(-2.0 * mu) * T, k=w_k)
        W_new = W - 2.0 * mu * E.tmm(V)
        return W_new, lr_add(X, incr, r_out=X.r), 1

    def double_step(mur, b, idx, W, T, X):
        # All-real stacked solve of the pair system (the complex double
        # step reformulated over ℝ).
        solver = _wrap_smw_pair(shift_lus.pair_solver(idx, b), A, sdt)
        Vst = solver.solve(torch.cat([W, torch.zeros_like(W)], dim=1).to(sdt))
        Vr, Vi = Vst[:, :q].to(dt), Vst[:, q:].to(dt)
        delta = mur / b
        s2 = math.sqrt(2.0)
        V1 = s2 * Vr + (s2 * delta) * Vi
        V2 = math.sqrt(2.0 * delta * delta + 2.0) * Vi
        # [V1 V2] enter as two increments, so the active columns stay
        # packed in front: [0:w_k] of V1, then [0:w_k] of V2.
        incr1 = LowRank(L=V1, D=(-2.0 * mur) * T, k=w_k)
        incr2 = LowRank(L=V2, D=(-2.0 * mur) * T, k=w_k)
        W_new = W - (2.0 * s2 * mur) * E.tmm(V1)
        X_new = lr_add(lr_add(X, incr1, r_out=X.r), incr2, r_out=X.r)
        return W_new, X_new, 2

    X, W = X0, W0
    i = ptr = since_comp = 0
    res = _residual_norm(W0, T0)
    while i < cfg.maxiters and bool(res > abstol):  # host sync per iteration
        if since_comp >= cfg.compression_interval or X.k + 2 * w_k > X.r:
            X = lr_compress(X)
            since_comp = 0
        idx = ptr % nshifts
        if pair_encoded:
            mur, b = float(shifts[idx, 0]), float(shifts[idx, 1])
        else:
            mur, b = float(shifts[idx]), 0.0
        if b == 0.0:
            W, X, used = real_step(mur, idx, W, T0, X)
        elif shift_lus.et_data is None:
            raise ValueError("pair-encoded shift with Im(mu) != 0 but the "
                             "shift operators have no pair tables")
        else:
            W, X, used = double_step(mur, b, idx, W, T0, X)
        since_comp += used
        res = _residual_norm(W, T0)
        # Pair encoding: one slot per conjugate pair, so the pointer moves
        # one slot whether the slot did 1 or 2 iterations.
        ptr += 1 if pair_encoded else used
        i += used
    if since_comp > 0:
        X = lr_compress(X)
    return X, W, i, res


def ros1_initial_residual(E, A, B, C, X: LowRank, tau: float,
                          cfg: CompiledConfig):
    """Closed-loop coefficient and warm-start residual of one Ros1 step.

    ``F = (A − E/(2τ)) − B K`` with ``K = BᵀL D (EᵀL)ᵀ``, and the GALE
    residual of the step's right-hand side at ``X`` compressed to
    ``cfg.r_res`` columns: the ADI drives it to zero while accumulating
    increments on top of ``X``.  Returns (F, res0).
    """
    q = C.shape[0]
    L, D = X.L, X.D
    BtLD = (B.T @ L) @ D
    K = BtLD @ E.tmm(L).T
    F_op = lr_update(lin_comb(A, -1.0 / (2.0 * tau), E), -1.0, B, K)

    G = torch.cat([C.T, E.tmm(L)], dim=1)
    r = L.shape[1]
    S = G.new_zeros((q + r, q + r))
    S[:q, :q] = torch.eye(q, dtype=G.dtype, device=G.device)
    S[q:, q:] = BtLD.T @ BtLD + D / tau
    R = LowRank(L=G, D=S, k=min(q + X.k, q + r))
    return F_op, residual_gale_lowrank(E, F_op, R, X, r_out=cfg.r_res)


def ros1_step_compiled(E, A, B, C, X: LowRank, tau: float, shifts,
                       abstol: float, cfg: CompiledConfig,
                       shift_lus: DiaShiftOps):
    """One full LRSIF Ros1 (implicit Euler) GDRE time step, end to end:
    RHS assembly, the ADI loop, the feedback update.
    Returns (X_next, K_next, adi_iters, adi_residual_norm)."""
    F_op, res0 = ros1_initial_residual(E, A, B, C, X, tau, cfg)
    W0 = _mask_cols(res0.L, res0.k)
    X_new, _, iters, res = adi_compiled(E, F_op, W0, res0.D, res0.k, X,
                                        shifts, abstol, cfg, shift_lus)
    L2, D2 = X_new.L, X_new.D
    K_new = ((B.T @ L2) @ D2) @ E.tmm(L2).T
    return X_new, K_new, iters, res


def _pair_units(arr):
    """Group a complex shift array into units: real singletons and
    conjugate pairs (synthesizing the conjugate when it is not adjacent),
    as ``(a, b)`` tuples with ``b = |Im μ|`` (0 for real)."""
    units, i = [], 0
    tol = 1e-12
    while i < arr.size:
        v = arr[i]
        if abs(v.imag) <= tol * max(abs(v.real), 1e-300):
            units.append((float(v.real), 0.0))
            i += 1
        elif i + 1 < arr.size and np.isclose(arr[i + 1], np.conj(v)):
            units.append((float(v.real), abs(float(v.imag))))
            i += 2
        else:
            units.append((float(v.real), abs(float(v.imag))))
            i += 1
    return units


def pair_encode_shifts(shifts, rdtype=None) -> np.ndarray:
    """Encode a complex shift buffer as the 2-D real pair representation:
    one ``(Re μ, |Im μ|)`` row per unit (real singleton or conjugate pair).
    Host numpy in, host numpy out."""
    shifts = np.asarray(shifts)
    if rdtype is None:
        rdtype = shifts.real.dtype
    arr = shifts.astype(np.complex128).ravel()
    return np.asarray(_pair_units(arr)).astype(rdtype)

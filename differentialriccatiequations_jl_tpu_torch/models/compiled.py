"""The compiled LRSIF Rosenbrock GDRE steps and sweeps and the compiled
Kleinman–Newton GARE solver: ADI with precomputed shifted operators.

Port of the JAX package's ``models/compiled.py``: `ros1_step_compiled`,
`ros2_step_compiled`, the sweeps `solve_gdre_ros1_compiled` /
`solve_gdre_ros2_compiled` and the Newton solver
`solve_gare_newton_compiled` (ADI or, with ``inner_gmres``, FGMRES under a
capped compiled-ADI preconditioner, `make_compiled_adi_preconditioner`) →
`adi_compiled` → block-Jacobi preconditioned
Krylov solves over precomputed shifted operators (`DiaShiftOps` for banded
pencils, `SparseShiftOps` for block-ELL ones), or LU solves over
precomputed factorizations (`ShiftLUs` for dense ones), with an SMW
feedback correction → `lr_compress`.  The JAX package compiles a step into one
``jit`` with a ``lax.while_loop`` (and a sweep into one ``lax.scan``); here
PyTorch runs eagerly, so the loops and their branches are Python control
flow:

* the shift buffer is a host numpy array, so choosing between the real
  step and the pair (double) step costs no sync;
* the ranks ``k`` are host ints (`lowrank.LowRank`), so the capacity test
  costs no sync; each compression reads its new rank back (one sync);
* the ADI convergence test ``res > abstol`` syncs once per ADI iteration,
  and each Krylov iteration syncs once (``ops.blocklinear``).

**Row-sharded operands** (ROADMAP items 10b, 10c and 10d): the Ros1 and
Ros2 steps and sweeps, `adi_compiled`, `_newton_step_compiled` and the
Newton solver `solve_gare_newton_compiled` also run on
operators split by rows over a 1-D mesh (`parallel.mesh.shard_operator`:
DIA with ``block=PREC_BS``, block-ELL in its ``bs``-row blocks), ``X``
from `parallel.mesh.shard_lowrank`, ``B`` split by rows and ``C`` by
columns, in the same blocks.  The sharded operands select the path, as the
JAX package's ``with mesh:`` does: each function enters its operator's
mesh (`parallel.mesh.on_operator_mesh`), every contraction over n is
all-reduced, `lr_compress` is a TSQR (or an all-reduced Gram matrix, its
``gram`` route for f32 factors), and the shifted operators and block
inverses are the rank's own rows (`DiaShiftOps.base`,
`SparseShiftOps.base`), an f32 refined core included.  Every rank takes
the same host branches, from all-reduced or redundantly computed values.
``K`` comes out split by columns (each rank's columns, a deliberate
difference from the JAX package's global array).

Supported shift buffers: all-real 1-D ``(ns,)``, the pair encoding
``(ns, 2)`` of ``(Re μ, |Im μ|)`` rows (`pair_encode_shifts`), whose
conjugate-pair slots run the all-real stacked double step (banded pencils
only), and 1-D complex with conjugates adjacent, whose pairs run the
complex double step (one complex solve a pair, the JAX package's CPU
route): on dense cores through complex LUs, on banded cores through
complex per-slot DIA data and BiCGStab (their products reach K1 by
`kernels.complex_route`).  Block-ELL cores take real shifts only.

**The uncached route.**  `adi_compiled` and `ros1_step_compiled` also run
without precomputed cores (``shift_lus=None``): each ADI iteration then
prepares a solver for its shift, ``prepare_shifted(E, A, μ, inner)`` with
``inner = cfg.inner_alg`` or the default for the operator kind
(`ops.shifted.default_inner_alg`), so a 1-D complex buffer runs on dense,
banded and block-ELL operators alike.
"""

from __future__ import annotations

import dataclasses
import math
import time
import warnings

import numpy as np
import torch

from ..lowrank import (
    LowRank, _mask_cols, lr_add, lr_append, lr_compress, lr_norm, lr_scale,
    lr_slice_active, lr_with_capacity, lr_zero)
from ..ops.blocklinear import (
    DenseLUSolver, Krylov, KrylovSolver, PairBlockPrec, PairSMWSolver,
    RefinedKrylovSolver, SMWSolver, block_jacobi_inverses, solve_dtype)
from ..ops.dia import DiaOp, DiaPairOp
from ..ops.operators import (
    DenseOp, LowRankUpdateOp, lin_comb, lr_update, op_astype, scale_op)
from ..ops.shifted import default_inner_alg, prepare_shifted
from ..ops.sparse import BellOp
from ..parallel.mesh import (
    active_mesh, mesh_of, on_operator_mesh, on_problem_mesh, row_allgather, row_allreduce, row_norm,
    use_mesh)
from ..utils.callbacks import notify
from .adi import _in_dtype, _residual_norm
from .problems import DRESolution
from .residuals import residual_gale_lowrank, residual_gare_lowrank
from .rosenbrock_lowrank import _ros2_rhs1, _ros2_rhs2, feedback_K, time_grid
from ..ops.dia_cholesky import NotDefinite
from .shifts import heuristic_shifts_card, heuristic_shifts_host


#: Block size of the block-Jacobi preconditioner.
PREC_BS = 128


@dataclasses.dataclass(frozen=True)
class CompiledConfig:
    """Configuration of the ADI/Rosenbrock step."""

    maxiters: int = 60
    compression_interval: int = 10
    r_res: int = 32  # residual factor width (≥ numerical residual rank)
    # The uncached route's solver (``shift_lus=None``): None → routed per
    # operator kind (`ops.shifted.default_inner_alg`).
    inner_alg: object = None


@dataclasses.dataclass(frozen=True)
class DiaShiftOps:
    """Precomputed shifted banded operators ``A₀ᵀ + μₛEᵀ`` in DIA storage
    with block-Jacobi preconditioner inverses, one slot per shift.

    For pair-encoded buffers ``data`` holds the *real part* ``A₀ᵀ + aₛEᵀ``
    and the extras hold the ``Eᵀ`` DIA data and stacked-real complex
    block inverses for the conjugate-pair slots; `pair_solver` then solves
    the double step's complex system as an all-real 2n block system
    (`ops.dia.DiaPairOp`).  With ``cfg.solve_dtype`` set (e.g. "float32"
    under f64 data), both return a mixed-precision `RefinedKrylovSolver`:
    the Krylov core on the data cast to that dtype, with block inverses
    built in it, and the refinement's residual on the full-dtype data.

    ``base`` is the ``Aᵀ`` the slots shift: each slot's operator is it
    with the slot's data, so from row-sharded operators the slots hold the
    rank's rows' shifted diagonals (``nl + 2H`` columns) and blocks, and the
    solvers' operators are shards like it."""

    data: torch.Tensor  # (ns, ndiag, N): the shifted operators, pre-transposed
    data_t: torch.Tensor  # (ns, ndiag, N)
    prec_inv: torch.Tensor  # (ns, nb, bs, bs) block-Jacobi inverses, solve dtype
    base: DiaOp  # Aᵀ: offsets, sizes (and rows, mesh) of every slot's operator
    cfg: Krylov
    # Pair-encoded (all-real double step) extras; None without pair slots.
    et_data: torch.Tensor | None = None  # (ndiag, N): Eᵀ
    et_data_t: torch.Tensor | None = None
    pair_prec_re: torch.Tensor | None = None  # (n_pairs, nb, bs, bs)
    pair_prec_im: torch.Tensor | None = None
    pair_index: tuple | None = None  # (ns,) slot → pair row (0 if real)
    pair_cfg: Krylov | None = None  # Krylov for the stacked-real pair system
    # The JAX package's leaves of the same names.
    offsets = property(lambda self: self.base.offsets)
    n = property(lambda self: self.base.n)
    nnz_ = property(lambda self: self.base.nnz_)

    def _op(self, data, data_t) -> DiaOp:
        return dataclasses.replace(self.base, data=data, data_t=data_t, symmetric=None)

    def _dia(self, idx: int) -> DiaOp:
        return self._op(self.data[idx], self.data_t[idx])

    def _refined(self, op, lo_op, prec, cfg: Krylov):
        """`KrylovSolver` on ``op``, or, when ``cfg.solve_dtype`` differs
        from the data's dtype, a `RefinedKrylovSolver` with its core on
        ``lo_op(dtype)``."""
        if cfg.solve_dtype is not None:
            lo = solve_dtype(cfg.solve_dtype, op.dtype)
            if lo != op.dtype:
                inner = KrylovSolver(op=lo_op(lo), prec=prec,
                                     cfg=dataclasses.replace(cfg, solve_dtype=None))
                return RefinedKrylovSolver(op_hi=op, inner=inner,
                                           iters=cfg.refine_iters)
        return KrylovSolver(op=op, prec=prec, cfg=cfg)

    def core_solver(self, idx: int):
        op = self._dia(idx)
        return self._refined(op, lambda lo: op_astype(op, lo),
                             self.prec_inv[idx], self.cfg)

    def pair_solver(self, idx: int, b: float):
        """Stacked-real solver for slot ``idx`` holding a conjugate pair
        ``a ± b·i``: the 2n system ``[[F, −bEᵀ], [bEᵀ, F]]`` with
        ``F = data[idx]`` (already shifted by ``a``)."""
        if self.et_data is None:
            raise ValueError("shift buffer was not pair-encoded")
        Et = self._op(self.et_data, self.et_data_t)
        op = DiaPairOp(F=self._dia(idx), Et=Et, b=float(b))
        pi = self.pair_index[idx]
        prec = PairBlockPrec(re=self.pair_prec_re[pi], im=self.pair_prec_im[pi])

        def lo_op(lo):
            return DiaPairOp(F=op_astype(op.F, lo), Et=op_astype(Et, lo), b=op.b)

        return self._refined(op, lo_op, prec, self.pair_cfg)


def default_dia_krylov(dtype: torch.dtype, complex_shifts: bool) -> Krylov:
    """Natural Krylov config for shifted banded pencils: CG on the negated
    (SPD) operator for real shift sets on symmetric pencils, BiCGStab for
    complex shift buffers (complex-symmetric, not Hermitian)."""
    eps = float(torch.finfo(dtype).eps)
    if complex_shifts:
        return Krylov(method="bicgstab", tol=10 * eps, maxiter=400,
                      preconditioner="block_jacobi", negate=False)
    return Krylov(method="cg", tol=10 * eps, maxiter=400,
                  preconditioner="block_jacobi", negate=True)


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
                        krylov_cfg: Krylov | None = None,
                        block_cache: dict | None = None) -> DiaShiftOps:
    """Assemble the per-shift shifted DIA operators ``A₀ᵀ + μₛEᵀ`` and their
    block-Jacobi inverses (``PREC_BS``-wide blocks).  ``E``/``A0``:
    diagonal-set-sharing `DiaOp`s (see `ops.dia.dia_pencil`).  ``shifts``:
    host array, 1-D real, 1-D complex (complex per-slot data and block
    inverses: the complex double step, with one complex solve a pair) or
    the ``(ns, 2)`` pair encoding; the shifts take the operators' dtype
    (made complex for a complex buffer).  ``krylov_cfg`` defaults to
    `default_dia_krylov`: BiCGStab for a complex buffer, a conjugate pair
    or a known-nonsymmetric pencil.

    ``block_cache``: optional dict reused across calls with the same pencil;
    it caches the pencil members' diagonal blocks so a rebuild costs one
    batched add + one batched inverse.

    ``E``/``A0`` may be row shards (`parallel.sharded_ops.ShardedDiaOp`)
    split in ``PREC_BS``-row blocks: then every table holds the rank's
    rows."""
    shifts = np.asarray(shifts)
    pair_encoded = shifts.ndim == 2
    has_pairs = pair_encoded and bool(np.any(shifts[:, 1] != 0))
    complex_buf = np.iscomplexobj(shifts)
    # Any conjugate pair means a nonsymmetric pencil, and so does a
    # known-nonsymmetric operator: then every slot uses BiCGStab, as it
    # does for a complex buffer (complex-symmetric, not Hermitian).
    # All-real buffers on symmetric pencils keep CG.
    if krylov_cfg is None:
        nonsym = A0.symmetric is False or E.symmetric is False
        krylov_cfg = default_dia_krylov(E.dtype, has_pairs or nonsym or complex_buf)

    At, Et = A0.adjoint(), E.adjoint()
    dt, dev = At.dtype, At.device
    if complex_buf:
        dt = torch.promote_types(dt, torch.complex64)
    a_host = shifts[:, 0] if pair_encoded else shifts
    a_part = torch.as_tensor(a_host, dtype=dt, device=dev)
    data, data_t = _shifted_dia_data(At.data.to(dt), At.data_t.to(dt), Et.data.to(dt),
                                     Et.data_t.to(dt), a_part)

    # The block inverses are built in the Krylov core's dtype: the low one
    # of a mixed-precision core, from the pencil cast to it (complex for a
    # complex buffer).
    pdt = dt if krylov_cfg.solve_dtype is None else solve_dtype(krylov_cfg.solve_dtype, dt)
    key = ("pencil_blocks", PREC_BS, str(pdt))
    if block_cache is not None and key in block_cache:
        blkA, blkE = block_cache[key]
    else:
        blkA = op_astype(At, pdt).diag_blocks(PREC_BS)
        blkE = op_astype(Et, pdt).diag_blocks(PREC_BS, pad_identity=False)
        if block_cache is not None:
            block_cache[key] = (blkA, blkE)
    inv = _shift_block_inverses(blkA, blkE, a_part.to(pdt))

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
    return DiaShiftOps(data=data, data_t=data_t, prec_inv=inv, base=At,
                       cfg=krylov_cfg, **pair_kw)


@dataclasses.dataclass(frozen=True)
class SparseShiftOps:
    """Precomputed shifted block-ELL operators ``A₀ᵀ + μₛEᵀ`` with
    block-Jacobi preconditioner inverses, one slot per shift (real shifts
    only: the symmetric Rail-class pencils, whose Penzl shifts are real).

    Unlike the JAX package, the shifted operators' transposed structure
    (``cols_t``, ``data_t``) is not stored: no Krylov product reads it, and
    at n = 79841 with 16 shifts it would double the 9 GB of f64 blocks.

    ``base`` is slot 0's operator and each slot's is it with the slot's
    data and diagonal (`slot`), so from row shards
    (`parallel.sharded_ops.ShardedBellOp`) the slots hold the rank's block
    rows (and the shard's ``2H`` zero block rows after them), their
    block-Jacobi inverses the rank's diagonal blocks, and the Krylov
    solvers multiply shards like it."""

    data: torch.Tensor  # (ns, nb + 2H, K, bs, bs); H = 0 unsharded
    diag_: torch.Tensor  # (ns, n or the rank's nl)
    prec_inv: torch.Tensor  # (ns, nb, bs, bs) block-Jacobi inverses
    base: BellOp  # slot 0's operator: pattern, sizes (and rows, halo, mesh)
    cfg: Krylov

    def slot(self, idx: int) -> BellOp:
        """Slot ``idx``'s shifted operator."""
        return dataclasses.replace(self.base, data=self.data[idx], diag_=self.diag_[idx])

    def core_solver(self, idx: int) -> KrylovSolver:
        return KrylovSolver(op=self.slot(idx), prec=self.prec_inv[idx], cfg=self.cfg)


def build_sparse_shift_ops(E: BellOp, A0: BellOp, shifts,
                           krylov_cfg: Krylov | None = None) -> SparseShiftOps:
    """Assemble the per-shift shifted block-ELL operators ``A₀ᵀ + μₛEᵀ`` and
    their block-Jacobi inverses.  ``E``/``A0``: pattern-sharing `BellOp`s
    (see `ops.sparse.bell_pencil`), or row shards of them
    (`parallel.mesh.shard_operator`): then every table holds the rank's
    block rows; ``shifts``: real host array, 1-D or the pair encoding with
    every ``Im μ = 0``.  ``krylov_cfg`` defaults to CG on the negated
    operator, ``tol = 10·eps``, ``maxiter = 400``.

    The operators are built one shift at a time into preallocated tensors
    (``μ·Eᵀ`` first, then ``+ A₀ᵀ``, the JAX package's rounding), so the
    transient memory is one shift's diagonal blocks, not a batch."""
    shifts = np.asarray(shifts)
    if shifts.ndim == 2:
        if np.any(shifts[:, 1] != 0):
            raise ValueError("block-ELL shift operators take real shifts only")
        shifts = shifts[:, 0]
    if np.iscomplexobj(shifts):
        raise ValueError("block-ELL shift operators take real shifts only")
    if krylov_cfg is None:
        eps = float(torch.finfo(E.dtype).eps)
        krylov_cfg = Krylov(method="cg", tol=10 * eps, maxiter=400,
                            preconditioner="block_jacobi", negate=True)
    At, Et = A0.adjoint(), E.adjoint()
    ns = shifts.shape[0]
    kw = dict(dtype=At.dtype, device=At.device)
    data = torch.empty((ns,) + tuple(At.data.shape), **kw)
    diag = torch.empty((ns,) + tuple(At.diag_.shape), **kw)
    inv = torch.empty((ns, At.nb, At.bs, At.bs), **kw)
    ops = SparseShiftOps(data=data, diag_=diag, prec_inv=inv,
                         base=dataclasses.replace(At, data=data[0], cols_t=None, data_t=None,
                                                  diag_=diag[0]), cfg=krylov_cfg)
    for s, mu in enumerate(shifts.tolist()):
        torch.mul(Et.data, mu, out=data[s])
        data[s] += At.data
        torch.mul(Et.diag_, mu, out=diag[s])
        diag[s] += At.diag_
        inv[s] = block_jacobi_inverses(ops.slot(s).diag_blocks())
    return ops


@dataclasses.dataclass(frozen=True)
class ShiftLUs:
    """LU factorizations of the shifted dense cores ``A₀ᵀ + μₛEᵀ``, one
    slot per shift: built once for a sweep, so a shift costs two triangular
    solves (plus the SMW correction of the feedback) instead of a new
    factorization."""

    lu: torch.Tensor  # (ns, n, n)
    piv: torch.Tensor  # (ns, n), 1-based (LAPACK)

    def core_solver(self, idx: int) -> DenseLUSolver:
        return DenseLUSolver(lu=self.lu[idx], piv=self.piv[idx])


def build_shift_lus(E: DenseOp, A0: DenseOp, shifts) -> ShiftLUs:
    """Factor ``A₀ᵀ + μₛEᵀ`` for every shift.  ``shifts``: host array, 1-D
    real or complex, or the pair encoding with every ``Im μ = 0``.  A real
    buffer gives real LUs in the operators' dtype, a complex one complex LUs
    (its pairs run the complex double step in `adi_compiled`).

    One `torch.linalg.lu_factor` per shift, into preallocated column-major
    (LAPACK) storage: a batched call would hold a second copy of every core
    (3.4 GB for 16 shifts at n = 5177), and on the CPU, once
    `torch.set_num_threads` has set more than one thread, it stalls in MKL
    for n ≳ 200 (torch 2.13)."""
    shifts = np.asarray(shifts)
    if shifts.ndim == 2:
        if np.any(shifts[:, 1] != 0):
            raise ValueError("pair-encoded conjugate pairs need a banded core; "
                             "pass dense cores a 1-D complex buffer")
        shifts = shifts[:, 0]
    At, Et = A0.M.T, E.M.T
    dt = At.dtype
    if np.iscomplexobj(shifts):
        dt = torch.promote_types(dt, torch.complex64)
    ns, n = shifts.shape[0], At.shape[0]
    lu = torch.empty((ns, n, n), dtype=dt, device=At.device).mT
    piv = torch.empty((ns, n), dtype=torch.int32, device=At.device)
    At = At.to(dt)
    for s, mu in enumerate(torch.as_tensor(shifts).to(dt).tolist()):
        lu[s], piv[s] = torch.linalg.lu_factor(At + mu * Et)
    return ShiftLUs(lu=lu, piv=piv)


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
    S = A.alpha * torch.eye(m, dtype=dtype, device=U.device) + row_allreduce(Vt @ AinvU)
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
    VP = row_allreduce(torch.cat([Vt @ P, Vt @ Q]))
    Sr = A.alpha * torch.eye(m, dtype=dtype, device=U.device) + VP[:m]
    Si = VP[m:]
    S2 = torch.cat([torch.cat([Sr, -Si], dim=1),
                    torch.cat([Si, Sr], dim=1)], dim=0)
    return PairSMWSolver(base=core, AinvU_re=P, AinvU_im=Q, V=Vt,
                         schur=_small_dense_solver(S2))


@on_operator_mesh
def adi_compiled(E, A, W0, T0, w_k: int, X0: LowRank, shifts, abstol: float,
                 cfg: CompiledConfig, shift_lus=None):
    """Low-rank ADI over a cyclic shift buffer.

    Args:
      E, A: operators (A may be a `LowRankUpdateOp` closed-loop coefficient).
      W0, T0: residual factors — residual = W T Wᵀ, W: (n, r_res) with
        ``w_k`` active leading columns; increments add ``w_k`` (or
        ``2·w_k``) columns to ``X``.
      X0: warm-start iterate; ``W0 T0 W0ᵀ`` must be the GALE residual at it.
      shifts: host array, 1-D real or ``(ns, 2)`` pair-encoded; 1-D
        complex (conjugates adjacent, `check_shift_pairing`), whose pairs
        run the complex double step, with `ShiftLUs`, `DiaShiftOps` or no
        cores.
      abstol: absolute residual tolerance.
      shift_lus: `DiaShiftOps`, `SparseShiftOps` or `ShiftLUs` built for
        ``shifts`` (only `DiaShiftOps` has the pair tables a pair-encoded
        conjugate pair needs), or ``None``: the uncached route, where each
        iteration solves through ``prepare_shifted(E, A, μ, inner)`` with
        ``inner = cfg.inner_alg`` or the operator kind's default.

    Compression runs every ``cfg.compression_interval`` iterations and
    whenever the next increment would overflow the capacity ``X0.r``; a
    numerical rank above the capacity is truncated.

    Columns beyond the capacity are dropped without `lr_add`'s warning
    (`lr_append`): the JAX package checks capacity only where ranks are
    host values, not in its compiled ADI (its ``models/compiled.py:486-635``),
    and the bench's capacity-96 Ros2 drops columns by design (71 times in 3
    steps at n = 1357), which would flood a sweep's log.

    Returns (X, W, iters, res_norm).
    """
    shifts = np.asarray(shifts)
    if np.iscomplexobj(shifts) and isinstance(shift_lus, SparseShiftOps):
        raise ValueError("block-ELL shift operators take real shifts only; pass "
                         "shift_lus=None for the uncached route")
    nshifts = shifts.shape[0]
    pair_encoded = shifts.ndim == 2
    q = W0.shape[1]
    dt = W0.dtype
    if shift_lus is None:
        # The kind of Aᵀ + μEᵀ is that of A, so its default solver is A's.
        inner = cfg.inner_alg if cfg.inner_alg is not None else default_inner_alg(A)
    else:
        sdt = shift_lus.lu.dtype if isinstance(shift_lus, ShiftLUs) else shift_lus.data.dtype

    def solve_at(mu, idx, W):
        """``(Aᵀ + μEᵀ)⁻¹W``: through slot ``idx``'s core and the SMW
        correction, in the cores' dtype, or without cores through a solver
        prepared for ``μ`` (complex ``W`` for a complex ``μ``)."""
        if shift_lus is None:
            if isinstance(mu, complex):
                W = W.to(torch.promote_types(dt, torch.complex64))
            return prepare_shifted(E, A, mu, inner).solve(W)
        return _wrap_smw(shift_lus.core_solver(idx), A, sdt).solve(W.to(sdt))

    def real_step(mu, idx, W, T, X):
        V = solve_at(mu, idx, W)
        V = (V.real if V.is_complex() else V).to(dt)
        incr = LowRank(L=V, D=(-2.0 * mu) * T, k=w_k)
        W_new = W - 2.0 * mu * E.tmm(V)
        return W_new, lr_append(X, incr, r_out=X.r), 1

    def double_step(mur, b, idx, W, T, X):
        if not pair_encoded:
            # One complex solve for the pair a ± b·i (1-D complex buffer).
            V = solve_at(complex(mur, b), idx, W)
            Vr, Vi = V.real.to(dt), V.imag.to(dt)
        else:
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
        X_new = lr_append(lr_append(X, incr1, r_out=X.r), incr2, r_out=X.r)
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
            mur, b = float(shifts[idx].real), float(shifts[idx].imag)
        if b == 0.0:
            W, X, used = real_step(mur, idx, W, T0, X)
        elif pair_encoded and getattr(shift_lus, "et_data", None) is None:
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


@on_operator_mesh
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
    BtLD = row_allreduce(B.T @ L) @ D
    K = BtLD @ E.tmm(L).T
    F_op = lr_update(lin_comb(A, -1.0 / (2.0 * tau), E), -1.0, B, K)

    G = torch.cat([C.T, E.tmm(L)], dim=1)
    r = L.shape[1]
    S = G.new_zeros((q + r, q + r))
    S[:q, :q] = torch.eye(q, dtype=G.dtype, device=G.device)
    S[q:, q:] = BtLD.T @ BtLD + D / tau
    R = LowRank(L=G, D=S, k=min(q + X.k, q + r))
    return F_op, residual_gale_lowrank(E, F_op, R, X, r_out=cfg.r_res)


@on_operator_mesh
def ros1_step_compiled(E, A, B, C, X: LowRank, tau: float, shifts,
                       abstol: float, cfg: CompiledConfig,
                       shift_lus=None):
    """One full LRSIF Ros1 (implicit Euler) GDRE time step, end to end:
    RHS assembly, the ADI loop, the feedback update.  ``shift_lus`` holds
    the cores of ``(A − E/(2τ))ᵀ + μEᵀ``; without them each ADI iteration
    prepares its own solver (`adi_compiled`'s uncached route).
    Returns (X_next, K_next, adi_iters, adi_residual_norm)."""
    F_op, res0 = ros1_initial_residual(E, A, B, C, X, tau, cfg)
    W0 = _mask_cols(res0.L, res0.k)
    X_new, _, iters, res = adi_compiled(E, F_op, W0, res0.D, res0.k, X,
                                        shifts, abstol, cfg, shift_lus)
    return X_new, feedback_K(E, B, X_new), iters, res


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


def _shift_buffer(sv, dtype: torch.dtype, nshifts: int, real_only: bool = False,
                  pair_encode: bool = False) -> np.ndarray:
    """Fixed-length host shift buffer: real if every shift is real, complex
    otherwise; padded cyclically.

    **Pair-preserving**: a complex ADI consumes a complex shift and advances
    its cyclic pointer by 2, assuming the conjugate is the next entry.  The
    buffer is therefore assembled from whole *units* — real singletons and
    adjacent conjugate pairs — so a truncation never splits a pair and the
    cyclic wrap lands on a unit boundary.  If the target length would cut a
    pair and no real shift is available as filler, the buffer grows by one
    slot instead (all-complex, odd ``nshifts``).

    ``real_only``: substitute each complex shift with the equal-modulus real
    shift ``-|v|`` (still in the open left half-plane, so the ADI stays
    convergent; only the rate suffers): the route for cores without pair
    tables.

    ``pair_encode``: emit the 2-D real ``(nshifts, 2)`` pair encoding, one
    ``(Re μ, |Im μ|)`` row per unit, with no adjacency constraints (the
    all-real double step, `DiaShiftOps.pair_solver`)."""
    arr = np.asarray(sv, np.complex128).ravel()
    rdt = torch.empty((), dtype=dtype).numpy().real.dtype
    if arr.size == 0:
        raise ValueError("empty shift set")
    if pair_encode:
        units = _pair_units(arr)
        out = [units[i % len(units)] for i in range(nshifts)]
        return np.asarray(out, np.float64).astype(rdt)
    if real_only:
        arr = np.where(np.abs(arr.imag) > 0, -np.abs(arr), arr.real + 0j)
    if np.allclose(arr.imag, 0.0):
        if arr.size < nshifts:
            arr = np.tile(arr, -(-nshifts // arr.size))
        return arr[:nshifts].real.astype(rdt)

    # Group into units: real singletons / conjugate pairs (made adjacent).
    units, i = [], 0
    tol = 1e-12
    while i < arr.size:
        v = arr[i]
        if abs(v.imag) <= tol * max(abs(v.real), 1e-300):
            units.append((complex(v.real),))
            i += 1
        elif i + 1 < arr.size and np.isclose(arr[i + 1], np.conj(v)):
            units.append((complex(v), complex(np.conj(v))))
            i += 2
        else:
            # Conjugate not adjacent (or missing): synthesize the pair so
            # the double step's recombination stays exact.
            units.append((complex(v), complex(np.conj(v))))
            i += 1
    real_units = [u for u in units if len(u) == 1]

    out, ui = [], 0
    while len(out) < nshifts:
        u = units[ui % len(units)]
        ui += 1
        if len(out) + len(u) > nshifts:
            u = real_units[0] if real_units else u  # grow by 1 if no filler
        out.extend(u)
    return np.asarray(out).astype(np.result_type(rdt, np.complex64))


def encode_shifts_for_operator(shifts, core) -> np.ndarray:
    """The shift buffer as the sweep hands it to the shift builders.

    In the JAX package this re-encodes complex buffers for the TPU; off the
    TPU, and so always here, the buffer passes unchanged (a host numpy
    array).  ``core`` is kept for the same signature.  A 1-D complex buffer
    raises later on block-ELL cores, in `build_sparse_shift_ops`."""
    del core
    return np.asarray(shifts)


def check_shift_pairing(shifts) -> None:
    """Validate that a cyclic 1-D complex shift buffer is unit-aligned:
    walking it as a complex ADI does (real → +1, complex → +2 with the
    conjugate adjacent) must land exactly on the buffer end.  Real and
    pair-encoded (2-D) buffers cannot split a pair and always pass."""
    arr = np.asarray(shifts)
    if arr.ndim == 2 or not np.iscomplexobj(arr):
        return
    i = 0
    while i < arr.size:
        v = arr[i]
        if v.imag == 0.0:
            i += 1
            continue
        if i + 1 >= arr.size or not np.isclose(arr[i + 1], np.conj(v)):
            raise ValueError(
                f"shift buffer splits a conjugate pair at index {i}: "
                f"{v} is not followed by its conjugate (pairs must be "
                "adjacent and fully contained)")
        i += 2


def build_step_shift_solvers(E, F_base, shifts, krylov_cfg: Krylov | None = None,
                             block_cache: dict | None = None):
    """Route the shifted-core preparation by operator kind: banded →
    `build_dia_shift_ops` (``block_cache`` is forwarded), block-ELL →
    `build_sparse_shift_ops`, dense → `build_shift_lus`."""
    core = F_base.A if isinstance(F_base, LowRankUpdateOp) else F_base
    sarr = np.asarray(shifts)
    if sarr.ndim == 2 and np.any(sarr[:, 1] != 0) and not isinstance(core, DiaOp):
        # Pair tables (the all-real stacked double step) exist only for
        # banded cores.
        raise ValueError(
            "pair-encoded shift buffer with nonzero Im(mu) requires a banded "
            f"(DiaOp) core, got {type(core).__name__}")
    if isinstance(core, DiaOp):
        return build_dia_shift_ops(E, core, shifts, krylov_cfg,
                                   block_cache=block_cache)
    if isinstance(core, BellOp):
        return build_sparse_shift_ops(E, core, shifts, krylov_cfg)
    if isinstance(core, DenseOp):
        return build_shift_lus(E, core, shifts)
    raise TypeError(f"no shift solver for {type(core).__name__}")


_ROS2_GAMMA = 1.0 + 1.0 / math.sqrt(2.0)


@on_operator_mesh
def ros2_step_compiled(E, A, B, C, X: LowRank, tau: float, shifts,
                       abstol: float, cfg: CompiledConfig, shift_lus):
    """One full LRSIF Ros2 (2-stage Rosenbrock) GDRE time step: the stage-1
    GALE with the indefinite 3×3 block right-hand side, the stage-2 GALE
    built from the stage-1 solution, and the combination
    ``X += (2 − 1/(2γ))τ·K₁ − (τ/2)·K₂``.  ``shift_lus`` must be built for
    the pencil ``(E, γτA − E/2)``.  Returns (X_next, K_next, adi_iters of
    both stages, the larger stage residual norm)."""
    gamma = _ROS2_GAMMA
    gt = gamma * tau
    K = feedback_K(E, B, X)
    # F = γτ·A − E/2 − γτ·B K: the core γτA − E/2 is what shift_lus
    # holds, the feedback enters through the SMW correction.
    F_core = lin_comb(scale_op(A, gt), -0.5, E)
    F = LowRankUpdateOp(F_core, -1.0 / gt, B, K)
    zero = LowRank(L=torch.zeros_like(X.L), D=torch.zeros_like(X.D), k=0)

    R1 = lr_compress(_ros2_rhs1(E, A, B, C, X), r_out=cfg.r_res)
    K1, _, it1, res1 = adi_compiled(E, F, _mask_cols(R1.L, R1.k), R1.D, R1.k,
                                    zero, shifts, abstol, cfg, shift_lus)
    R2 = lr_compress(_ros2_rhs2(E, B, K1, tau, gamma), r_out=cfg.r_res)
    K2, _, it2, res2 = adi_compiled(E, F, _mask_cols(R2.L, R2.k), R2.D, R2.k,
                                    zero, shifts, abstol, cfg, shift_lus)

    # Fold both stages back into the state capacity (dropping silently, as
    # `adi_compiled` does).
    X1 = lr_append(X, LowRank(L=K1.L, D=(2.0 - 1.0 / (2.0 * gamma)) * tau * K1.D,
                              k=K1.k), r_out=2 * X.r)
    X1 = lr_append(X1, LowRank(L=K2.L, D=(-tau / 2.0) * K2.D, k=K2.k), r_out=2 * X.r)
    X_new = lr_compress(X1, r_out=X.r)
    return X_new, feedback_K(E, B, X_new), it1 + it2, torch.maximum(res1, res2)


def _abstol_default(prob) -> float:
    """``n · eps · ‖C‖_F`` in the problem's dtype (the global ``n`` and
    ``‖C‖_F`` over the active mesh)."""
    return float(prob.n * torch.finfo(prob.B.dtype).eps * row_norm(prob.C))


def _sweep(step, prob, tstops, F_core, shifts, cfg, capacity, abstol,
           save_state, krylov_cfg, observer):
    """The fixed-step sweep shared by the Ros1 and Ros2 solvers, under the
    mesh of the problem's operators."""
    with use_mesh(mesh_of(prob.E)):
        E, A, B, C = prob.E, prob.A, prob.B, prob.C
        X = lr_with_capacity(lr_compress(prob.X0, r_out=prob.X0.r), capacity)
        tau = float(tstops[0] - tstops[1])
        shifts = encode_shifts_for_operator(shifts, F_core)
        check_shift_pairing(shifts)
        lus = build_step_shift_solvers(E, F_core, shifts, krylov_cfg)
        if abstol is None:
            abstol = _abstol_default(prob)
        Xs, Ks = [X], [feedback_K(E, B, X)]
        if observer is not None:
            observer(0, X, Ks[0], 0, None)
        iters_total, res_max = 0, 0.0
        for i in range(1, len(tstops)):
            X, K, iters, res = step(E, A, B, C, X, tau, shifts, abstol, cfg, lus)
            iters_total += iters
            res_max = max(res_max, float(res))
            Ks.append(K)
            if save_state:
                Xs.append(X)
            if observer is not None:
                observer(i, X, K, iters, res)
        if not save_state:
            Xs.append(X)
        sol = DRESolution(Xs, Ks, tstops)
        sol.adi_iters = iters_total
        sol.adi_res_max = res_max  # worst accepted GALE residual
        return sol


def solve_gdre_ros1_compiled(prob, *, dt: float, shifts, cfg: CompiledConfig,
                             capacity: int = 128, abstol: float | None = None,
                             save_state: bool = False,
                             krylov_cfg: Krylov | None = None,
                             fused: bool = False, observer=None) -> DRESolution:
    """Full LRSIF Ros1 GDRE sweep with fixed steps ``dt``.  The shifted
    cores ``(A − E/(2τ))ᵀ + μEᵀ`` are built once for the whole trajectory.

    ``abstol`` defaults to ``n·eps·‖C‖_F``.  ``fused=True`` runs the same
    per-step loop: PyTorch has no ``scan`` to fuse the sweep into.
    ``observer(i, X, K, iters, res)``, if given, is called at every stop:
    at ``i = 0`` once the shifted cores are built (``iters = 0``,
    ``res = None``), then after step ``i``.
    The solution carries ``adi_iters`` (total) and ``adi_res_max``.

    On a row-sharded problem (DIA shards split in ``PREC_BS``-row blocks or
    block-ELL shards in ``bs``-row blocks, ``X0`` and ``B`` split by rows
    and ``C`` by columns in the same blocks) every rank calls this
    with its shards; each ``K`` of the solution is then the rank's column
    shard (gather ``Kᵀ`` with `parallel.mesh.unshard_tall`), each ``X`` its
    row shard."""
    del fused
    tstops = time_grid(prob.tspan, dt)
    tau = float(tstops[0] - tstops[1])
    F_base = lin_comb(prob.A, -1.0 / (2.0 * tau), prob.E)
    return _sweep(ros1_step_compiled, prob, tstops, F_base, shifts, cfg,
                  capacity, abstol, save_state, krylov_cfg, observer)


def solve_gdre_ros2_compiled(prob, *, dt: float, shifts, cfg: CompiledConfig,
                             capacity: int = 128, abstol: float | None = None,
                             save_state: bool = False,
                             krylov_cfg: Krylov | None = None,
                             fused: bool = False, observer=None) -> DRESolution:
    """Full LRSIF Ros2 GDRE sweep with fixed steps ``dt`` (the reference
    bench's throughput configuration).  The shifted cores
    ``(γτA − E/2)ᵀ + μEᵀ`` are built once for the whole trajectory.
    Arguments and result as `solve_gdre_ros1_compiled`."""
    del fused
    tstops = time_grid(prob.tspan, dt)
    tau = float(tstops[0] - tstops[1])
    F_core = lin_comb(scale_op(prob.A, _ROS2_GAMMA * tau), -0.5, prob.E)
    return _sweep(ros2_step_compiled, prob, tstops, F_core, shifts, cfg,
                  capacity, abstol, save_state, krylov_cfg, observer)


# --- Kleinman–Newton for the GARE ------------------------------------------------

#: Host seconds that `solve_gare_newton_compiled` spent computing closed-loop
#: Penzl shifts in this process (on the card route, up to the read of the
#: last Hessenberg matrix, which waits for the device).
shift_rebuild_seconds = 0.0
#: Closed-loop Penzl shift rebuilds of `solve_gare_newton_compiled` in this
#: process, and those of them that took the card route
#: (`heuristic_shifts_card`).
shift_rebuilds = 0
shift_rebuilds_card = 0


def _shifts_on_card(E, A) -> bool:
    """Whether the Newton's closed-loop rebuilds take the card route
    (`heuristic_shifts_card`): symmetric unsharded `DiaOp`s on a CUDA
    device.  Everything else keeps `heuristic_shifts_host`, which draws the
    same set on every rank of a mesh."""
    return (isinstance(E, DiaOp) and isinstance(A, DiaOp) and E.device.type == "cuda"
            and E.symmetric is True and A.symmetric is True and mesh_of(E) is None)


@dataclasses.dataclass(frozen=True)
class PerStepHeuristic:
    """Recompute Penzl shifts on the **closed-loop** pencil ``(E, A − BKᵢ)``
    when the feedback has moved (see `solve_gare_newton_compiled`): a fixed
    open-loop shift buffer stalls the ADI as soon as the feedback moves the
    spectrum (strong-control regimes like ``G = 10⁶BBᵀ``)."""

    nshifts: int = 16
    kp: int = 20
    km: int = 20


@dataclasses.dataclass(frozen=True)
class CappedADI:
    """The compiled-ADI FGMRES preconditioner's configuration (the
    ``preconditioner`` of the ``inner_gmres`` config of
    `solve_gare_newton_compiled`): ``maxiters`` ADI iterations on incoming
    vectors cut or padded to ``r_in`` columns, into an iterate of
    ``capacity`` columns.  Mirrors the reference's
    ``ADI(maxiters=t, compression_interval=2t)`` preconditioner."""

    maxiters: int = 15
    r_in: int = 64
    capacity: int = 256


def make_compiled_adi_preconditioner(E, F, lus, shifts, *, maxiters: int,
                                     r_in: int = 64, capacity: int = 256,
                                     compression_interval: int = 1000):
    """A capped-ADI GALE preconditioner over the prepared shifted cores
    ``lus`` of ``shifts``: returns ``precond(GALEProblem) -> LowRank`` for
    `models.gmres.solve_gale_gmres`.  ``abstol = 0``, so exactly
    ``maxiters`` iterations run (fewer only if the residual vanishes).
    Each incoming right-hand side is brought to ``r_in`` storage columns by
    `lr_with_capacity` (a wider one is cut there, as in the JAX package)."""
    n = E.shape[0]
    pcfg = CompiledConfig(maxiters=maxiters,
                          compression_interval=compression_interval, r_res=r_in)

    def precond(p):
        C = lr_with_capacity(p.C, r_in)
        X0 = lr_zero(n, capacity, F.dtype, C.L.device)
        X, _, _, _ = adi_compiled(E, F, _mask_cols(C.L, C.k), C.D, C.k, X0,
                                  shifts, 0.0, pcfg, lus)
        return X

    return precond


def _linesearch_combine(X_prev: LowRank, X_tilde: LowRank, lam: float,
                        capacity: int) -> LowRank:
    """``(1−λ)·X_prev + λ·X̃`` compressed back to the iterate capacity."""
    X = lr_add(lr_scale(1.0 - lam, X_prev), lr_scale(lam, X_tilde),
               r_out=X_prev.r + X_tilde.r)
    return lr_compress(X, r_out=capacity)


@on_operator_mesh
def _newton_step_compiled(E, A, B, X: LowRank, K, res: LowRank, shifts,
                          inner_abstol: float, cfg: CompiledConfig, shift_lus):
    """One Kleinman–Newton step: the closed-loop GALE with
    ``F = A − BK`` warm-started at ``X``.

    ``res`` is the **GARE residual factor at X**: mathematically the
    warm-start closed-loop GALE residual (the cross terms cancel), and
    numerically far better than re-assembling ``[RHS  EᵀL  FᵀL]``, which
    cancels huge ``±KᵀK``-class terms.  Returns (X_new, adi_iters,
    adi_exit_res)."""
    F = LowRankUpdateOp(A, -1.0, B, K)
    W0 = _mask_cols(res.L, res.k)
    X_new, _, iters, ares = adi_compiled(E, F, W0, res.D, res.k, X, shifts,
                                         inner_abstol, cfg, shift_lus)
    return X_new, iters, ares


def _newton_step_fgmres(E, A, B, Ct, X: LowRank, K, shifts, shift_lus, inner_gmres,
                        inner_abstol: float, capacity: int, observer) -> LowRank:
    """One Kleinman–Newton step by FGMRES: the closed-loop GALE with
    ``F = A − BK`` and right-hand side ``[Cᵀ, EᵀL·(BᵀLD)ᵀ]``, preconditioned
    by the capped compiled ADI (`make_compiled_adi_preconditioner`) over
    the step's shifted cores; the result compressed to ``capacity``."""
    from .gmres import solve_gale_gmres
    from .problems import GALEProblem

    F = lr_update(A, -1.0, B, K)
    EtL = E.tmm(X.L)
    BtLD = (B.T @ X.L) @ X.D
    qm = Ct.shape[1] + B.shape[1]
    RHS = LowRank(L=torch.cat([Ct, EtL @ BtLD.T], dim=1),
                  D=torch.eye(qm, dtype=X.dtype, device=X.device), k=qm)
    spec = inner_gmres.preconditioner
    pre = make_compiled_adi_preconditioner(E, F, shift_lus, shifts, maxiters=spec.maxiters,
                                           r_in=spec.r_in, capacity=spec.capacity)
    X = lr_slice_active(solve_gale_gmres(
        GALEProblem(E, F, RHS), dataclasses.replace(inner_gmres, preconditioner=pre),
        abstol=inner_abstol, initial_guess=X, observer=observer))
    return lr_compress(lr_with_capacity(X, max(X.r, capacity)), r_out=capacity)


def _whole_rows(op, M: torch.Tensor) -> torch.Tensor:
    """``M`` split by rows as the row-sharded operator ``op`` is, gathered
    whole on every rank (`ShardedDiaOp.gather_rows`); ``M`` itself beside
    an unsharded ``op``."""
    gather = getattr(op, "gather_rows", None)
    return M if gather is None else gather(M)


def _same_on_every_rank(buf: np.ndarray, device) -> None:
    """Raise unless every rank of the active mesh holds the same host
    array (an all-gather; nothing without a mesh)."""
    if active_mesh() is None:
        return
    t = torch.as_tensor(buf, device=device)
    if not all(torch.equal(p, t) for p in row_allgather(t)):
        raise RuntimeError("the ranks drew different shift sets")


@on_problem_mesh
def solve_gare_newton_compiled(prob, *, shifts, cfg: CompiledConfig,
                               capacity: int = 192, maxiters: int = 60,
                               reltol: float | None = None, inexact: bool = True,
                               krylov_cfg: Krylov | None = None, observer=None,
                               inner_gmres=None, linesearch: bool = True,
                               continuation_ratio: float = 1000.0,
                               stage_reltol: float = 1e-1,
                               shift_reuse_tol: float = 0.3,
                               inner_solve_dtype=None):
    """Kleinman–Newton for the GARE over `adi_compiled`, with Eisenstat–Walker
    forcing and switch-back, an Armijo line search, a stall guard and
    **continuation in the control strength**.  Runs on the device of the
    problem's tensors.

    ``shifts``: a fixed (cyclically consumed) host shift buffer, 1-D real or
    pair-encoded, or a `PerStepHeuristic` that recomputes closed-loop Penzl
    shifts (and the shifted cores) when the feedback has moved by more than
    ``shift_reuse_tol`` in relative Frobenius norm.  Closed-loop shift sets
    are pair-encoded on banded (`DiaOp`) cores and made real (``-|μ|``) on
    any other core.  They are computed on the card (`heuristic_shifts_card`)
    for a symmetric unsharded `DiaOp` pencil on a CUDA device
    (`_shifts_on_card`) and on the host (`heuristic_shifts_host`) otherwise,
    or from the first ``E`` or ``−A`` that turns out not definite on.

    **Equilibration.**  ``GARE(E, A, G, Q)`` is solved as
    ``GARE(E, A, G/σ, σQ)`` with ``σ = √(‖G‖/‖Q‖)`` and the solution
    unscaled (``X = Y/σ``): exact, and it leaves ``K`` invariant.

    **Continuation.**  Newton from ``X₀ = 0`` on strong-control problems has
    a huge first-step residual hump.  The first (probe) step is
    θ-independent (``K = 0``); when it shows a hump the solver solves the
    family ``GARE(E, A, θĜ, Q̂)`` for ``θ: θ₀ → 1`` geometrically (factor
    ``continuation_ratio``), intermediate stages only to ``stage_reltol``,
    splitting a stage jump whose entry residual exceeds 1e3 × the previous
    stage's exit residual.

    ``inner_gmres``: a `GMRES` config whose ``preconditioner`` is a
    `CappedADI`; each Newton step then solves its closed-loop GALE by
    matrix-valued FGMRES (`models.gmres.solve_gale_gmres`) preconditioned by
    the capped compiled ADI over the step's shifted cores, and compresses
    the result back to ``capacity`` (its ``adi_iters`` entry is ``-1``).
    ``inner_solve_dtype`` (e.g. "float32"): without ``krylov_cfg``, the
    shifted cores' default Krylov configuration gets this ``solve_dtype``,
    so banded cores solve in a low-precision core with iterative refinement
    (`DiaShiftOps`).

    **Row shards** (ROADMAP item 10d): with DIA row shards of ``E`` and
    ``A`` (`parallel.mesh.shard_operator`, ``block=PREC_BS``) and ``G`` and
    ``Q`` split by rows in the same blocks, every rank calls this with its
    shards and runs under their mesh.  Every host branch reads an
    all-reduced value (the norms, the line search's, the rebuild gate's
    ``stale_rel`` and ``‖BθK‖_F``) or a replicated one (ADI counts).
    `PerStepHeuristic` gathers the pencil (`ShardedDiaOp.to_scipy`) and
    ``B`` once, and ``K`` at each rebuild: every rank then draws the same
    Penzl shifts from the same inputs, which an all-gather checks.  ``X``
    comes out split by rows; ``info`` is the same on every rank.
    ``inner_gmres`` has no row-sharded path.

    Returns (X, info): the residual history in the original problem's
    units, ADI iteration counts, the θ log, line-search λs, the shift
    rebuild count, ``newton_steps`` and ``converged``.
    """
    global shift_rebuild_seconds, shift_rebuilds, shift_rebuilds_card
    E, A, Q = prob.E, prob.A, prob.Q
    n = prob.n  # global: the rows of a shard are Q.L's
    dtype, dev = prob.G.L.dtype, prob.G.L.device
    if inner_gmres is not None and mesh_of(E) is not None:
        raise NotImplementedError("the FGMRES inner solver has no row-sharded path")
    notify(observer, "gare_start", prob, None)

    # --- scale equilibration (exact) ---------------------------------------
    # GARE(E, A, G/σ, σQ) has solution Y = σX; σ = √(‖G‖/‖Q‖) balances
    # ‖Ĝ‖ = ‖Q̂‖.
    norm_G = float(lr_norm(prob.G))
    norm_Q = float(lr_norm(Q))
    sigma = math.sqrt(norm_G / norm_Q) if norm_G > 0 and norm_Q > 0 else 1.0
    if 0.25 < sigma < 4.0:
        sigma = 1.0  # already balanced; skip the scaling round trip
    sqrt_s = _in_dtype(math.sqrt(sigma), dtype)
    B = prob.G.L[:, :prob.G.k] / sqrt_s
    Ct = sqrt_s * Q.L[:, :Q.k]
    Qs = LowRank(L=sqrt_s * Q.L, D=Q.D, k=Q.k)
    Gs = LowRank(L=prob.G.L / sqrt_s, D=prob.G.D, k=prob.G.k)

    eps = float(torch.finfo(dtype).eps)
    if reltol is None:
        reltol = n * eps
    res0_norm = sigma * norm_Q  # ‖σQ‖ = ‖Q̂‖ = residual at X = 0
    abstol = reltol * res0_norm  # scaled units (≡ reltol·‖Q‖ original)
    inner_reltol = reltol / 10.0

    per_step = isinstance(shifts, PerStepHeuristic)
    block_cache = {}
    base_A = A.A if isinstance(A, LowRankUpdateOp) else A
    # No 1-D complex route: closed-loop conjugate pairs take the all-real
    # stacked double step on banded cores and are made real elsewhere.
    pair_shifts = isinstance(base_A, DiaOp)
    nonsym = (getattr(base_A, "symmetric", None) is False
              or getattr(E, "symmetric", None) is False)

    def _krylov_for(shift_buf):
        """``krylov_cfg``; without one and with ``inner_solve_dtype``, the
        default banded Krylov configuration for the buffer (BiCGStab where
        it has a conjugate pair or the pencil is nonsymmetric, as
        `build_dia_shift_ops` chooses) with that ``solve_dtype``."""
        if krylov_cfg is not None or inner_solve_dtype is None:
            return krylov_cfg
        buf = np.asarray(shift_buf)
        has_pairs = buf.ndim == 2 and bool(np.any(buf[:, 1] != 0))
        return dataclasses.replace(
            default_dia_krylov(E.dtype, has_pairs or nonsym or np.iscomplexobj(buf)),
            solve_dtype=inner_solve_dtype)

    if per_step:
        strat = shifts
        E_sp = E.to_scipy()  # gathered from row shards
        A_sp = A.to_scipy()
        B_whole = _whole_rows(E, B)
        # Mean row 2-norm of E: converts shift magnitudes (pencil eigenvalue
        # units) to A-entry units for the feedback-perturbation gate below.
        e_row_scale = float(np.sqrt((E_sp.data ** 2).sum() / E_sp.shape[0]))
        lus = None
        shifts = None
        shift_lu_cache = {}  # open-loop splu(E)/splu(A) shared by rebuilds
        on_card = _shifts_on_card(E, A)
        card_cache = {}  # the card route's warm starts
    else:
        shifts = encode_shifts_for_operator(shifts, A)
        check_shift_pairing(shifts)
        lus = build_step_shift_solvers(E, A, shifts, _krylov_for(shifts),
                                       block_cache=block_cache)

    def gare_res(X, theta):
        """GARE residual factor for the θ-stage problem (G_θ = θ·Ĝ)."""
        Gt = Gs if theta == 1.0 else LowRank(
            L=Gs.L, D=_in_dtype(theta, dtype) * Gs.D, k=Gs.k)
        return residual_gare_lowrank(E, A, Gt, Qs, X, r_out=cfg.r_res)

    X = lr_zero(Q.L.shape[0], capacity, dtype, dev)
    X_prev = None
    theta = 1.0
    probing = True       # hump detection armed until the first accepted step
    just_staged = True   # suppress line search across stage boundaries
    history, adi_iters, thetas, lams = [], [], [], []
    rebuilds = 0
    K_at_shifts = None
    stalls = 0
    converged = False
    newton_steps = 0
    res_norm_prev = math.inf
    eta_cap = 0.1
    theta_base = None      # θ of the last converged stage
    stage_exit_res = None  # residual at that stage's convergence
    hump_cap = 1.0e3       # max stage-entry residual growth before a split
    ls_failures = 0
    while True:
        Bt = B if theta == 1.0 else _in_dtype(math.sqrt(theta), dtype) * B
        K = feedback_K(E, Bt, X)
        res = gare_res(X, theta)
        res_norm = float(lr_norm(res))

        # Adaptive stage splitting: a θ jump whose entry residual exceeds
        # ``hump_cap ×`` the previous stage's exit residual is split
        # geometrically until the hump is bounded; at ratio < 4 whatever
        # remains is accepted.
        if (just_staged and stage_exit_res is not None
                and theta > theta_base
                and theta / theta_base >= 4.0
                and res_norm > hump_cap * max(stage_exit_res, abstol)):
            theta = math.sqrt(theta_base * theta)
            thetas[-1] = theta
            notify(observer, "gare_metadata", "continuation split", theta)
            continue

        if (X_prev is not None and not just_staged
                and res_norm > 0.9 * res_norm_prev):
            if probing and res_norm > 10.0 * res_norm_prev:
                # Hump on the probe step: enter continuation.  The probe step
                # is θ-independent (K was 0), so X is also the first Newton
                # iterate of the θ₀-stage problem; keep it.
                theta = min(1.0, 0.3 * res_norm_prev / res_norm)
                probing = False
                just_staged = True
                thetas.append(theta)
                notify(observer, "gare_metadata", "continuation", theta)
                continue
            if linesearch:
                # Armijo line search: backtrack along the segment to X_prev
                # until sufficient decrease.
                armijo, beta = 0.1, 0.5
                lam = beta
                X_tilde = X
                failed = False
                while True:
                    X_try = _linesearch_combine(X_prev, X_tilde, lam, capacity)
                    res_try = gare_res(X_try, theta)
                    rn_try = float(lr_norm(res_try))
                    if rn_try < (1.0 - lam * armijo) * res_norm_prev:
                        X, res, res_norm = X_try, res_try, rn_try
                        K = feedback_K(E, Bt, X)
                        break
                    lam *= beta
                    if lam < eps:
                        failed = True
                        break
                if failed:
                    # No descent along the whole segment: reject the step,
                    # revert to X_prev, tighten the forcing and retry; give
                    # up after 3 rejections.
                    ls_failures += 1
                    eta_cap = eta_cap / 10.0
                    warnings.warn(
                        "Line search failed; rejecting the step and "
                        f"tightening forcing (eta_cap={eta_cap:g})")
                    lam = 0.0
                    X = X_prev
                    res = gare_res(X, theta)
                    res_norm = float(lr_norm(res))
                    K = feedback_K(E, Bt, X)
                    if ls_failures >= 3:
                        lams.append(lam)
                        notify(observer, "gare_failed")
                        warnings.warn(
                            "compiled Newton: 3 rejected steps in a row "
                            f"(residual={res_norm / sigma:g}); aborting")
                        break
                else:
                    ls_failures = 0
                lams.append(lam)
                notify(observer, "gare_metadata", "line search", lam)
        probing = probing and newton_steps == 0

        history.append(res_norm / sigma)  # original units
        notify(observer, "gare_step", newton_steps, X, res, res_norm / sigma)

        stage_abstol = abstol if theta >= 1.0 else max(
            abstol, stage_reltol * res0_norm)
        if res_norm <= stage_abstol:
            if theta >= 1.0:
                converged = True
                break
            theta_base = theta
            stage_exit_res = res_norm
            theta = min(1.0, theta * continuation_ratio)
            thetas.append(theta)
            just_staged = True
            res_norm_prev = math.inf
            # The θ jump rescales B_θ, so the closed-loop pencil moved even
            # though K did not: mark the shift set stale.
            K_at_shifts = None
            continue
        if newton_steps >= maxiters:
            notify(observer, "gare_failed")
            warnings.warn(
                f"compiled Newton did not converge: residual="
                f"{res_norm / sigma:g} abstol={abstol / sigma:g} "
                f"maxiters={maxiters}")
            break

        if inexact:
            # Scale-invariant forcing (Eisenstat–Walker choice 2,
            # η = min(η_cap, 0.9·(‖res_k‖/‖res_{k-1}‖)²)) with hybrid
            # switch-back to the classical tolerance.
            if res_norm_prev == math.inf:
                ratio = 1.0
                eta = eta_cap
            else:
                ratio = res_norm / max(res_norm_prev, 1e-300)
                eta = min(eta_cap, 0.9 * ratio * ratio)
            inner_abstol = max(eta * res_norm, inner_reltol * res_norm)
        else:
            ratio = (1.0 if res_norm_prev == math.inf
                     else res_norm / max(res_norm_prev, 1e-300))
            inner_abstol = inner_reltol * res_norm

        # Rebuild the closed-loop shifts when they are stale.  Shifts depend
        # on the feedback only through the pencil perturbation ``BθK``, so a
        # rebuild waits until ‖BθK‖ matters against the spectral scale the
        # shifts resolve (min |μ| · E-row-scale); then K moving ~100 %, or
        # > 2·tol with slow progress, or > tol in the end game triggers it.
        if per_step:
            if K_at_shifts is None or K_at_shifts.shape != K.shape:
                stale_rel = math.inf
            else:
                stale_rel = float(row_norm(K - K_at_shifts)) / max(
                    float(row_norm(K)), 1e-300)
            if lus is None or shifts is None:
                feedback_matters = True  # first build is unconditional
            else:
                m_in = Bt.shape[1]
                Gm = row_allreduce(Bt.T @ Bt)
                p = float(torch.sqrt(torch.clamp(
                    row_allreduce(torch.sum(K * (Gm @ K))), min=0.0)))  # ‖BθK‖_F
                sh = np.asarray(shifts)
                s_abs = np.abs(sh[:, 0]) if sh.ndim == 2 else np.abs(sh.real)
                s_min = float(np.min(s_abs[s_abs > 0])) \
                    if np.any(s_abs > 0) else 0.0
                feedback_matters = (
                    p / max(np.sqrt(m_in), 1.0) > 0.05 * s_min * e_row_scale)
            # The end game: the final θ-stage within 100× of the target.
            asymptotic = theta >= 1.0 and res_norm <= 100.0 * abstol
            slow = res_norm_prev != math.inf and ratio > 0.5
            # Effectiveness veto: an inner ADI that just stopped within 5
            # iterations counts as proof that the shifts still work, even if
            # it stopped at its maxiters (kept as the JAX package has it).
            last_iters = adi_iters[-1] if adi_iters else None
            still_effective = (last_iters is not None
                               and 0 < last_iters <= 5)
            if lus is None or (feedback_matters and not still_effective
                               and (
                    stale_rel == math.inf or stale_rel > 1.0
                    or (stale_rel > 2.0 * shift_reuse_tol and slow)
                    or (stale_rel > shift_reuse_tol and asymptotic))):
                # Rebuilds after the first run half-depth Arnoldi,
                # warm-started from the previous rebuild's dominant Ritz
                # vector (kept in the route's cache).
                rebuilt_before = shifts is not None
                kp_r = max(12, strat.kp // 2) if rebuilt_before else strat.kp
                km_r = max(12, strat.km // 2) if rebuilt_before else strat.km
                # Release the old shifted cores before the rebuild: the card
                # route's factors take their place, and the build theirs.
                lus = None
                sv = None
                t0 = time.perf_counter()
                if on_card:
                    try:
                        sv = heuristic_shifts_card(
                            E, A, strat.nshifts, kp_r, km_r, B=Bt, K=K,
                            cache=card_cache, warm_start=rebuilt_before)
                        shift_rebuilds_card += 1
                    except NotDefinite as err:
                        on_card = False  # the host route for the rest of the solve
                        warnings.warn(f"closed-loop shifts on the host route: {err}")
                if sv is None:
                    Bt_whole = B_whole if theta == 1.0 else (
                        _in_dtype(math.sqrt(theta), dtype) * B_whole)
                    # In K's own (row-major) layout: the host products of
                    # the Arnoldi round as the unsharded run's do.
                    K_whole = _whole_rows(E, K.T).T.contiguous()
                    sv = heuristic_shifts_host(
                        E_sp, A_sp, strat.nshifts, kp_r, km_r,
                        B=Bt_whole.cpu().numpy(), K=K_whole.cpu().numpy(),
                        lu_cache=shift_lu_cache, warm_start=rebuilt_before)
                shift_rebuild_seconds += time.perf_counter() - t0
                shift_rebuilds += 1
                shifts = _shift_buffer(sv, dtype, strat.nshifts,
                                       real_only=not pair_shifts,
                                       pair_encode=pair_shifts)
                _same_on_every_rank(shifts, dev)
                lus = build_step_shift_solvers(E, A, shifts, _krylov_for(shifts),
                                               block_cache=block_cache)
                K_at_shifts = K
                rebuilds += 1

        X_prev, res_norm_prev = X, res_norm
        just_staged = False
        if inner_gmres is not None:
            X = _newton_step_fgmres(E, A, Bt, Ct, X, K, shifts, lus, inner_gmres,
                                    inner_abstol, capacity, observer)
            adi_iters.append(-1)  # FGMRES: its counts go to the observer
            newton_steps += 1
            continue
        X, iters, _ = _newton_step_compiled(E, A, Bt, X, K, res, shifts,
                                            inner_abstol, cfg, lus)
        adi_iters.append(int(iters))
        newton_steps += 1
        # Stall guard: the inner ADI accepted its entry residual (zero
        # iterations).  Tighten the forcing once; a second consecutive stall
        # aborts.
        if int(iters) == 0:
            stalls += 1
            if stalls == 1:
                eta_cap = eta_cap / 10.0
            else:
                notify(observer, "gare_failed")
                warnings.warn(
                    "compiled Newton stalled: inner ADI made no progress "
                    f"twice (residual={res_norm / sigma:g}, "
                    f"abstol={abstol / sigma:g}); aborting")
                break
        else:
            stalls = 0

    if sigma != 1.0:
        X = lr_scale(1.0 / sigma, X)
    notify(observer, "gare_done", len(history) - 1, X, None, res_norm / sigma)
    return X, {"residuals": history, "adi_iters": adi_iters,
               "abstol": abstol / sigma, "sigma": sigma,
               "converged": converged, "thetas": thetas,
               "linesearch_lams": lams, "shift_rebuilds": rebuilds,
               "newton_steps": newton_steps}

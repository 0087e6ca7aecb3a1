"""Block linear solvers: ``A X = B`` with multiple right-hand sides.

Port of the JAX package's ``ops/blocklinear.py``: the algorithm configs
(`Backslash`, `ShermanMorrisonWoodbury`, `Krylov`), `prepare` (a factored
solver for an operator under a config) and the prepared solvers —
preconditioned CG, BiCGStab and restarted GMRES over sparse operators
(diagonal or block Jacobi), the mixed-precision `RefinedKrylovSolver`,
dense LU (`torch.linalg.lu_factor`, cuSOLVER on the card), and the
Sherman–Morrison–Woodbury wrappers (real and stacked-real pair forms).

The Krylov iterations reproduce ``jax.scipy.sparse.linalg`` exactly (so
iteration counts and results agree with the reference):

* inner products run over the whole ``(q, N)`` block as one vector;
* the loop runs while ``‖r‖² > max(tol²‖b‖², atol²)`` and ``k < maxiter``;
* BiCGStab keeps its ``exit_early`` select and stops on breakdown
  (``ρ = 0``, ``α = 0`` or ``ω = 0``);
* the start ``x₀ = 0`` still costs one product ``A(x₀)``;
* complex iterates are tested on the real part of ``⟨r, r⟩`` (the
  ``_vdot_real_tree`` of ``jax.scipy``), as CG's ``⟨p, Ap⟩`` and ``⟨r, z⟩``
  are;
* GMRES is ``jax.scipy``'s ``solve_method="batched"``: left
  preconditioning, ``maxiter`` restart cycles of ``restart`` Arnoldi steps
  each (one classical Gram–Schmidt pass, as its
  ``_iterative_classical_gram_schmidt`` with ``max_iterations=2`` runs),
  a cycle cut short only by a breakdown ``‖v‖ ≤ eps·‖v₀‖``, and the small
  least-squares problem solved by its normal equations.

Each iteration's convergence test reads one boolean back to the host
(one sync per iteration; for GMRES each restart test and each Arnoldi
step's breakdown test); `krylov_iterations` counts them and
`krylov_solves` the solves.

Real CG on the card under a Jacobi or block-Jacobi preconditioner, with no
mesh active, runs the fused iteration (`_cg_fused`: the product, then the
four kernels of `kernels.cg_fused`, its scalars on the device and the same
one host read an iteration); `krylov_fused_iterations` counts its
iterations.  Every other solve runs the loops below.

Over a row-sharded operator (`parallel.sharded_ops.ShardedDiaOp` or
`ShardedBellOp`, under its mesh: `parallel.mesh.use_mesh`) each rank holds
its rows of every block, and every inner product, the right-hand side's
norm, GMRES's projections (one all-reduce of all of an Arnoldi step's) and
the SMW's small systems are all-reduced over the ranks (`row_allreduce`),
so every rank reads the same values and takes the same branches: CG,
BiCGStab, GMRES and the refined core alike.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np
import torch
import torch.nn.functional as F

from ..kernels import cg_fused
from ..kernels.cg_fused import block_apply as _block_apply
from ..kernels.cg_fused import block_apply_t as _block_apply_t
from ..parallel.mesh import active_mesh, row_allreduce, row_norm
from ..utils.timers import timeit
from .operators import DenseOp, LowRankUpdateOp, as_operator

#: Krylov iterations run in this process — one host sync each.
krylov_iterations = 0
#: Krylov solves run in this process.
krylov_solves = 0
#: Of `krylov_iterations`, those run by the fused CG iteration (`_cg_fused`).
krylov_fused_iterations = 0


@dataclasses.dataclass(frozen=True)
class BlockLinearProblem:
    """``A X = B``."""

    A: object
    B: torch.Tensor


@dataclasses.dataclass(frozen=True)
class Backslash:
    """Direct dense solve through an LU factorization on the tensors'
    device (cuSOLVER on the card)."""


@dataclasses.dataclass(frozen=True)
class ShermanMorrisonWoodbury:
    """SMW for `LowRankUpdateOp` coefficients: ``(A + α⁻¹UV)X = B``.

    ``outer`` solves against the base operator, ``inner`` the small dense
    Schur complement.
    """

    outer: object = Backslash()
    inner: object = Backslash()


@dataclasses.dataclass(frozen=True)
class Krylov:
    """Matrix-free iterative solve (for sparse operators).

    method: "bicgstab" (general), "cg" (symmetric definite) or "gmres"
    (restarted, ``restart`` Arnoldi steps a cycle, ``maxiter`` cycles).
    preconditioner: "jacobi" (diagonal) or "block_jacobi" (explicit
    inverses of the 128×128 diagonal blocks, one batched product per
    application).  The compiled paths build their block-Jacobi solvers
    themselves, whatever this field says.
    negate: solve ``(−A)X = −B`` — lets CG run on symmetric *negative*
    definite shifted coefficients ``Aᵀ + μEᵀ`` (A stable, μ < 0).
    solve_dtype, refine_iters: the mixed-precision core: a ``solve_dtype``
    other than the operator's (e.g. "float32" under an f64 operator; made
    complex for complex operators) runs the Krylov core in that dtype and
    recovers full-dtype accuracy with ``refine_iters`` sweeps of iterative
    refinement (`RefinedKrylovSolver`); one equal to it runs plain Krylov.
    """

    method: str = "bicgstab"
    tol: float = 1e-12
    atol: float = 0.0
    maxiter: int = 1000
    restart: int = 40  # gmres only
    preconditioner: str = "jacobi"
    negate: bool = False
    solve_dtype: str | None = None
    refine_iters: int = 2


@dataclasses.dataclass(frozen=True)
class DenseLUSolver:
    lu: torch.Tensor
    piv: torch.Tensor

    def solve(self, B: torch.Tensor) -> torch.Tensor:
        B = B.to(self.lu.dtype)
        if B.dim() == 1:
            return torch.linalg.lu_solve(self.lu, self.piv, B[:, None])[:, 0]
        return torch.linalg.lu_solve(self.lu, self.piv, B)


@dataclasses.dataclass(frozen=True)
class SMWSolver:
    """Cached SMW pieces: base solver, ``A⁻¹U``, factored Schur complement."""

    base: object  # prepared solver for A
    AinvU: torch.Tensor  # (n, m)
    V: torch.Tensor  # (m, n)
    schur: object  # prepared solver for S = αI + V A⁻¹U

    def solve(self, B: torch.Tensor) -> torch.Tensor:
        with timeit("smw.solve"):
            AinvB = self.base.solve(B)
            t = self.schur.solve(row_allreduce(self.V @ AinvB))
            return AinvB - self.AinvU @ t


@dataclasses.dataclass(frozen=True)
class PairBlockPrec:
    """Block-Jacobi preconditioner of a *complex* shifted operator in
    stacked-real form: ``M⁻¹ = P + i·Q`` applied to lane-stacked real/imag
    states (see `ops.dia.DiaPairOp`)."""

    re: torch.Tensor  # (nb, bs, bs)
    im: torch.Tensor

    def apply_t(self, xt: torch.Tensor) -> torch.Tensor:
        q = xt.shape[0] // 2
        xr, xi = xt[:q], xt[q:]
        return torch.cat([
            _block_apply_t(self.re, xr) - _block_apply_t(self.im, xi),
            _block_apply_t(self.im, xr) + _block_apply_t(self.re, xi),
        ])

    def apply(self, x: torch.Tensor) -> torch.Tensor:
        q = x.shape[1] // 2
        xr, xi = x[:, :q], x[:, q:]
        return torch.cat([
            _block_apply(self.re, xr) - _block_apply(self.im, xi),
            _block_apply(self.im, xr) + _block_apply(self.re, xi),
        ], dim=1)


def _vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Inner product ``⟨x, y⟩`` (``x`` conjugated) of two blocks taken as
    one vector each (over the ranks of the active mesh)."""
    return row_allreduce(torch.vdot(x.reshape(-1), y.reshape(-1)))


def _vdot_real(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Real part of ``⟨x, y⟩``: ``⟨Re x, Re y⟩ + ⟨Im x, Im y⟩``."""
    if not (x.is_complex() or y.is_complex()):
        return _vdot(x, y)
    return _vdot(x.real, y.real) + _vdot(x.imag, y.imag)


def _continue(flag: torch.Tensor) -> bool:
    global krylov_iterations
    if not bool(flag):  # host sync
        return False
    krylov_iterations += 1
    return True


def _cg(A, b, *, maxiter, tol, atol, M):
    """Preconditioned CG as ``jax.scipy.sparse.linalg.cg``."""
    atol2 = torch.clamp(tol * tol * _vdot_real(b, b), min=atol * atol)
    x = torch.zeros_like(b)
    r = b - A(x)
    z = p = M(r)
    gamma = _vdot_real(r, z).to(p.dtype)
    k = 0
    while k < maxiter and _continue(_vdot_real(r, r) > atol2):
        Ap = A(p)
        alpha = gamma / _vdot_real(p, Ap).to(p.dtype)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        gamma_ = _vdot_real(r, z).to(p.dtype)
        p = z + (gamma_ / gamma) * p
        gamma = gamma_
        k += 1
    return x


def _cg_fused(A, b, *, s, prec, axis, maxiter, tol, atol):
    """`_cg` on ``(sA)x = b`` with ``M = s·prec``, whose iteration after the
    product ``a = A(p)`` runs as the four kernels of `kernels.cg_fused` on
    one workspace (their plain versions on the CPU): the same formulas,
    stopping test and host read an iteration.  ``b``: the state, ``(n,)``
    or 2-D with problem axis ``axis``."""
    global krylov_fused_iterations
    squeeze = b.dim() == 1
    if squeeze:
        b = b[:, None]
    b = b.contiguous()
    atol2 = torch.clamp(tol * tol * _vdot_real(b, b), min=atol * atol)
    x = torch.zeros_like(b)
    with torch.cuda.device(b.device) if b.is_cuda else contextlib.nullcontext():
        ws = cg_fused.workspace(x, b - s * A(x), prec, s, axis, atol2)
        cg_fused.precond(ws)
        ws.p.copy_(ws.z)
        ws.flag.copy_((_vdot_real(ws.r, ws.r) > atol2).reshape(1))
        k = 0
        while k < maxiter and _continue(ws.flag):
            krylov_fused_iterations += 1
            cg_fused.iteration(ws, A(ws.p))
            k += 1
    return ws.x[:, 0] if squeeze else ws.x


def _bicgstab(A, b, *, maxiter, tol, atol, M):
    """Preconditioned BiCGStab as ``jax.scipy.sparse.linalg.bicgstab``."""
    atol2 = torch.clamp(tol * tol * _vdot_real(b, b), min=atol * atol)
    x = torch.zeros_like(b)
    r = b - A(x)
    rhat, p, q = r, r, r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    alpha = omega = rho = one
    broken = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0
    while k < maxiter and _continue((_vdot_real(r, r) > atol2) & ~broken):
        rho_ = _vdot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p = r + beta * (p - omega * q)
        phat = M(p)
        q = A(phat)
        alpha = rho_ / _vdot(rhat, q)
        s = r - alpha * q
        exit_early = _vdot_real(s, s) < atol2
        shat = M(s)
        t = A(shat)
        omega = _vdot(t, s) / _vdot(t, t)
        x = torch.where(exit_early, x + alpha * phat,
                        x + (alpha * phat + omega * shat))
        r = torch.where(exit_early, s, s - omega * t)
        broken = (omega == 0) | (alpha == 0) | (rho_ == 0)
        rho = rho_
        k += 1
    return x


def _norm(x: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(_vdot_real(x, x))


def _safe_normalize(x: torch.Tensor, thresh=None):
    """``(x/‖x‖, ‖x‖)``, or ``(0, 0)`` where ``‖x‖ ≤ thresh`` (default the
    dtype's eps), as ``jax.scipy``'s ``_safe_normalize``."""
    norm = _norm(x)
    if thresh is None:
        thresh = torch.finfo(norm.dtype).eps
    use = norm > thresh
    unit = torch.where(use, x / norm.to(x.dtype), torch.zeros_like(x))
    return unit, torch.where(use, norm, torch.zeros_like(norm))


def _gmres_cycle(A, M, b, x, unit_residual, residual_norm, restart):
    """One restart cycle of ``jax.scipy``'s batched GMRES: up to
    ``restart`` Arnoldi steps on ``M(A(·))`` (one host read each, for the
    breakdown test), then ``y`` from the normal equations of the
    Hessenberg least-squares problem."""
    global krylov_iterations
    dt = b.dtype
    eps = torch.finfo(residual_norm.dtype).eps
    V = b.new_zeros((restart + 1,) + tuple(b.shape))
    V[0] = unit_residual
    Vf = V.view(restart + 1, -1)
    # H starts as an identity block: rows not reached after a breakdown
    # stay identity rows.
    H = torch.eye(restart, restart + 1, dtype=dt, device=b.device)
    for k in range(restart):
        v = M(A(V[k]))
        _, v_norm_0 = _safe_normalize(v)
        h = row_allreduce(Vf.conj() @ v.reshape(-1))  # one all-reduce: k + 1 dots
        v = v - (h @ Vf).view(v.shape)
        unit_v, v_norm_1 = _safe_normalize(v, thresh=eps * v_norm_0)
        V[k + 1] = unit_v
        h[k + 1] = v_norm_1.to(dt)
        H[k] = h
        krylov_iterations += 1
        if bool(v_norm_1 == 0):  # host sync: breakdown
            break
    beta = b.new_zeros((restart + 1,))
    beta[0] = residual_norm.to(dt)
    a = H.T
    chol, _ = torch.linalg.cholesky_ex(a.mH @ a)
    y = torch.cholesky_solve((a.mH @ beta)[:, None], chol)[:, 0]
    x = x + (y @ Vf[:-1]).view(b.shape)
    return (x,) + _safe_normalize(M(b - A(x)))


def _numel(b: torch.Tensor) -> int:
    """Entries of ``b`` over the ranks of the active mesh (one all-reduce
    and a host read under one)."""
    if active_mesh() is None:
        return b.numel()
    n = torch.tensor(float(b.numel()), dtype=torch.float64, device=b.device)
    return int(row_allreduce(n))


def _gmres(A, b, *, maxiter, tol, atol, restart, M):
    """Left-preconditioned restarted GMRES as ``jax.scipy.sparse.linalg.gmres``
    with ``solve_method="batched"``: the whole block ``b`` is one vector;
    ``maxiter`` counts restart cycles; the stopping rule is
    ``‖M(b − Ax)‖ ≤ max(tol·‖b‖, atol)``."""
    restart = min(restart, _numel(b))
    bound = torch.clamp(tol * _norm(b), min=atol)
    x = torch.zeros_like(b)
    unit_residual, residual_norm = _safe_normalize(M(b - A(x)))
    k = 0
    while k < maxiter and _continue(residual_norm > bound):
        x, unit_residual, residual_norm = _gmres_cycle(
            A, M, b, x, unit_residual, residual_norm, restart)
        k += 1
    return x


@dataclasses.dataclass(frozen=True)
class KrylovSolver:
    op: object
    prec: object  # Jacobi: the diagonal's reciprocal, padded with ones to
    #               the operator's storage length N; block-Jacobi inverses
    #               (nb, bs, bs); or a PairBlockPrec (stacked-real complex
    #               blocks) for a DiaPairOp
    cfg: Krylov

    def _apply_prec(self, x: torch.Tensor) -> torch.Tensor:
        if isinstance(self.prec, PairBlockPrec):
            return self.prec.apply(x)
        if x.dim() == 1 and self.prec.dim() == 1:
            return self.prec[:x.shape[0]] * x
        return cg_fused.precond_apply(self.prec, x, axis=0)

    def _apply_prec_t(self, xt: torch.Tensor) -> torch.Tensor:
        """Preconditioner in lane-major ``(q, N)`` layout."""
        if isinstance(self.prec, PairBlockPrec):
            return self.prec.apply_t(xt)
        return cg_fused.precond_apply(self.prec, xt, axis=1)

    def _fused(self, B: torch.Tensor) -> bool:
        """Whether the solve of ``B`` takes `_cg_fused`: real f32 or f64 CG
        on the card under Jacobi or block-Jacobi, no mesh active.  Inside
        that route a preconditioner the kernels cannot take raises
        (`cg_fused.workspace`)."""
        return (self.cfg.method == "cg" and B.is_cuda
                and B.dtype in (torch.float32, torch.float64)
                and isinstance(self.prec, torch.Tensor) and active_mesh() is None)

    def solve(self, B: torch.Tensor) -> torch.Tensor:
        global krylov_solves
        krylov_solves += 1
        cfg = self.cfg
        # Normalize the RHS (scale invariance of the stopping rule).
        nrm = row_norm(B)
        scale = torch.where(nrm > 0, nrm, torch.ones_like(nrm)).to(B.dtype)
        B = B / scale
        # Lane-major: the whole iteration runs in (q, N) layout; the
        # transposes happen once per solve, not once per product.
        lane_major = hasattr(self.op, "mmT") and B.dim() == 2
        if lane_major:
            n_rows = B.shape[0]
            B = F.pad(B.T, (0, self.op.N - n_rows)).contiguous()
            base_mv, base_prec = self.op.mmT, self._apply_prec_t
        else:
            base_mv, base_prec = self.op.mm, self._apply_prec
        if self._fused(B):
            s = -1.0 if cfg.negate else 1.0
            x = _cg_fused(base_mv, s * B, s=s, prec=self.prec, axis=1 if lane_major else 0,
                          maxiter=cfg.maxiter, tol=cfg.tol, atol=cfg.atol)
            return (x[:, :n_rows].T if lane_major else x) * scale
        if cfg.negate:
            def mv(x):
                return -base_mv(x)

            def precond(x):
                return -base_prec(x)

            B = -B
        else:
            mv, precond = base_mv, base_prec
        kw = dict(maxiter=cfg.maxiter, tol=cfg.tol, atol=cfg.atol, M=precond)
        if cfg.method == "cg":
            x = _cg(mv, B, **kw)
        elif cfg.method == "bicgstab":
            x = _bicgstab(mv, B, **kw)
        elif cfg.method == "gmres":
            x = _gmres(mv, B, restart=cfg.restart, **kw)
        else:
            raise _unknown_method(cfg.method)
        if lane_major:
            x = x[:, :n_rows].T
        return x * scale


@dataclasses.dataclass(frozen=True)
class PairSMWSolver:
    """SMW correction for a *complex-shifted* closed-loop coefficient in
    stacked-real form: solves ``(M + α⁻¹UV)X = B`` where ``M`` is the
    complex shifted operator represented by a stacked-real ``base`` solver
    and ``U``/``V``/``α`` are real.  ``A⁻¹U = P + iQ``; the Schur complement
    ``S = αI + V(P + iQ)`` is factored as the real block
    ``[[Sr, −Si], [Si, Sr]]``.  Operands are ``(n, 2q)`` column-stacked."""

    base: object  # stacked-real pair solver for M
    AinvU_re: torch.Tensor  # (n, m)
    AinvU_im: torch.Tensor  # (n, m)
    V: torch.Tensor  # (m, n)
    schur: object  # prepared solver for the real 2m×2m block form of S

    def solve(self, B: torch.Tensor) -> torch.Tensor:
        q = B.shape[1] // 2
        AinvB = self.base.solve(B)
        Rr, Ri = AinvB[:, :q], AinvB[:, q:]
        t = self.schur.solve(row_allreduce(torch.cat([self.V @ Rr, self.V @ Ri], dim=0)))
        m = self.V.shape[0]
        tr, ti = t[:m], t[m:]
        return torch.cat([
            Rr - (self.AinvU_re @ tr - self.AinvU_im @ ti),
            Ri - (self.AinvU_re @ ti + self.AinvU_im @ tr),
        ], dim=1)


@dataclasses.dataclass(frozen=True)
class RefinedKrylovSolver:
    """Mixed-precision iterative refinement around a low-dtype Krylov core:
    ``x₀ = solve_lo(B)``, then ``iters`` sweeps of ``x += solve_lo(B − A·x)``
    with the residual taken against the full-precision operator (its
    products in the full dtype: K1 or K2 in f64 for an f64 operator)."""

    op_hi: object  # full-precision operator
    inner: KrylovSolver  # prepared on the low-dtype operator
    iters: int

    def solve(self, B: torch.Tensor) -> torch.Tensor:
        lo = self.inner.op.dtype
        hi = torch.promote_types(self.op_hi.dtype, B.dtype)
        B = B.to(hi)
        x = self.inner.solve(B.to(lo)).to(hi)
        for _ in range(self.iters):
            r = B - self.op_hi.mm(x)
            x = x + self.inner.solve(r.to(lo)).to(hi)
        return x


def block_jacobi_inverses(blocks: torch.Tensor) -> torch.Tensor:
    """Explicit inverses of the ``(..., nb, bs, bs)`` diagonal blocks,
    applied later as one batched matmul per Krylov iteration.  Real blocks
    are symmetrized so CG sees a (numerically) SPD M⁻¹."""
    inv = torch.linalg.inv(blocks)
    if not inv.is_complex():
        inv = 0.5 * (inv + inv.transpose(-1, -2))
    return inv


def _unknown_method(method: str) -> Exception:
    return ValueError(f"unknown Krylov method {method!r}")


def _extract_diag(op) -> torch.Tensor:
    if isinstance(op, LowRankUpdateOp):
        base = _extract_diag(op.A)
        return base + (1.0 / op.alpha) * torch.einsum("ij,ji->i", op.U, op.V)
    if isinstance(op, DenseOp):
        return torch.diagonal(op.M)
    return op.diag()  # sparse operators implement .diag()


def solve_dtype(name, op_dtype: torch.dtype) -> torch.dtype:
    """The torch dtype of a ``Krylov.solve_dtype`` (a numpy dtype name or
    object), made complex for complex operators, as the JAX package does."""
    lo = np.dtype(name)
    if op_dtype.is_complex:
        lo = np.result_type(lo, np.complex64)
    return torch.from_numpy(np.zeros((), lo)).dtype


def prepare(A, alg) -> object:
    """A prepared (factored) solver for operator ``A`` under ``alg``."""
    A = as_operator(A)
    if isinstance(alg, Backslash):
        if isinstance(A, LowRankUpdateOp):
            # A direct solve of a lazy update would materialize it; SMW.
            return prepare(A, ShermanMorrisonWoodbury())
        lu, piv = torch.linalg.lu_factor(A.to_dense())
        return DenseLUSolver(lu=lu, piv=piv)
    if isinstance(alg, ShermanMorrisonWoodbury):
        if not isinstance(A, LowRankUpdateOp):
            raise TypeError("SMW requires a LowRankUpdateOp coefficient")
        base = prepare(A.A, alg.outer)
        AinvU = base.solve(A.U)
        m = A.U.shape[1]
        S = (A.alpha * torch.eye(m, dtype=AinvU.dtype, device=AinvU.device)
             + row_allreduce(A.V @ AinvU))
        return SMWSolver(base=base, AinvU=AinvU, V=A.V,
                         schur=prepare(DenseOp(S), alg.inner))
    if isinstance(alg, Krylov):
        if alg.solve_dtype is not None:
            lo = solve_dtype(alg.solve_dtype, A.dtype)
            if lo != A.dtype:
                from .operators import op_astype

                inner = prepare(op_astype(A, lo),
                                dataclasses.replace(alg, solve_dtype=None))
                return RefinedKrylovSolver(op_hi=A, inner=inner,
                                           iters=alg.refine_iters)
        if alg.method not in ("cg", "bicgstab", "gmres"):
            raise _unknown_method(alg.method)
        if alg.preconditioner == "block_jacobi" and hasattr(A, "diag_blocks"):
            prec = block_jacobi_inverses(A.diag_blocks())
        else:
            prec = 1.0 / _extract_diag(A)
            pad = getattr(A, "N", prec.shape[0]) - prec.shape[0]
            if pad > 0:  # padding rows of lane-major operands act as I
                prec = torch.cat([prec, prec.new_ones(pad)])
        return KrylovSolver(op=A, prec=prec, cfg=alg)
    raise TypeError(f"unknown block linear algorithm {alg!r}")


def solve_blocklinear(A, B: torch.Tensor, alg=Backslash()) -> torch.Tensor:
    """One-shot ``solve(BlockLinearProblem(A, B), alg)``."""
    return prepare(A, alg).solve(B)

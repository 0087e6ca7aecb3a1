"""Block linear solvers: ``A X = B`` with multiple right-hand sides.

Port of the slice of the JAX package's ``ops/blocklinear.py`` that the
compiled Ros1 step uses: preconditioned CG and BiCGStab over banded
operators, dense LU for the small Schur complements, and the
Sherman–Morrison–Woodbury wrappers (real and stacked-real pair forms).

The Krylov iterations reproduce ``jax.scipy.sparse.linalg`` exactly (so
iteration counts and results agree with the reference):

* inner products run over the whole ``(q, N)`` block as one vector;
* the loop runs while ``‖r‖² > max(tol²‖b‖², atol²)`` and ``k < maxiter``;
* BiCGStab keeps its ``exit_early`` select and stops on breakdown
  (``ρ = 0``, ``α = 0`` or ``ω = 0``);
* the start ``x₀ = 0`` still costs one product ``A(x₀)``.

Each iteration's convergence test reads one boolean back to the host
(one sync per iteration); `krylov_iterations` counts them.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

#: Krylov iterations run in this process — one host sync each.
krylov_iterations = 0


@dataclasses.dataclass(frozen=True)
class Krylov:
    """Matrix-free iterative solve, block-Jacobi preconditioned.

    method: "bicgstab" (general) or "cg" (symmetric definite).
    negate: solve ``(−A)X = −B`` — lets CG run on symmetric *negative*
    definite shifted coefficients ``Aᵀ + μEᵀ`` (A stable, μ < 0).
    """

    method: str = "bicgstab"
    tol: float = 1e-12
    atol: float = 0.0
    maxiter: int = 1000
    negate: bool = False


@dataclasses.dataclass(frozen=True)
class DenseLUSolver:
    lu: torch.Tensor
    piv: torch.Tensor

    def solve(self, B: torch.Tensor) -> torch.Tensor:
        return torch.linalg.lu_solve(self.lu, self.piv, B.to(self.lu.dtype))


@dataclasses.dataclass(frozen=True)
class SMWSolver:
    """Cached SMW pieces: base solver, ``A⁻¹U``, factored Schur complement."""

    base: object  # prepared solver for A
    AinvU: torch.Tensor  # (n, m)
    V: torch.Tensor  # (m, n)
    schur: object  # prepared solver for S = αI + V A⁻¹U

    def solve(self, B: torch.Tensor) -> torch.Tensor:
        AinvB = self.base.solve(B)
        t = self.schur.solve(self.V @ AinvB)
        return AinvB - self.AinvU @ t


def _block_apply(inv: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply ``(nb, bs, bs)`` block inverses to column-major ``(n, q)``."""
    nb, bs, _ = inv.shape
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    n, q = x.shape
    xp = F.pad(x, (0, 0, 0, nb * bs - n)).reshape(nb, bs, q)
    y = torch.bmm(inv, xp).reshape(nb * bs, q)[:n]
    return y[:, 0] if squeeze else y


def _block_apply_t(inv: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """Apply ``(nb, bs, bs)`` block inverses in lane-major ``(q, N)``."""
    q, N = xt.shape
    nb, bs, _ = inv.shape
    xb = F.pad(xt, (0, nb * bs - N)).reshape(q, nb, bs)
    y = torch.einsum("nab,qnb->qna", inv, xb)
    return y.reshape(q, nb * bs)[:, :N]


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


def _vdot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Inner product of two blocks taken as one vector each."""
    return torch.vdot(x.reshape(-1), y.reshape(-1))


def _continue(flag: torch.Tensor) -> bool:
    global krylov_iterations
    if not bool(flag):  # host sync
        return False
    krylov_iterations += 1
    return True


def _cg(A, b, *, maxiter, tol, atol, M):
    """Preconditioned CG as ``jax.scipy.sparse.linalg.cg``."""
    atol2 = torch.clamp(tol * tol * _vdot(b, b), min=atol * atol)
    x = torch.zeros_like(b)
    r = b - A(x)
    z = p = M(r)
    gamma = _vdot(r, z)
    k = 0
    while k < maxiter and _continue(_vdot(r, r) > atol2):
        Ap = A(p)
        alpha = gamma / _vdot(p, Ap)
        x = x + alpha * p
        r = r - alpha * Ap
        z = M(r)
        gamma_ = _vdot(r, z)
        p = z + (gamma_ / gamma) * p
        gamma = gamma_
        k += 1
    return x


def _bicgstab(A, b, *, maxiter, tol, atol, M):
    """Preconditioned BiCGStab as ``jax.scipy.sparse.linalg.bicgstab``."""
    atol2 = torch.clamp(tol * tol * _vdot(b, b), min=atol * atol)
    x = torch.zeros_like(b)
    r = b - A(x)
    rhat, p, q = r, r, r
    one = torch.ones((), dtype=b.dtype, device=b.device)
    alpha = omega = rho = one
    broken = torch.zeros((), dtype=torch.bool, device=b.device)
    k = 0
    while k < maxiter and _continue((_vdot(r, r) > atol2) & ~broken):
        rho_ = _vdot(rhat, r)
        beta = rho_ / rho * alpha / omega
        p = r + beta * (p - omega * q)
        phat = M(p)
        q = A(phat)
        alpha = rho_ / _vdot(rhat, q)
        s = r - alpha * q
        exit_early = _vdot(s, s) < atol2
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


@dataclasses.dataclass(frozen=True)
class KrylovSolver:
    op: object
    prec: object  # block-Jacobi inverses (nb, bs, bs), or a PairBlockPrec
    #               (stacked-real complex blocks) for a DiaPairOp
    cfg: Krylov

    def _apply_prec(self, x: torch.Tensor) -> torch.Tensor:
        return _block_apply(self.prec, x)

    def _apply_prec_t(self, xt: torch.Tensor) -> torch.Tensor:
        """Preconditioner in lane-major ``(q, N)`` layout."""
        if isinstance(self.prec, PairBlockPrec):
            return self.prec.apply_t(xt)
        return _block_apply_t(self.prec, xt)

    def solve(self, B: torch.Tensor) -> torch.Tensor:
        cfg = self.cfg
        # Normalize the RHS (scale invariance of the stopping rule).
        nrm = torch.linalg.norm(B)
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
        if cfg.negate:
            def mv(x):
                return -base_mv(x)

            def precond(x):
                return -base_prec(x)

            B = -B
        else:
            mv, precond = base_mv, base_prec
        if cfg.method == "cg":
            iterate = _cg
        elif cfg.method == "bicgstab":
            iterate = _bicgstab
        else:
            raise ValueError(f"Krylov method {cfg.method!r} is not ported")
        x = iterate(mv, B, maxiter=cfg.maxiter, tol=cfg.tol, atol=cfg.atol,
                    M=precond)
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
        t = self.schur.solve(torch.cat([self.V @ Rr, self.V @ Ri], dim=0))
        m = self.V.shape[0]
        tr, ti = t[:m], t[m:]
        return torch.cat([
            Rr - (self.AinvU_re @ tr - self.AinvU_im @ ti),
            Ri - (self.AinvU_re @ ti + self.AinvU_im @ tr),
        ], dim=1)


def block_jacobi_inverses(blocks: torch.Tensor) -> torch.Tensor:
    """Explicit inverses of the ``(..., nb, bs, bs)`` diagonal blocks,
    applied later as one batched matmul per Krylov iteration.  Real blocks
    are symmetrized so CG sees a (numerically) SPD M⁻¹."""
    inv = torch.linalg.inv(blocks)
    if not inv.is_complex():
        inv = 0.5 * (inv + inv.transpose(-1, -2))
    return inv

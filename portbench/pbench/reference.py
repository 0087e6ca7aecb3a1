"""The plain reference: LRSIF Rosenbrock sweeps and the GARE residual for a
symmetric banded pencil, in plain PyTorch with SciPy on the host.

It imports nothing of the program and takes nothing the program made: it
builds its own operators from the same SciPy matrices, its own shifts
(Wachspress's optimal real ADI parameters for spectral bounds it finds
itself) and its own solver (a block-tridiagonal Cholesky factorization of
each shifted matrix, whose blocks are as wide as the band).  The
equations are those of the reference package (DifferentialRiccatiEquations.jl):

* GALE ``FᵀXE + EᵀXF + G S Gᵀ = 0``, solved by low-rank ADI with real
  shifts, the closed-loop term ``F = F₀ − c·B K`` by Sherman–Morrison–Woodbury;
* Ros1 (implicit Euler) step of the GDRE ``EᵀẊE = CᵀC + AᵀXE + EᵀXA −
  EᵀXBBᵀXE``, integrated backward with ``τ = −dt``:
  ``F = A − E/(2τ) − BK``, ``G S Gᵀ = CᵀC + KᵀK + EᵀXE/τ``, ``K = BᵀXE``;
* Ros2 step (``γ = 1 + 1/√2``): ``F = γτA − E/2 − γτBK``, stage 1 with the
  Riccati operator at ``X`` as right-hand side, stage 2 with
  ``τ²EᵀK₁BBᵀK₁E + (2 − 1/γ)EᵀK₁E``, ``X ← X + (2 − 1/(2γ))τK₁ − (τ/2)K₂``;
* the GARE residual ``Q + AᵀXE + EᵀXA − EᵀXGXE`` of a low-rank ``X``.

Everything runs in the dtype it is given (float64, or float32 for the
control), on the device it is given, with TF32 off.
"""

from __future__ import annotations

import math

import numpy as np
import scipy.sparse as sp
import scipy.special
import torch

GAMMA = 1.0 + 1.0 / math.sqrt(2.0)


def _no_tf32():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


# --- operators ------------------------------------------------------------------


def bandwidth(M) -> int:
    coo = sp.coo_matrix(M)
    return int(np.abs(coo.col.astype(np.int64) - coo.row).max(initial=0))


class Banded:
    """A symmetric banded matrix as dense ``h × h`` blocks: diagonal blocks
    ``D (nb, h, h)`` and sub-diagonal blocks ``S (nb−1, h, h)``
    (``S[j]`` = rows of block ``j+1``, columns of block ``j``), with
    ``h`` at least the bandwidth, so the matrix is block tridiagonal.
    Rows beyond ``n`` are padding (zero here)."""

    def __init__(self, M, h: int, dtype, device):
        M = sp.csr_matrix(M)
        if abs(M - M.T).max() != 0:
            raise ValueError("the reference takes symmetric matrices only")
        n = M.shape[0]
        if bandwidth(M) > h:
            raise ValueError(f"bandwidth {bandwidth(M)} exceeds the block size {h}")
        nb = -(-n // h)
        coo = M.tocoo()
        r, c, v = coo.row.astype(np.int64), coo.col.astype(np.int64), coo.data
        bi, bj = r // h, c // h
        D = np.zeros((nb, h, h))
        S = np.zeros((max(nb - 1, 0), h, h))
        on = bi == bj
        np.add.at(D, (bi[on], r[on] % h, c[on] % h), v[on])
        lo = bi == bj + 1
        np.add.at(S, (bj[lo], r[lo] % h, c[lo] % h), v[lo])
        self.n, self.h, self.nb = n, h, nb
        self.D = torch.as_tensor(D, dtype=dtype, device=device)
        self.S = torch.as_tensor(S, dtype=dtype, device=device)
        self.csr = torch.sparse_csr_tensor(
            torch.as_tensor(M.indptr, dtype=torch.int64),
            torch.as_tensor(M.indices, dtype=torch.int64),
            torch.as_tensor(M.data), size=M.shape, dtype=dtype, device=device)

    def mm(self, X: torch.Tensor) -> torch.Tensor:
        return self.csr @ X


def _pad_blocks(X: torch.Tensor, nb: int, h: int) -> torch.Tensor:
    n, q = X.shape
    out = X.new_zeros((nb * h, q))
    out[:n] = X
    return out.view(nb, h, q)


class ShiftedCholesky:
    """Block-tridiagonal Cholesky factorization ``M_p = L Lᵀ`` of
    ``M_p = −(αA + (β + p)E)`` for each real shift ``p < 0`` (symmetric
    positive definite for a symmetric negative definite ``αA + βE`` and SPD
    ``E``), one slot per shift; padding rows get the identity.  ``L`` has
    diagonal blocks ``Lⱼ`` and sub-diagonal blocks ``Wⱼ``; the solve keeps
    ``Lⱼ⁻¹``, ``Gⱼ = Lⱼ⁻¹Wⱼ₋₁`` and ``Hⱼ = Lⱼ⁻ᵀWⱼᵀ``, so each block of the
    forward and the backward substitution is one product."""

    def __init__(self, A: Banded, E: Banded, alpha: float, beta: float, shifts):
        self.n, self.h, self.nb = A.n, A.h, A.nb
        dt, dev = A.D.dtype, A.D.device
        self.shifts = [float(p) for p in shifts]
        ns, nb, h = len(self.shifts), self.nb, self.h
        c = torch.tensor([beta + p for p in self.shifts], dtype=dt, device=dev)
        pad = torch.zeros(h, dtype=dt, device=dev)
        pad[self.n - (nb - 1) * h:] = 1.0
        eye = torch.eye(h, dtype=dt, device=dev).expand(ns, h, h)
        self.Linv = torch.empty((ns, nb, h, h), dtype=dt, device=dev)
        self.G = torch.empty((ns, max(nb - 1, 0), h, h), dtype=dt, device=dev)
        self.H = torch.empty((ns, max(nb - 1, 0), h, h), dtype=dt, device=dev)
        W = None
        for j in range(nb):
            Dj = -(alpha * A.D[j] + c[:, None, None] * E.D[j])
            if j == nb - 1:
                Dj = Dj + torch.diag(pad)
            if j > 0:
                Dj = Dj - W @ W.transpose(-1, -2)
            Linv = torch.linalg.solve_triangular(torch.linalg.cholesky(Dj), eye, upper=False)
            self.Linv[:, j] = Linv
            if j > 0:
                self.G[:, j - 1] = Linv @ W
            if j < nb - 1:
                Sj = -(alpha * A.S[j] + c[:, None, None] * E.S[j])
                W = Sj @ Linv.transpose(-1, -2)   # Wⱼ Lⱼᵀ = Sⱼ
                self.H[:, j] = Linv.transpose(-1, -2) @ W.transpose(-1, -2)

    def solve(self, s: int, B: torch.Tensor) -> torch.Tensor:
        """``M_p⁻¹ B`` for the shift in slot ``s``."""
        n, q = B.shape
        nb, Linv, G, H = self.nb, self.Linv[s], self.G[s], self.H[s]
        y = Linv @ _pad_blocks(B, nb, self.h)
        for j in range(1, nb):
            torch.addmm(y[j], G[j - 1], y[j - 1], alpha=-1.0, out=y[j])
        x = Linv.transpose(-1, -2) @ y
        for j in range(nb - 2, -1, -1):
            torch.addmm(x[j], H[j], x[j + 1], alpha=-1.0, out=x[j])
        return x.reshape(nb * self.h, q)[:n]


# --- shifts -----------------------------------------------------------------------


def spectral_bounds(A: Banded, E: Banded, alpha: float, beta: float,
                    iters: int = 30, seed: int = 0):
    """Bounds ``[a, b]`` on the spectrum of the symmetric definite pencil
    ``(−(αA + βE), E)``: power iteration for the largest eigenvalue, inverse
    iteration for the smallest, Rayleigh quotients widened by 10 %."""
    dt, dev = A.D.dtype, A.D.device
    g = torch.Generator(device="cpu").manual_seed(seed)
    x0 = torch.rand((A.n, 1), generator=g, dtype=torch.float64).to(dt).to(dev) + 0.5

    def Mmm(X):
        return -(alpha * A.mm(X) + beta * E.mm(X))

    Ec = ShiftedCholesky(A, E, 0.0, -1.0, [0.0])     # −(0·A − E) = E
    Mc = ShiftedCholesky(A, E, alpha, beta, [0.0])   # −(αA + βE)

    def rq(x):
        return float((x.T @ Mmm(x)) / (x.T @ E.mm(x)))

    x = x0
    for _ in range(iters):
        x = Ec.solve(0, Mmm(x))
        x = x / torch.linalg.norm(x)
    hi = rq(x)
    x = x0
    for _ in range(iters):
        x = Mc.solve(0, E.mm(x))
        x = x / torch.linalg.norm(x)
    lo = rq(x)
    return 0.9 * lo, 1.1 * hi


def wachspress_shifts(a: float, b: float, count: int) -> list:
    """Wachspress's optimal real ADI parameters for a spectrum in ``[a, b]``
    (``0 < a < b``), negated: ``p_j = −b·dn((2j−1)K/(2J), k)`` with
    ``k = √(1 − (a/b)²)``."""
    m = 1.0 - (a / b) ** 2
    K = scipy.special.ellipk(m)
    u = (2 * np.arange(1, count + 1) - 1) * K / (2 * count)
    dn = scipy.special.ellipj(u, m)[2]
    return list(-b * dn)


# --- low-rank algebra -------------------------------------------------------------


def compress(L: torch.Tensor, D: torch.Tensor, rtol: float):
    """``L D Lᵀ`` as ``L' diag(λ) L'ᵀ`` with orthonormal ``L'``, keeping the
    eigenvalues above ``rtol · max|λ|``."""
    if L.shape[1] == 0:
        return L, D
    Q, R = torch.linalg.qr(L)
    S = R @ D @ R.T
    lam, V = torch.linalg.eigh(0.5 * (S + S.T))
    keep = lam.abs() > rtol * lam.abs().max()
    return Q @ V[:, keep], torch.diag(lam[keep])


def lr_fro(L: torch.Tensor, D: torch.Tensor) -> float:
    """``‖L D Lᵀ‖_F`` through a QR of ``L``."""
    if L.shape[1] == 0:
        return 0.0
    _, R = torch.linalg.qr(L)
    return float(torch.linalg.norm(R @ D @ R.T))


def lr_diff(L1, D1, L2, D2) -> float:
    """``‖L1 D1 L1ᵀ − L2 D2 L2ᵀ‖_F``."""
    L = torch.cat([L1, L2], dim=1)
    D = torch.block_diag(D1, -D2)
    return lr_fro(L, D)


def _gram_fro(W: torch.Tensor, T: torch.Tensor) -> float:
    """``‖W T Wᵀ‖_F`` from the Gram matrix (the ADI's running residual)."""
    M = T @ (W.T @ W)
    return math.sqrt(max(float(torch.trace(M @ M)), 0.0))


class Pencil:
    """The reference's view of a symmetric banded pencil ``(E, A)`` with the
    input and output maps ``B (n, m)`` and ``C (q, n)``."""

    def __init__(self, E, A, B, C, dtype=torch.float64, device="cpu"):
        _no_tf32()
        h = max(bandwidth(E), bandwidth(A), 1)
        self.E = Banded(E, h, dtype, device)
        self.A = Banded(A, h, dtype, device)
        self.B = torch.as_tensor(np.asarray(B), dtype=dtype, device=device)
        self.C = torch.as_tensor(np.asarray(C), dtype=dtype, device=device)
        self.n = self.E.n
        self.dtype, self.device = dtype, device
        self.eps = float(torch.finfo(dtype).eps)


class ADISolver:
    """Low-rank ADI for ``(F₀ − c·BK)ᵀXE + EᵀX(F₀ − c·BK) + G S Gᵀ = 0`` with
    ``F₀ = αA + βE``, over Wachspress shifts for the spectrum of
    ``(−F₀, E)``.  The factors are built once for a sweep."""

    def __init__(self, P: Pencil, alpha: float, beta: float, c: float,
                 nshifts: int = 24, rtol: float | None = None, maxiter: int = 400):
        self.P, self.alpha, self.beta, self.c = P, alpha, beta, c
        a, b = spectral_bounds(P.A, P.E, alpha, beta)
        self.shifts = wachspress_shifts(a, b, nshifts)
        self.chol = ShiftedCholesky(P.A, P.E, alpha, beta, self.shifts)
        self.rtol = rtol if rtol is not None else 1e3 * P.eps
        self.maxiter = maxiter
        self.iterations = []  # ADI iterations of each solve
        self.residuals = []   # relative exit residual of each solve

    def solve(self, G: torch.Tensor, S: torch.Tensor, K: torch.Tensor):
        """Returns ``(L, D)`` of the solution; ``K (m, n)``."""
        P = self.P
        B, Kt = P.B, K.T
        m = B.shape[1]
        W, T = compress(G, S, P.eps)
        res0 = _gram_fro(W, T)
        Ls, Ds = [], []
        Lx = W.new_zeros((P.n, 0))
        Dx = W.new_zeros((0, 0))
        eye = torch.eye(m, dtype=W.dtype, device=W.device)
        rel, it = 0.0 if res0 == 0 else 1.0, 0
        while rel > self.rtol and it < self.maxiter:
            s = it % len(self.shifts)
            p = self.shifts[s]
            q = W.shape[1]
            # (F₀ + pE − c·KᵀBᵀ)V = W  ⇔  (M_p + c·KᵀBᵀ)V = −W
            Z = self.chol.solve(s, torch.cat([-W, Kt], dim=1))
            Zw, Zk = Z[:, :q], Z[:, q:]
            cap = eye + self.c * (B.T @ Zk)
            V = Zw - Zk @ torch.linalg.solve(cap, self.c * (B.T @ Zw))
            W = W - 2.0 * p * P.E.mm(V)
            Ls.append(V)
            Ds.append(-2.0 * p * T)
            it += 1
            rel = _gram_fro(W, T) / res0
            if sum(x.shape[1] for x in Ls) > 4 * max(q, 64):
                Lx, Dx = compress(torch.cat([Lx] + Ls, dim=1),
                                  torch.block_diag(Dx, *Ds), P.eps)
                Ls, Ds = [], []
        if Ls:
            Lx, Dx = compress(torch.cat([Lx] + Ls, dim=1), torch.block_diag(Dx, *Ds), P.eps)
        self.iterations.append(it)
        self.residuals.append(rel)
        return Lx, Dx


def feedback(P: Pencil, L, D) -> torch.Tensor:
    """``K = BᵀXE`` (``(m, n)``) of ``X = L D Lᵀ``."""
    return ((P.B.T @ L) @ D) @ P.E.mm(L).T


def ros1_sweep(P: Pencil, L0, D0, tau: float, nsteps: int, **adi_kw):
    """``nsteps`` Ros1 steps from ``X0 = L0 D0 L0ᵀ``.  Returns the feedback
    at every stop, the final ``(L, D)`` and the ADI solver (its counts)."""
    adi = ADISolver(P, 1.0, -1.0 / (2.0 * tau), 1.0, **adi_kw)
    L, D = compress(L0, D0, P.eps)
    Ks = [feedback(P, L, D)]
    q = P.C.shape[0]
    for _ in range(nsteps):
        K = Ks[-1]
        BtLD = (P.B.T @ L) @ D
        G = torch.cat([P.C.T, P.E.mm(L)], dim=1)
        S = torch.block_diag(torch.eye(q, dtype=L.dtype, device=L.device),
                             BtLD.T @ BtLD + D / tau)
        L, D = adi.solve(G, S, K)
        Ks.append(feedback(P, L, D))
    return Ks, (L, D), adi


def ros2_sweep(P: Pencil, L0, D0, tau: float, nsteps: int, **adi_kw):
    """``nsteps`` Ros2 steps from ``X0``; returns as `ros1_sweep`."""
    g = GAMMA
    adi = ADISolver(P, g * tau, -0.5, g * tau, **adi_kw)
    L, D = compress(L0, D0, P.eps)
    Ks = [feedback(P, L, D)]
    q = P.C.shape[0]
    for _ in range(nsteps):
        K = Ks[-1]
        r = L.shape[1]
        BtLD = (P.B.T @ L) @ D
        G1 = torch.cat([P.C.T, P.A.mm(L), P.E.mm(L)], dim=1)
        S1 = L.new_zeros((q + 2 * r, q + 2 * r))
        S1[:q, :q] = torch.eye(q, dtype=L.dtype, device=L.device)
        S1[q:q + r, q + r:] = D
        S1[q + r:, q:q + r] = D
        S1[q + r:, q + r:] = -(BtLD.T @ BtLD)
        L1, D1 = adi.solve(G1, S1, K)
        BtL1D1 = (P.B.T @ L1) @ D1
        S2 = tau ** 2 * (BtL1D1.T @ BtL1D1) + (2.0 - 1.0 / g) * D1
        L2, D2 = adi.solve(P.E.mm(L1), S2, K)
        L, D = compress(torch.cat([L, L1, L2], dim=1),
                        torch.block_diag(D, (2.0 - 1.0 / (2.0 * g)) * tau * D1,
                                         (-tau / 2.0) * D2), P.eps)
        Ks.append(feedback(P, L, D))
    return Ks, (L, D), adi


def gare_residual(P: Pencil, gain: float, L, D) -> float:
    """``‖Q + AᵀXE + EᵀXA − EᵀXGXE‖_F / ‖Q‖_F`` for ``G = gain²·BBᵀ`` and
    ``Q = CᵀC``, ``X = L D Lᵀ``."""
    q, r = P.C.shape[0], L.shape[1]
    GtLD = gain * ((P.B.T @ L) @ D)
    R = torch.cat([P.C.T, P.A.mm(L), P.E.mm(L)], dim=1)
    T = R.new_zeros((q + 2 * r, q + 2 * r))
    T[:q, :q] = torch.eye(q, dtype=L.dtype, device=L.device)
    T[q:q + r, q + r:] = D
    T[q + r:, q:q + r] = D
    T[q + r:, q + r:] = -(GtLD.T @ GtLD)
    Qn = lr_fro(P.C.T, torch.eye(q, dtype=L.dtype, device=L.device))
    return lr_fro(R, T) / Qn

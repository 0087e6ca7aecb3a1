"""Penzl's heuristic ADI shifts, computed on the host with numpy and scipy
(port of the host part of the JAX package's ``models/shifts.py``:
``heuristic_shifts_host``, ``heuristic`` and the Ritz-value helpers)."""

from __future__ import annotations

import warnings

import numpy as np


def safe_sort(shifts: np.ndarray) -> np.ndarray:
    """Sort keeping complex-conjugate pairs adjacent."""
    return np.array(sorted(shifts, key=lambda v: (v.real, abs(v.imag))))


def is_stable(v) -> np.ndarray:
    return np.real(v) < 0


def flip(v: np.ndarray) -> np.ndarray:
    return -np.real(v) + 1j * np.imag(v)


def stabilize_ritz_values(lam: np.ndarray, desc: str) -> np.ndarray:
    """Discard unstable Ritz values; flip all if none is stable."""
    if len(lam) == 0:
        raise ValueError(f"no Ritz values of {desc}")
    unstable = ~is_stable(lam)
    n_unstable = int(np.sum(unstable))
    if 0 < n_unstable < len(lam):
        warnings.warn(f"Discarding unstable Ritz values of {desc}")
        lam = lam[is_stable(lam)]
    elif n_unstable == len(lam):
        warnings.warn(
            f"All Ritz values of {desc} are unstable; flipping along imaginary axis")
        lam = flip(lam)
    return lam


def heuristic(R: np.ndarray, nshifts: int) -> list:
    """Penzl's greedy min-max selection over the Ritz value set."""
    R = np.asarray(R)

    def s(t, P):
        return np.prod([abs(t - p) / abs(t + p) for p in P])

    # p minimizing the max of s(t, {p}) over t in R:
    best, best_val = None, np.inf
    for p in R:
        val = max(s(t, (p,)) for t in R)
        if val < best_val:
            best, best_val = p, val
    P = [best] if np.isreal(best) else [best, np.conj(best)]
    while len(P) < nshifts:
        # t maximizing s(t, P):
        best, best_val = None, -np.inf
        for t in R:
            val = s(t, P)
            if val > best_val:
                best, best_val = t, val
        if np.isreal(best):
            P.append(best)
        else:
            P.extend((best, np.conj(best)))
    return [complex(v) for v in P]


def heuristic_shifts_host(E_sparse, A_sparse, nshifts: int, kp: int, km: int,
                          B=None, K=None, lu_cache: dict | None = None,
                          warm_start: bool = False) -> list:
    """Penzl heuristic shifts (Penzl 1999, Alg. 5.1) from ``kp`` Arnoldi
    steps on ``E⁻¹A`` and ``km`` on ``A⁻¹E``, with SciPy sparse LU.

    With ``B``/``K`` given, the Ritz values are those of the closed-loop
    pencil ``(E, A − BK)``; ``F⁻¹E`` products use the SMW identity around
    the LU of ``A``.  ``lu_cache``: optional dict reused across calls with
    the same pencil (skips the two factorizations).  ``warm_start``: start
    each Arnoldi from the previous call's dominant Ritz vector stored in
    ``lu_cache`` instead of the all-ones vector.  Returns complex values."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spla

    # f64 on the host whatever the device dtype: shift quality gates ADI
    # convergence, and this runs once per sweep.
    E = sp.csc_matrix(E_sparse).astype(np.float64)
    A = sp.csc_matrix(A_sparse).astype(np.float64)
    n = E.shape[0]
    if K is not None:
        B = np.asarray(B, np.float64)
        K = np.asarray(K, np.float64)

    def arnoldi(matvec, k, desc, cache_key):
        H = np.zeros((k + 1, k))
        b0 = None
        if warm_start and lu_cache is not None:
            b0 = lu_cache.get(cache_key)
        if b0 is None:
            b0 = np.ones(n)
        V = [b0 / np.linalg.norm(b0)]
        for j in range(k):
            w = matvec(V[j])
            for _ in range(2):  # repeated modified Gram-Schmidt
                for i in range(j + 1):
                    g = V[i] @ w
                    H[i, j] += g
                    w = w - g * V[i]
            beta = np.linalg.norm(w)
            H[j + 1, j] = beta
            if beta == 0:
                k = j + 1
                H = H[:k + 1, :k]
                break
            V.append(w / beta)
        ritz, vecs = np.linalg.eig(H[:k, :k])
        if lu_cache is not None:
            # The dominant Ritz vector lifted to R^n: the next call's warm start.
            dom = int(np.argmax(np.abs(ritz)))
            y = np.real(np.column_stack(V[:k]) @ vecs[:, dom])
            ny = np.linalg.norm(y)
            if np.isfinite(ny) and ny > 0:
                lu_cache[cache_key] = y / ny
        return stabilize_ritz_values(ritz, desc)

    if lu_cache is not None and "luE" in lu_cache:
        luE, luA = lu_cache["luE"], lu_cache["luA"]
    else:
        luE = spla.splu(E)
        luA = spla.splu(A)
        if lu_cache is not None:
            lu_cache["luE"], lu_cache["luA"] = luE, luA
    if K is None:
        def fwd(x):
            return luE.solve(A @ x)

        def bwd(x):
            return luA.solve(E @ x)

        descs = ("E⁻¹A", "A⁻¹E")
    else:
        # F = A − BK; F⁻¹ = A⁻¹ + A⁻¹B (I − K A⁻¹B)⁻¹ K A⁻¹  (SMW)
        AinvB = luA.solve(B)
        Sinv = np.linalg.inv(np.eye(B.shape[1]) - K @ AinvB)

        def fwd(x):
            return luE.solve(A @ x - B @ (K @ x))

        def bwd(x):
            y = luA.solve(E @ x)
            return y + AinvB @ (Sinv @ (K @ y))

        descs = ("E⁻¹F", "F⁻¹E")
    Rp = arnoldi(fwd, kp, descs[0], "warm_fwd")
    Rm = arnoldi(bwd, km, descs[1], "warm_bwd")
    R = np.concatenate([Rp, 1.0 / Rm])
    return heuristic(R, nshifts)

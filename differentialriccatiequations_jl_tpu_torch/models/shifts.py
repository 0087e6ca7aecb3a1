"""ADI shift strategies (port of the JAX package's ``models/shifts.py``).

* `Projection(u)` — self-generating Galerkin shifts from the last ``u``
  increment factors (the default of `ADI`);
* `Heuristic(nshifts, kp, km)` — Penzl's heuristic shifts from Arnoldi
  Ritz values of ``E⁻¹A`` and ``A⁻¹E``, on the operators' device;
* `Cyclic(inner_or_values)`, `Wrapped(func, inner)` — combinators;
* `heuristic_shifts_host` — the same Penzl shifts on the host with SciPy's
  sparse LU (the compiled paths' set-up);
* `heuristic_shifts_card` — the closed-loop ones on the card, through
  block-tridiagonal Cholesky factors of a symmetric-definite DIA pencil (the
  compiled Newton's rebuilds).

Subspace assembly, orthonormalization (`orth`, an SVD) and the Galerkin
projection run on the operators' device; the small nonsymmetric
generalized eigenproblem runs on the host (SciPy).  Strategy configs are
frozen and hashable; run-time state lives in small host-side oracle
objects driven by the protocol ``init / update / take`` (`init_shifts`,
`ShiftOracle`).
"""

from __future__ import annotations

import dataclasses
import warnings

import numpy as np
import scipy.linalg
import torch

from ..config import default_dtype
from ..ops.blocklinear import prepare
from ..ops.operators import as_operator, restrict
from ..ops.shifted import default_inner_alg
from ..utils.timers import timeit

#: Host reads of the device Arnoldi (`_arnoldi_card`: the host API's
#: `Heuristic` and the compiled Newton's card-route rebuilds): one per
#: step's norm and one per Hessenberg matrix.
arnoldi_syncs = 0
#: Operator applications of the device Arnoldi — each one inner solve.
arnoldi_matvecs = 0


# --- strategy configs -----------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class Projection:
    n_history: int = 2

    def __post_init__(self):
        if self.n_history % 2 != 0:
            # ADI double steps contribute factor pairs.
            raise ValueError(f"History must be even; got {self.n_history}")


@dataclasses.dataclass(frozen=True)
class Heuristic:
    nshifts: int
    kp: int  # Arnoldi steps with E⁻¹A
    km: int  # Arnoldi steps with A⁻¹E
    alg_E: object = None  # default: routed by operator kind (dense LU / Krylov)
    alg_A: object = None


@dataclasses.dataclass(frozen=True)
class Cyclic:
    """Cycle through precomputed values or one batch of the inner strategy."""

    inner: object  # strategy or sequence of shift values


@dataclasses.dataclass(frozen=True)
class Wrapped:
    """Apply ``func`` to every batch produced by the inner strategy."""

    func: object
    inner: object


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


def orth(N: torch.Tensor) -> torch.Tensor:
    """Orthonormal basis of the range of ``N`` by SVD (on ``N``'s device),
    cut on the host at ``n·eps·max(s₀, 1)``."""
    U, s, _ = torch.linalg.svd(N, full_matrices=False)
    s = s.cpu().numpy()
    smax = s[0] if len(s) else 0.0
    cut = N.shape[0] * np.finfo(s.dtype).eps * max(smax, 1.0)
    return U[:, :int(np.sum(s > cut))]


# --- oracle protocol --------------------------------------------------------------


class ShiftOracle:
    """Run-time shift generator: `update` is cheap, `take` may be expensive."""

    def update(self, X, W, *Vs) -> None:
        pass

    def take(self) -> complex:
        raise NotImplementedError

    def take_many(self) -> list:
        raise NotImplementedError


class BufferedOracle(ShiftOracle):
    """Buffer batches from `take_many`, pop one by one."""

    def __init__(self):
        self._buffer: list = []

    def take(self) -> complex:
        if not self._buffer:
            self._buffer = list(self.take_many())
        return complex(self._buffer.pop(0))


class CyclicOracle(ShiftOracle):
    def __init__(self, values):
        self._values = [complex(v) for v in values]
        self._i = 0

    def take(self) -> complex:
        v = self._values[self._i % len(self._values)]
        self._i += 1
        return v

    def take_many(self) -> list:
        return list(self._values)


class WrappedOracle(BufferedOracle):
    def __init__(self, func, inner: ShiftOracle):
        super().__init__()
        self.func = func
        self.inner = inner

    def update(self, X, W, *Vs) -> None:
        self.inner.update(X, W, *Vs)

    def take_many(self) -> list:
        return list(self.func(self.inner.take_many()))


class ProjectionOracle(BufferedOracle):
    """Galerkin-projection shifts: the stable Ritz values of the pencil
    projected onto the span of the last ``n_history`` increment factors."""

    def __init__(self, E, A, n_history: int):
        super().__init__()
        self.E = E
        self.A = A
        self.n_history = n_history
        self.Vs: list = []

    def update(self, X, W, *Vs) -> None:
        # The first update (no increments yet) seeds with the residual factor.
        if not Vs:
            self.Vs.append(W)
        self.Vs.extend(Vs)
        self.Vs = self.Vs[-self.n_history:]

    def take_many(self) -> list:
        Vs = [torch.as_tensor(V) for V in self.Vs]
        with timeit("shifts.orth"):
            Q = orth(torch.cat(Vs, dim=1))
        with timeit("shifts.project"):
            Et = restrict(self.E, Q).cpu().numpy()
            At = restrict(self.A, Q).cpu().numpy()
            lam = scipy.linalg.eig(At, Et, right=False)
        lam = stabilize_ritz_values(lam, "(A, E)")
        lam = safe_sort(lam)
        lam = lam[np.isfinite(lam)]  # prune infinite/NaN generalized eigenvalues
        if len(lam) == 0:
            raise RuntimeError("projection shifts: no finite stable Ritz values")
        return list(lam)


# --- Penzl heuristic ----------------------------------------------------------------


def _arnoldi_ritz(matvec, n: int, k: int, dtype, device, desc: str) -> np.ndarray:
    """k-step Arnoldi from the all-ones start vector (`_arnoldi_card`, no
    warm start), in ``dtype`` on ``device``; Ritz values of the Hessenberg
    matrix."""
    return _arnoldi_card(matvec, k, desc, torch.ones((n,), dtype=dtype, device=device))


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


def _arnoldi_card(matvec, k: int, desc: str, start: torch.Tensor, cache=None,
                  key=None) -> np.ndarray:
    """k-step Arnoldi with repeated MGS from ``start``, on its device and in
    its dtype (`heuristic_shifts_host`'s on the host): the Hessenberg matrix
    stays there and is read once, besides one read of each ``β`` for the
    breakdown test (`arnoldi_syncs`).  With ``cache``, the dominant Ritz
    vector lifted to Rⁿ is kept there under ``key`` (on the device) as the
    next call's start.  Ritz values of the Hessenberg matrix."""
    global arnoldi_syncs, arnoldi_matvecs
    n = start.shape[0]
    V = start.new_zeros((k + 1, n))
    H = start.new_zeros((k + 1, k))
    V[0] = start / torch.linalg.vector_norm(start)
    for j in range(k):
        w = matvec(V[j])
        arnoldi_matvecs += 1
        coeffs = []
        for _ in range(2):  # repeated modified Gram-Schmidt
            for i in range(j + 1):
                g = torch.dot(V[i], w)
                coeffs.append(g)
                w = w - g * V[i]
        H[:j + 1, j] = torch.stack(coeffs).view(2, j + 1).sum(0)
        beta = torch.linalg.vector_norm(w)
        H[j + 1, j] = beta
        arnoldi_syncs += 1
        if float(beta) == 0.0:
            k = j + 1
            break
        V[j + 1] = w / beta
    arnoldi_syncs += 1
    ritz, vecs = np.linalg.eig(H[:k, :k].cpu().numpy())
    if cache is not None:
        dom = int(np.argmax(np.abs(ritz)))
        y = V[:k].T @ torch.as_tensor(vecs[:, dom].real.copy(), dtype=V.dtype,
                                      device=V.device)
        ny = torch.linalg.vector_norm(y)
        # Kept only where finite and nonzero, without a read: else the
        # previous start (all ones where there was none) stays.
        keep = cache.get(key, torch.ones_like(y))
        cache[key] = torch.where(torch.isfinite(ny) & (ny > 0), y / ny, keep)
    return stabilize_ritz_values(ritz, desc)


def heuristic_shifts_card(E, A, nshifts: int, kp: int, km: int, B, K,
                          cache: dict | None = None, warm_start: bool = False) -> list:
    """`heuristic_shifts_host` with ``B`` and ``K`` on the operators'
    device: the same closed-loop Penzl shifts from ``kp`` Arnoldi steps on
    ``E⁻¹F`` and ``km`` on ``F⁻¹E``, ``F = A − BK`` by the same SMW
    identity, for symmetric-definite `DiaOp`s ``E`` and ``−A``.  The inverses
    are direct solves through block-tridiagonal Cholesky factors
    (`ops.dia_cholesky`), built for this call and released after their
    Arnoldi: ``E``'s before ``A``'s is built.  Float64 whatever the
    operators' dtype.  ``B (n, m)`` and ``K (m, n)``: tensors on the
    operators' device.  ``cache``: a dict kept across calls on one pencil
    for the warm starts (device vectors); ``warm_start`` as in
    `heuristic_shifts_host`.  Raises `ops.dia_cholesky.NotDefinite` where
    ``E`` or ``−A`` is not definite.  Returns complex values."""
    from ..ops.dia_cholesky import dia_cholesky

    f64 = torch.float64
    E = dataclasses.replace(E, data=E.data.to(f64), data_t=E.data_t.to(f64))
    A = dataclasses.replace(A, data=A.data.to(f64), data_t=A.data_t.to(f64))
    B, K = B.to(f64), K.to(f64)
    ones = torch.ones((E.n,), dtype=f64, device=E.device)

    def start(key):
        b0 = cache.get(key) if warm_start and cache is not None else None
        return ones if b0 is None else b0

    fact = dia_cholesky(E)
    Rp = _arnoldi_card(lambda x: fact.solve(A.mm(x) - B @ (K @ x)), kp, "E⁻¹F",
                       start("warm_fwd"), cache, "warm_fwd")
    fact = None  # E's factor goes before A's is built
    fact = dia_cholesky(A, negate=True)
    # F⁻¹ = A⁻¹ + A⁻¹B (I − K A⁻¹B)⁻¹ K A⁻¹  (SMW)
    AinvB = fact.solve(B)
    Sinv = torch.linalg.inv(torch.eye(B.shape[1], dtype=f64, device=B.device) - K @ AinvB)

    def bwd(x):
        y = fact.solve(E.mm(x))
        return y + AinvB @ (Sinv @ (K @ y))

    Rm = _arnoldi_card(bwd, km, "F⁻¹E", start("warm_bwd"), cache, "warm_bwd")
    R = np.concatenate([Rp, 1.0 / Rm])
    return heuristic(R, nshifts)


def _heuristic_shifts(strategy: Heuristic, E, A) -> list:
    """Penzl's shifts from `_arnoldi_ritz` on ``E⁻¹A`` and ``A⁻¹E``, the
    inverses applied by `prepare`d solvers on the operators' device.  The
    Arnoldi runs in the default dtype (`config.default_dtype`), its
    products and solves in the operators'."""
    E = as_operator(E)
    A = as_operator(A)
    n = E.shape[0]
    dtype = default_dtype()
    alg_E = strategy.alg_E if strategy.alg_E is not None else default_inner_alg(E)
    alg_A = strategy.alg_A if strategy.alg_A is not None else default_inner_alg(A)
    with timeit("shifts.arnoldi"):
        solver_E = prepare(E, alg_E)
        Rp = _arnoldi_ritz(lambda x: solver_E.solve(A.mm(x.to(A.dtype))).to(dtype), n,
                           strategy.kp, dtype, E.device, "E⁻¹A")
        solver_A = prepare(A, alg_A)
        Rm = _arnoldi_ritz(lambda x: solver_A.solve(E.mm(x.to(E.dtype))).to(dtype), n,
                           strategy.km, dtype, E.device, "A⁻¹E")
    R = np.concatenate([Rp, 1.0 / Rm])
    return heuristic(R, strategy.nshifts)


class HeuristicOracle(BufferedOracle):
    def __init__(self, shifts):
        super().__init__()
        self._shifts = list(shifts)

    def take_many(self) -> list:
        return list(self._shifts)


# --- init dispatch --------------------------------------------------------------------


def init_shifts(strategy, prob) -> ShiftOracle:
    """``Shifts.init(strategy, prob) -> oracle``."""
    if isinstance(strategy, Projection):
        return ProjectionOracle(prob.E, prob.A, strategy.n_history)
    if isinstance(strategy, Heuristic):
        return HeuristicOracle(_heuristic_shifts(strategy, prob.E, prob.A))
    if isinstance(strategy, Cyclic):
        inner = strategy.inner
        if isinstance(inner, (Projection, Heuristic, Cyclic, Wrapped)):
            return CyclicOracle(init_shifts(inner, prob).take_many())
        return CyclicOracle(inner)  # precomputed values
    if isinstance(strategy, Wrapped):
        return WrappedOracle(strategy.func, init_shifts(strategy.inner, prob))
    if isinstance(strategy, ShiftOracle):
        return strategy  # pre-initialized
    raise TypeError(f"unknown shift strategy {strategy!r}")

"""Benchmark/test problem generators (numpy/scipy; `rail_surrogate_dense`
returns tensors).

The JAX package's ``utils/testmat.py`` generators: `rail_surrogate`, a 2D
heat-equation surrogate of the Oberwolfach SteelProfile ("Rail") pencils
with the same sparsity class and definiteness, at the reference's sizes
n ∈ {371, 1357, 5177, 79841}; its convection–diffusion variant
`conv_diff_surrogate` (nonsymmetric ``A``); and the reference's
``tiny_random.jl`` pencils `random_pencil` and `random_rhs_lowrank`.
Seeded numpy, so both packages build bit-identical matrices.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp
import torch

from ..config import default_dtype


def _rng(seed):
    return np.random.default_rng(seed)


def _grid_shape(n: int):
    nx = int(np.sqrt(n))
    ny = -(-n // nx)
    return nx, ny


def rail_surrogate(n: int, *, m: int = 7, q: int = 6, seed=0):
    """2D heat-equation surrogate of SteelProfile(n) as scipy.sparse CSR.

    Returns (E, A, B, C): E SPD banded mass matrix, A SND 5-point stencil
    stiffness with Robin-like boundary absorption, B (n, m), C (q, n).
    """
    rng = _rng(seed)
    nx, ny = _grid_shape(n)

    # 5-point Laplacian on the nx × ny grid, truncated to exactly n nodes.
    ex = np.ones(nx)
    ey = np.ones(ny)
    Tx = sp.diags([ex[:-1], -2 * ex, ex[:-1]], [-1, 0, 1])
    Ty = sp.diags([ey[:-1], -2 * ey, ey[:-1]], [-1, 0, 1])
    lap = sp.kronsum(Tx, Ty, format="csr")
    lap = lap[:n, :n]

    # Unscaled stencil: Rail's FEM stiffness entries are O(1).
    A = (lap - 0.05 * sp.eye(n)).tocsr()  # absorption keeps A ≺ 0

    # Mass-like E: strictly diagonally dominant, same pattern family.
    diag_w = 4.0 + rng.random(n)
    off = sp.diags([np.ones(n - 1), np.ones(n - 1)], [-1, 1])
    E = (sp.diags(diag_w) + 0.5 * off).tocsr()
    E = (0.5 * (E + E.T)).tocsr()

    # Smooth low-rank input/output maps touching boundary strips.
    B = np.zeros((n, m))
    for j in range(m):
        center = (j + 1) * n // (m + 1)
        width = max(2, n // (3 * m))
        idx = np.arange(max(0, center - width), min(n, center + width))
        B[idx, j] = np.exp(-0.5 * ((idx - center) / max(1.0, width / 2)) ** 2)
    C = np.zeros((q, n))
    for i in range(q):
        center = (2 * i + 1) * n // (2 * q)
        width = max(2, n // (3 * q))
        idx = np.arange(max(0, center - width), min(n, center + width))
        C[i, idx] = 1.0 / len(idx)
    return E, A, B, C


# --- the reference's tiny_random pencils (test/tiny_random.jl) ---------------


def random_pencil(n: int = 50, *, symmetric_E=True, symmetric_A=True, seed=0):
    """Random sparse-ish pencil: E ≻ 0 (or spectrum in the right half
    plane), A stable.  Dense float64 numpy."""
    rng = _rng(seed)

    def sprand(density):
        M = np.zeros((n, n))
        nnz = int(density * n * n)
        idx = rng.integers(0, n, size=(2, nnz))
        M[idx[0], idx[1]] = rng.random(nnz)
        return M

    E = sprand(1.0 / n)
    E = E + E.T + n * np.eye(n) if symmetric_E else E + n * np.eye(n)
    A = sprand(1.0 / n)
    A = A + A.T - n * np.eye(n) if symmetric_A else A - n * np.eye(n)
    return E, A


def random_rhs_lowrank(n: int, g: int = 4, seed=1):
    """Right-hand side ``C = 2·G Gᵀ ≥ 0`` as ``(G, S = 2·I)``."""
    G = _rng(seed).random((n, g))
    return G, 2.0 * np.eye(g)


def conv_diff_surrogate(n: int, *, m: int = 7, q: int = 6, peclet: float = 2.0,
                        wind=(1.0, 0.4), seed=0):
    """2D convection–diffusion surrogate with a **nonsymmetric** stable ``A``.

    ``A = Δ/h² − w·∇_upwind/h − 0.05·I`` with the wind scaled so the mesh
    Péclet number is ``peclet`` (> 1: a complex spectrum, so Penzl and
    projection shifts come in conjugate pairs).  ``E``, ``B`` and ``C`` are
    `rail_surrogate`'s.  Returns scipy CSR (E, A) and dense (B, C).
    """
    rng = _rng(seed)
    nx, ny = _grid_shape(n)
    h = 1.0 / (nx + 1)

    ex = np.ones(nx)
    ey = np.ones(ny)
    Tx = sp.diags([ex[:-1], -2 * ex, ex[:-1]], [-1, 0, 1])
    Ty = sp.diags([ey[:-1], -2 * ey, ey[:-1]], [-1, 0, 1])
    lap = sp.kronsum(Tx, Ty, format="csr") / (h * h)

    # Upwind first-order differences; x varies fastest in kronsum(Tx, Ty).
    Dx = (sp.eye(nx) - sp.eye(nx, k=-1)) / h
    Dy = (sp.eye(ny) - sp.eye(ny, k=-1)) / h
    conv = sp.kron(sp.eye(ny), Dx) * wind[0] + sp.kron(Dy, sp.eye(nx)) * wind[1]
    wscale = 2.0 * peclet / h / max(abs(wind[0]), abs(wind[1]))
    A = ((lap - wscale * conv.tocsr())[:n, :n] - 0.05 * sp.eye(n)).tocsr()

    diag_w = 4.0 + rng.random(n)
    off = sp.diags([np.ones(n - 1), np.ones(n - 1)], [-1, 1])
    E = (sp.diags(diag_w) + 0.5 * off).tocsr()
    E = (0.5 * (E + E.T)).tocsr()

    _, _, B, C = rail_surrogate(n, m=m, q=q, seed=seed)
    return E, A, B, C


def rail_surrogate_dense(n: int, *, device, **kw):
    """`rail_surrogate` as dense tensors ``(E, A, B, C)`` of the default
    dtype (`config.default_dtype`, f64 unless set) on ``device`` (``"cpu"``
    or ``"cuda"``), for the dense solvers."""
    E, A, B, C = rail_surrogate(n, **kw)
    dt = default_dtype()
    return tuple(torch.as_tensor(np.asarray(M), dtype=dt, device=device)
                 for M in (E.toarray(), A.toarray(), B, C))

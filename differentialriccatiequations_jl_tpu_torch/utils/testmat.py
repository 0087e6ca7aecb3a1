"""Benchmark/test problem generators (numpy/scipy only).

Same generator as the JAX package's ``utils/testmat.py::rail_surrogate``:
a 2D heat-equation surrogate of the Oberwolfach SteelProfile ("Rail")
pencils with the same sparsity class and definiteness, at the reference's
sizes n ∈ {371, 1357, 5177, 79841}.  Seeded numpy, so both packages build
bit-identical matrices.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


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

"""Frozen copy of the port's ``utils/testmat.py::rail_surrogate`` (numpy and
SciPy only), so the benchmark's pencils do not move when the program's
generator changes.

A 2-D heat-equation surrogate of the Oberwolfach SteelProfile ("Rail")
pencils: ``E`` symmetric positive definite (tridiagonal, diagonally
dominant), ``A`` symmetric negative definite (5-point stencil on an
``nx × ny`` grid truncated to ``n`` nodes, minus 0.05·I), ``B (n, m)`` and
``C (q, n)`` smooth bumps.  Only ``E``'s diagonal depends on the seed.
"""

from __future__ import annotations

import numpy as np
import scipy.sparse as sp


def grid_shape(n: int):
    nx = int(np.sqrt(n))
    ny = -(-n // nx)
    return nx, ny


def rail_surrogate(n: int, *, m: int = 7, q: int = 6, seed=0):
    """Returns scipy CSR ``E``, ``A`` and dense ``B (n, m)``, ``C (q, n)``."""
    rng = np.random.default_rng(seed)
    nx, ny = grid_shape(n)

    ex = np.ones(nx)
    ey = np.ones(ny)
    Tx = sp.diags([ex[:-1], -2 * ex, ex[:-1]], [-1, 0, 1])
    Ty = sp.diags([ey[:-1], -2 * ey, ey[:-1]], [-1, 0, 1])
    lap = sp.kronsum(Tx, Ty, format="csr")
    lap = lap[:n, :n]
    A = (lap - 0.05 * sp.eye(n)).tocsr()

    diag_w = 4.0 + rng.random(n)
    off = sp.diags([np.ones(n - 1), np.ones(n - 1)], [-1, 1])
    E = (sp.diags(diag_w) + 0.5 * off).tocsr()
    E = (0.5 * (E + E.T)).tocsr()

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

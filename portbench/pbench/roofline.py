"""Frozen roofline arithmetic: the card's peaks, the bytes and operations a
call of kernel K1 (the DIA SpMM) or K2 (the block-ELL SpMM) needs, and the
least time the card could take for them.

Copied from the smoke test's ``bound_ms`` and its byte counts (inputs read
once, the result written once), with one change: f64 K1 runs on the CUDA
cores, so its operations are held against 34 TFLOP/s, not the 67 of the
tensor cores (K1 is bound by its bytes either way).  Peaks are the NVIDIA
H100 SXM data sheet's, dense, at the full 700 W power limit; a reading
records the card's power limit beside it.
"""

from __future__ import annotations

#: HBM3 bandwidth, bytes/s.
PEAK_BYTES_S = 3.35e12
#: Operations/s by kernel and element size in bytes: K1 on the CUDA cores
#: (f64 34 TFLOP/s, f32 67 TFLOP/s), K2 on the f64 tensor cores (DMMA,
#: 67 TFLOP/s) and in f32 on the CUDA cores (67 TFLOP/s).
PEAK_FLOP_S = {("k1", 8): 34e12, ("k1", 4): 67e12, ("k2", 8): 67e12, ("k2", 4): 67e12}


def k1_counts(ndiag: int, N: int, q: int, esize: int, epilogue: bool):
    """Bytes and operations of one K1 call ``Y = A·X`` (or ``α·A·X + β·Z``):
    the diagonals ``(ndiag, N)`` and the operand ``(N, q)`` read once, ``Z``
    read once with the epilogue, the result written once."""
    nbytes = esize * (ndiag * N + (3 if epilogue else 2) * N * q)
    flops = 2 * ndiag * N * q + (3 * N * q if epilogue else 0)
    return nbytes, flops


def k2_counts(nb: int, K: int, bs: int, n: int, q: int, esize: int):
    """Bytes and operations of one K2 call: the ``nb·K`` blocks of
    ``bs × bs`` and their int32 block-column indices read once, the operand
    ``(n, q)`` read once and the result written once."""
    nbytes = esize * nb * K * bs * bs + 4 * nb * K + 2 * esize * n * q
    flops = 2 * nb * K * bs * bs * q
    return nbytes, flops


def bound_s(kernel: str, esize: int, nbytes: float, flops: float):
    """The least time the card could take: the larger of the bytes over the
    memory rate and the operations over the peak.  Returns (s, bound_by)."""
    t_bytes = nbytes / PEAK_BYTES_S
    t_ops = flops / PEAK_FLOP_S[(kernel, esize)]
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")

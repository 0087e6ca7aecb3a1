"""Hand-written CUDA kernels, their build step and their plain PyTorch versions."""

from __future__ import annotations

import torch


def empty_in_layout(X: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor of ``X``'s shape, dtype and device whose
    unit-stride axis is ``X``'s: a kernel that reads ``X`` along its
    unit-stride axis then writes the result the same way.  ``X`` is 2-D;
    an ``(n, q)`` view of ``(q, n)`` storage gets one too."""
    rows, cols = X.shape
    if X.stride(0) == 1 and X.stride(1) != 1 and cols > 1:
        return torch.empty((cols, rows), dtype=X.dtype, device=X.device).T
    return torch.empty((rows, cols), dtype=X.dtype, device=X.device)

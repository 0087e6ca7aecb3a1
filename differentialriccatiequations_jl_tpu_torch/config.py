"""Global configuration of the PyTorch/CUDA port.

The reference library computes in Float64 and its test tolerances (1e-10
relative residuals) require double precision, so f64 is the default dtype
here too.  Unlike the JAX package there is no process-wide x64 switch:
tensors carry their dtype, and the device follows the input tensors.  The
port runs on the card; the CPU is used only where a caller asks for it.

Reduced-precision products are switched off at import.  On the TPU the
matrix unit's default bf16 passes made CG on the finite-difference pencils
diverge (the JAX package forces "highest" matmul precision for that
reason); the CUDA analog is TF32, which keeps about three decimal digits.
"""

from __future__ import annotations

import numpy as np
import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

#: Default element type for problem data and solver internals.
DEFAULT_DTYPE = torch.float64

#: Relative truncation factor used by low-rank column compression: the
#: reference's ``100 * maximum(abs, λ) * eps()`` cut.
COMPRESSION_RTOL_FACTOR = 100.0


def default_dtype() -> torch.dtype:
    return DEFAULT_DTYPE


def set_default_dtype(dtype) -> None:
    """Set the default element type: a `torch.dtype`, or any name or type
    numpy reads as one (``"float32"``, ``np.float32``)."""
    global DEFAULT_DTYPE
    if not isinstance(dtype, torch.dtype):
        dtype = torch.from_numpy(np.zeros((), np.dtype(dtype))).dtype
    DEFAULT_DTYPE = dtype


def eps(dtype: torch.dtype | None = None) -> float:
    """Machine epsilon of `dtype` (default: the default dtype)."""
    return float(torch.finfo(dtype or DEFAULT_DTYPE).eps)


def device() -> torch.device:
    """The CUDA device, for callers that build their own inputs (the
    solvers follow their input tensors).  Raises where there is none: the
    port never falls back to the CPU unasked."""
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device; pass device='cpu' explicitly to "
                           "run on the CPU")
    return torch.device("cuda")


def resolve_device(dev=None) -> torch.device:
    """``dev`` as a `torch.device`; ``None`` means `device()`, the card
    (raising where there is none).  The constructors that build tensors
    from host arrays take their default device from here."""
    return device() if dev is None else torch.device(dev)


def as_tensor(x, device=None) -> torch.Tensor:
    """``x`` as a tensor: a tensor as it is, on its own device; any other
    array (numpy, nested lists) on ``device`` (`resolve_device`: the card
    by default)."""
    if isinstance(x, torch.Tensor):
        return x
    return torch.as_tensor(x, device=resolve_device(device))

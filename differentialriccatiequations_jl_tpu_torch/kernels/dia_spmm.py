"""Kernel K1: the DIA SpMM, its plain PyTorch version and its wrapper.

``Y[i] = Σ_d data[d, i] · X[i + offsets[d]]`` (zero outside ``[0, N)``) on a
banded operator stored one vector per diagonal (see `ops.dia.DiaOp`).  The
CUDA source is ``csrc/dia_spmm.cu``; it replaces the JAX package's Pallas
kernel ``ops/dia.py::_dia_mm_pallas_t``.

The wrappers `dia_mm` (column-major ``(N, q)``) and `dia_mm_t` (lane-major
``(q, N)``, with the optional ``α·Y + β·Z`` epilogue) take the plain version
for tensors on the CPU and launch the kernel for tensors on a CUDA device;
any other device raises.  The result has the operand's layout
(`kernels.empty_in_layout`).  `launches` counts kernel launches,
`launches_by_dtype` the same launches by dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build, empty_in_layout

#: Number of K1 launches in this process (the plain version never counts).
launches = 0
#: The same launches by operand dtype (``torch.float64``, ``torch.float32``).
launches_by_dtype = {torch.float64: 0, torch.float32: 0}

MAX_DIAGS = 64  # DIA_MAX_DIAGS in csrc/dia_spmm.cu

_NAME = "dia_spmm"
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # data, offsets, ndiag
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,  # x, strides
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,  # y, strides
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,  # z, strides
    ctypes.c_double, ctypes.c_double,  # alpha, beta
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # N, q, stream
]
_fns: dict[torch.dtype, object] = {}


def _kernel(dtype: torch.dtype):
    if not _fns:
        lib = build.load(_NAME)
        for dt, sym in ((torch.float64, "dia_spmm_f64"),
                        (torch.float32, "dia_spmm_f32")):
            fn = getattr(lib, sym)
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            _fns[dt] = fn
    return _fns[dtype]


# --- plain versions (the CPU path and the kernel's oracle) -------------------


def dia_mm_plain(data: torch.Tensor, offsets: tuple, X: torch.Tensor) -> torch.Tensor:
    """``(N, q)`` layout: one pad + ndiag shifted multiply-adds
    (the JAX package's ``_dia_mm_xla``)."""
    N, q = X.shape
    H = max((abs(o) for o in offsets), default=0)
    out_dt = torch.promote_types(data.dtype, X.dtype)
    Xp = F.pad(X.to(out_dt), (0, 0, H, H))
    Y = torch.zeros((N, q), dtype=out_dt, device=X.device)
    for d, off in enumerate(offsets):
        Y = Y + data[d][:, None].to(out_dt) * Xp[H + off:H + off + N]
    return Y


def dia_mm_t_plain(data: torch.Tensor, offsets: tuple, Xt: torch.Tensor) -> torch.Tensor:
    """Lane-major ``(q, N)`` layout (the JAX package's ``_dia_mm_t_xla``)."""
    q, N = Xt.shape
    H = max((abs(o) for o in offsets), default=0)
    out_dt = torch.promote_types(data.dtype, Xt.dtype)
    Xp = F.pad(Xt.to(out_dt), (H, H))
    Y = torch.zeros((q, N), dtype=out_dt, device=Xt.device)
    for d, off in enumerate(offsets):
        Y = Y + data[d][None, :].to(out_dt) * Xp[:, H + off:H + off + N]
    return Y


# --- wrappers -------------------------------------------------------------------


def dia_mm(data: torch.Tensor, offsets: tuple, X: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` for ``X: (N, q)``."""
    if X.device.type == "cpu":
        return dia_mm_plain(data, offsets, X)
    return _launch(data, offsets, X, axis=0)


def dia_mm_t(data: torch.Tensor, offsets: tuple, Xt: torch.Tensor,
             Z: torch.Tensor | None = None, alpha: float = 1.0,
             beta: float = 0.0) -> torch.Tensor:
    """``(A @ Xtᵀ)ᵀ`` for ``Xt: (q, N)``; with ``Z``, ``α·(A @ Xtᵀ)ᵀ + β·Z``."""
    if Xt.device.type == "cpu":
        Y = dia_mm_t_plain(data, offsets, Xt)
        return Y if Z is None else alpha * Y + beta * Z
    return _launch(data, offsets, Xt, axis=1, Z=Z, alpha=alpha, beta=beta)


def _output(data, offsets, X, axis, Z=None):
    """Check the operands for K1 and allocate its result in the operand's
    layout (`empty_in_layout`); ``axis`` is X's problem axis."""
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dia_spmm: kernel takes float32/float64, got {X.dtype}")
    if data.dtype != X.dtype or data.device != X.device:
        raise TypeError(f"dia_spmm: data is {data.dtype} on {data.device}, "
                        f"operand is {X.dtype} on {X.device}")
    if data.dim() != 2 or X.dim() != 2 or not data.is_contiguous():
        raise ValueError("dia_spmm: data must be a contiguous (ndiag, N) "
                         "tensor and the operand 2-D")
    ndiag, N = data.shape
    if len(offsets) != ndiag or not 1 <= ndiag <= MAX_DIAGS:
        raise ValueError(f"dia_spmm: {len(offsets)} offsets for {ndiag} "
                         f"diagonals (1..{MAX_DIAGS} supported)")
    if X.shape[axis] != N:
        raise ValueError(f"dia_spmm: operand {tuple(X.shape)} does not have "
                         f"N={N} along axis {axis}")
    if Z is not None and (Z.shape != X.shape or Z.dtype != X.dtype
                          or Z.device != X.device):
        raise ValueError("dia_spmm: Z must match the operand's shape, dtype "
                         "and device")
    return empty_in_layout(X)


def _launch(data, offsets, X, axis, Z=None, alpha=1.0, beta=0.0):
    """Check the operands and launch K1; ``axis`` is X's problem axis."""
    global launches
    if X.device.type != "cuda":
        raise ValueError(f"dia_spmm: no kernel for device {X.device}")
    Y = _output(data, offsets, X, axis, Z)
    ndiag, N = data.shape
    q = X.shape[1 - axis]
    if q == 0:
        return Y
    offs = (ctypes.c_int * ndiag)(*offsets)
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(X.dtype)(
            data.data_ptr(), offs, ndiag,
            X.data_ptr(), X.stride(axis), X.stride(1 - axis),
            Y.data_ptr(), Y.stride(axis), Y.stride(1 - axis),
            None if Z is None else Z.data_ptr(),
            0 if Z is None else Z.stride(axis),
            0 if Z is None else Z.stride(1 - axis),
            float(alpha), float(beta), N, q, stream)
    if err != 0:
        raise RuntimeError(f"dia_spmm: kernel launch failed with CUDA error {err}")
    launches += 1
    launches_by_dtype[X.dtype] += 1
    return Y

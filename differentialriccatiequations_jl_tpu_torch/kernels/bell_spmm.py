"""Kernel K2: the block-ELL SpMM, its plain PyTorch version and its wrapper.

``Y[i·bs:(i+1)·bs] = Σ_k data[i, k] @ X[cols[i, k]·bs : +bs]`` on a matrix
stored as ``(nb, K)`` block-column indices and ``(nb, K, bs, bs)`` dense
blocks (see `ops.sparse.BellOp`).  The CUDA source is
``csrc/bell_spmm.cu``; it replaces the JAX package's Pallas kernel
``ops/sparse.py::_bell_mm_pallas``.

The wrapper `bell_mm` takes the plain version for tensors on the CPU and
launches the kernel for tensors on a CUDA device; any other device raises.
`launches` counts kernel launches, `launches_by_dtype` the same launches by
dtype.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from . import build, empty_in_layout

#: Number of K2 launches in this process (the plain version never counts).
launches = 0
#: The same launches by operand dtype (``torch.float64``, ``torch.float32``).
launches_by_dtype = {torch.float64: 0, torch.float32: 0}

_NAME = "bell_spmm"
_ARGTYPES = [
    ctypes.c_void_p, ctypes.c_void_p,  # cols, data
    ctypes.c_int, ctypes.c_int, ctypes.c_int,  # nb, K, bs
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,  # x, strides
    ctypes.c_void_p, ctypes.c_longlong, ctypes.c_longlong,  # y, strides
    ctypes.c_int, ctypes.c_int, ctypes.c_void_p,  # n, q, stream
]
_fns: dict[torch.dtype, object] = {}


def _kernel(dtype: torch.dtype):
    if not _fns:
        lib = build.load(_NAME)
        for dt, sym in ((torch.float64, "bell_spmm_f64"),
                        (torch.float32, "bell_spmm_f32")):
            fn = getattr(lib, sym)
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            _fns[dt] = fn
    return _fns[dtype]


def bell_mm_plain(cols: torch.Tensor, data: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Gather + batched matmul (the JAX package's ``_bell_mm_xla``) on an
    ``(n, q)`` operand with ``n ≤ nb·bs`` rows; returns ``(n, q)``."""
    n, q = X.shape
    nb, _, bs, _ = data.shape
    out_dt = torch.promote_types(data.dtype, X.dtype)
    Xb = F.pad(X.to(out_dt), (0, 0, 0, nb * bs - n)).reshape(nb, bs, q)
    gath = Xb[cols.long()]  # (nb, K, bs, q)
    Y = torch.einsum("ikab,ikbq->iaq", data.to(out_dt), gath)
    return Y.reshape(nb * bs, q)[:n]


def bell_mm(cols: torch.Tensor, data: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """``Y = A @ X`` for ``X: (n, q)``, ``nb = ⌈n / bs⌉``."""
    if X.device.type == "cpu":
        return bell_mm_plain(cols, data, X)
    return _launch(cols, data, X)


def _output(cols, data, X):
    """Check the operands for K2 and allocate its result in the operand's
    layout (`empty_in_layout`)."""
    if X.dtype not in (torch.float32, torch.float64):
        raise TypeError(f"bell_spmm: kernel takes float32/float64, got {X.dtype}")
    if data.dtype != X.dtype or data.device != X.device:
        raise TypeError(f"bell_spmm: data is {data.dtype} on {data.device}, "
                        f"operand is {X.dtype} on {X.device}")
    if data.dim() != 4 or not data.is_contiguous() or data.shape[2] != data.shape[3]:
        raise ValueError("bell_spmm: data must be a contiguous (nb, K, bs, bs) tensor")
    nb, K, bs, _ = data.shape
    if (cols.dtype != torch.int32 or cols.device != X.device
            or tuple(cols.shape) != (nb, K) or not cols.is_contiguous()):
        raise ValueError(f"bell_spmm: cols must be a contiguous ({nb}, {K}) "
                         f"int32 tensor on {X.device}")
    if X.dim() != 2:
        raise ValueError("bell_spmm: the operand must be 2-D")
    n = X.shape[0]
    if not (nb - 1) * bs < n <= nb * bs:
        raise ValueError(f"bell_spmm: operand has {n} rows, the operator "
                         f"{nb} blocks of {bs}")
    return empty_in_layout(X)


def _launch(cols, data, X):
    """Check the operands and launch K2 (one launch for any width)."""
    global launches
    if X.device.type != "cuda":
        raise ValueError(f"bell_spmm: no kernel for device {X.device}")
    Y = _output(cols, data, X)
    nb, K, bs, _ = data.shape
    n, q = X.shape
    if q == 0:
        return Y
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _kernel(X.dtype)(cols.data_ptr(), data.data_ptr(), nb, K, bs,
                               X.data_ptr(), X.stride(0), X.stride(1),
                               Y.data_ptr(), Y.stride(0), Y.stride(1),
                               n, q, stream)
    if err != 0:
        raise RuntimeError(f"bell_spmm: kernel launch failed with CUDA error {err}")
    launches += 1
    launches_by_dtype[X.dtype] += 1
    return Y


def plan(dtype: torch.dtype, q: int) -> dict:
    """The kernel variant a call with ``q`` columns takes (for reports):
    n8-tiles per 128-column chunk, stages of the shared-memory ring and its
    dynamic shared memory in bytes.  Builds the library."""
    lib = build.load(_NAME)
    fn = lib.bell_spmm_plan
    fn.argtypes = [ctypes.c_int, ctypes.c_int] + [ctypes.POINTER(ctypes.c_int)] * 3
    fn.restype = ctypes.c_int
    nt, stages, smem = ctypes.c_int(), ctypes.c_int(), ctypes.c_int()
    if fn(int(dtype == torch.float64), q, nt, stages, smem) != 0:
        raise ValueError(f"bell_spmm: no variant for q={q}")
    return {"nt": nt.value, "stages": stages.value, "smem_bytes": smem.value}

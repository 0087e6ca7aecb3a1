"""The fused CG iteration: four kernels, their plain versions and wrappers.

One iteration of preconditioned CG (`ops.blocklinear._cg_fused`), after
the product ``a = A·p`` (K1 or K2, unchanged), runs as four kernels in
place on a `Workspace` that the solve allocates once, with every scalar on
the device:

* `pap`: the partial sums of ``⟨p, a⟩``;
* `update`: ``γ = Σ⟨r, z⟩``, ``α = γ / (s·Σ⟨p, a⟩)`` from the partials,
  ``x += α·p``, ``r −= α·s·a``, the partial sums of ``⟨r, r⟩``, and ``γ``
  kept for `direction`;
* `precond`: ``z = s·M⁻¹r`` (the ``(nb, bs, bs)`` block-Jacobi inverses, or
  the Jacobi diagonal's reciprocal) and the partial sums of ``⟨r, z⟩``, on
  the lane-major ``(q, N)`` state and the column-major ``(n, q)`` one alike,
  in place;
* `direction`: ``β = Σ⟨r, z⟩ / γ``, ``p = z + β·p`` and the stopping flag
  ``Σ⟨r, r⟩ > atol²`` that the host reads.

`iteration` issues the four from one call.

``s = ±1`` carries `Krylov.negate`: CG on ``(sA)x = s·b`` with no negation
pass.  The CUDA source is ``csrc/cg_fused.cu``.  The wrappers take the plain
versions for tensors on the CPU and launch the kernels for tensors on a
CUDA device.  The plain versions keep one partial per sum, the whole
``torch.vdot``, and the operations of the loop they replace, so on the CPU
they reproduce it bit for bit; the kernels' sums end in another (fixed)
order.  `launches` counts kernel launches.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch
import torch.nn.functional as F

from . import build

#: Number of launches of the four kernels in this process.
launches = 0

THREADS = 256  # CG_THREADS in csrc/cg_fused.cu
MAX_PARTS = 1024  # CG_MAX_PARTS: blocks of an elementwise kernel
MAX_BS = 128  # CG_BS_MAX: the widest block-Jacobi block
_ELEMENTS_PER_THREAD = 8  # of an elementwise kernel's block, below MAX_PARTS blocks

_NAME = "cg_fused"
_P, _L, _I, _D = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int, ctypes.c_double
_ARGTYPES = {
    "pap": [_P, _P, _L, _P, _I, _P],
    "update": [_P, _P, _P, _P, _L, _P, _I, _P, _I, _D, _P, _P, _I, _P],
    "precond": [_P, _P, _P, _L, _L, _L, _I, _I, _I, _I, _L, _L, _D, _P, _I, _P],
    "direction": [_P, _P, _L, _P, _I, _P, _P, _I, _P, _I, _P],
    "iteration": [_P, _P, _P, _P, _P, _L, _P, _P, _I, _P, _I, _P, _P, _D,
                  _P, _L, _L, _L, _I, _I, _I, _I, _L, _L, _P],
}
_fns: dict[tuple, object] = {}


def _kernel(name: str, dtype: torch.dtype):
    if not _fns:
        lib = build.load(_NAME)
        for dt, suffix in ((torch.float64, "f64"), (torch.float32, "f32")):
            for kern, argtypes in _ARGTYPES.items():
                fn = getattr(lib, f"cg_{kern}_{suffix}")
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                _fns[(kern, dt)] = fn
    return _fns[(name, dtype)]


@dataclasses.dataclass(frozen=True)
class Workspace:
    """One solve's state and scalars, updated in place by the four kernels.

    ``x``, ``r``, ``z``, ``p``: contiguous, one shape; ``axis`` is their
    problem axis (1 for the lane-major ``(q, N)`` state, 0 for the
    column-major ``(n, q)`` one).  ``sc = [γ, atol²]``; ``flag``: one int,
    nonzero while ``⟨r, r⟩ > atol²``.  The partial-sum buffers hold one
    entry per block of the kernel that writes them (one on the CPU).
    ``launch``: on the card, the four launches with every argument bound
    but the product's address (`bind`); ``None`` on the CPU."""

    x: torch.Tensor
    r: torch.Tensor
    z: torch.Tensor
    p: torch.Tensor
    prec: torch.Tensor
    s: float
    axis: int
    sc: torch.Tensor
    flag: torch.Tensor
    part_pap: torch.Tensor
    part_rr: torch.Tensor
    part_rz: torch.Tensor
    launch: dict | None = None


def elementwise_parts(numel: int) -> int:
    """Blocks (and partial sums) of an elementwise kernel over ``numel``
    elements: a function of the size alone, so sums repeat bit for bit."""
    per_block = THREADS * _ELEMENTS_PER_THREAD
    return max(1, min(MAX_PARTS, -(-numel // per_block)))


def precond_parts(prec: torch.Tensor, rows: int, q: int) -> int:
    """Blocks (and partial sums) of the preconditioner kernel: one per
    (bs-row block, chunk of columns) for block-Jacobi."""
    if prec.dim() == 1:
        return elementwise_parts(rows * q)
    cq = next((c for c in (16, 32, 48) if q <= c), 64)
    return prec.shape[0] * -(-q // cq)


def workspace(x: torch.Tensor, r: torch.Tensor, prec: torch.Tensor, s: float, axis: int,
              atol2: torch.Tensor) -> Workspace:
    """The workspace of a solve from its start ``x`` and residual ``r``
    (both contiguous, one shape); ``z``, ``p`` and the sums are allocated
    here, ``γ`` is set by the first `update`."""
    if x.dim() != 2 or x.shape != r.shape or not (x.is_contiguous() and r.is_contiguous()):
        raise ValueError("cg_fused: x and r must be contiguous 2-D tensors of one shape")
    if x.dtype not in (torch.float32, torch.float64) or r.dtype != x.dtype:
        raise ValueError(f"cg_fused: a real f32 or f64 state, not x {x.dtype} and r {r.dtype}")
    if prec.dtype != x.dtype or prec.device != x.device:
        raise ValueError(f"cg_fused: the preconditioner is {prec.dtype} on {prec.device}, the "
                         f"state {x.dtype} on {x.device}")
    if prec.dim() == 1 and prec.stride(0) != 1:
        raise ValueError(f"cg_fused: a Jacobi diagonal of stride {prec.stride(0)}, not 1")
    if prec.dim() == 3 and not prec.shape[1] == prec.shape[2] <= MAX_BS:
        raise ValueError(f"cg_fused: block-Jacobi blocks {tuple(prec.shape[1:])}, at most "
                         f"{MAX_BS} wide and square")
    if prec.dim() not in (1, 3):
        raise ValueError(f"cg_fused: a preconditioner of {prec.dim()} dimensions")
    rows, q = x.shape[axis], x.shape[1 - axis]
    if prec.dim() == 3 and prec.shape[0] * prec.shape[1] < rows:
        raise ValueError(f"cg_fused: {prec.shape[0]} blocks of {prec.shape[1]} for "
                         f"{rows} rows")
    if prec.dim() == 1 and prec.shape[0] < rows:
        raise ValueError(f"cg_fused: a diagonal of {prec.shape[0]} for {rows} rows")
    on_card = x.device.type != "cpu"
    n_el = elementwise_parts(x.numel()) if on_card else 1
    n_rz = precond_parts(prec, rows, q) if on_card else 1
    new = lambda n: torch.zeros(n, dtype=x.dtype, device=x.device)  # noqa: E731
    sc = torch.stack([torch.zeros_like(atol2), atol2]).to(x.dtype)
    ws = Workspace(x=x, r=r, z=torch.empty_like(r), p=torch.empty_like(r), prec=prec,
                   s=float(s), axis=axis, sc=sc,
                   flag=torch.zeros(1, dtype=torch.int32, device=x.device),
                   part_pap=new(n_el), part_rr=new(n_el), part_rz=new(n_rz))
    return dataclasses.replace(ws, launch=bind(ws)) if on_card else ws


def bind(ws: Workspace) -> dict:
    """The launches on ``ws`` (each kernel, and `iteration`'s four), every
    argument fixed but the product's address: the workspace's tensors stay
    in place for the whole solve, so an iteration's host work is one call."""
    fn = {name: _kernel(name, ws.x.dtype) for name in _ARGTYPES}
    x, r, z, p, prec = (t.data_ptr() for t in (ws.x, ws.r, ws.z, ws.p, ws.prec))
    pap_, rr, rz, sc, flag = (t.data_ptr() for t in (ws.part_pap, ws.part_rr, ws.part_rz, ws.sc,
                                                      ws.flag))
    n_el, n_rz, L, s = ws.part_pap.numel(), ws.part_rz.numel(), ws.x.numel(), ws.s
    # The solve's stream: PyTorch's current one on the state's device.
    stream = torch._C._cuda_getCurrentRawStream(ws.x.device.index)
    P = ws.prec
    block = P.stride() + P.shape[:2] if P.dim() == 3 else (0, 0, 0, 0, 0)
    shape = (ws.r.shape[ws.axis], ws.r.shape[1 - ws.axis], ws.r.stride(ws.axis),
             ws.r.stride(1 - ws.axis))
    precond_args = (r, z, prec, *block, *shape, s, rz, n_rz, stream)
    direction_args = (z, p, L, rz, n_rz, sc, rr, n_el, flag, n_el, stream)
    head, tail = (x, r, z, p), (L, pap_, rr, n_el, rz, n_rz, sc, flag, s, prec, *block, *shape,
                                stream)
    return {
        "pap": lambda a: fn["pap"](p, a, L, pap_, n_el, stream),
        "update": lambda a: fn["update"](x, r, p, a, L, pap_, n_el, rz, n_rz, s, sc, rr, n_el,
                                         stream),
        "precond": lambda: fn["precond"](*precond_args),
        "direction": lambda: fn["direction"](*direction_args),
        "iteration": lambda a: fn["iteration"](*head, a, *tail),
    }


# --- plain versions (the CPU path and the kernels' oracle) --------------------


def _dot(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    return torch.vdot(x.reshape(-1), y.reshape(-1))


def block_apply(inv: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Apply ``(nb, bs, bs)`` block inverses to column-major ``(n, q)``."""
    nb, bs, _ = inv.shape
    squeeze = x.dim() == 1
    if squeeze:
        x = x[:, None]
    n, q = x.shape
    xp = F.pad(x, (0, 0, 0, nb * bs - n)).reshape(nb, bs, q)
    y = torch.bmm(inv, xp).reshape(nb * bs, q)[:n]
    return y[:, 0] if squeeze else y


def block_apply_t(inv: torch.Tensor, xt: torch.Tensor) -> torch.Tensor:
    """Apply ``(nb, bs, bs)`` block inverses in lane-major ``(q, N)``."""
    q, N = xt.shape
    nb, bs, _ = inv.shape
    xb = F.pad(xt, (0, nb * bs - N)).reshape(q, nb, bs)
    y = torch.einsum("nab,qnb->qna", inv, xb)
    return y.reshape(q, nb * bs)[:, :N]


def precond_apply(prec: torch.Tensor, x: torch.Tensor, axis: int) -> torch.Tensor:
    """``M⁻¹x`` on a state whose problem axis is ``axis``."""
    if prec.dim() == 3:
        return block_apply_t(prec, x) if axis == 1 else block_apply(prec, x)
    if axis == 1:
        return prec[None, :] * x
    return prec[:x.shape[0], None] * x


def pap_plain(ws: Workspace, a: torch.Tensor) -> None:
    ws.part_pap.copy_(_dot(ws.p, a).reshape(1))


def update_plain(ws: Workspace, a: torch.Tensor) -> None:
    gamma = ws.part_rz.sum()
    alpha = gamma / (ws.s * ws.part_pap.sum())
    ws.sc[0] = gamma
    ws.x.add_(alpha * ws.p)
    ws.r.sub_((alpha * ws.s) * a)
    ws.part_rr.copy_(_dot(ws.r, ws.r).reshape(1))


def precond_plain(ws: Workspace) -> None:
    ws.z.copy_(ws.s * precond_apply(ws.prec, ws.r, ws.axis))
    ws.part_rz.copy_(_dot(ws.r, ws.z).reshape(1))


def direction_plain(ws: Workspace) -> None:
    beta = ws.part_rz.sum() / ws.sc[0]
    ws.p.copy_(ws.z + beta * ws.p)
    ws.flag.copy_((ws.part_rr.sum() > ws.sc[1]).reshape(1))


# --- wrappers -------------------------------------------------------------------


def _done(name: str, err: int) -> None:
    global launches
    if err != 0:
        raise RuntimeError(f"cg_{name}: kernel launch failed with CUDA error {err}")
    launches += 1


def _check_product(ws: Workspace, a: torch.Tensor) -> None:
    if a.shape != ws.p.shape or a.dtype != ws.p.dtype or not a.is_contiguous():
        raise ValueError(f"cg_fused: the product is {a.dtype} {tuple(a.shape)} with strides "
                         f"{a.stride()}, the state {ws.p.dtype} {tuple(ws.p.shape)}, contiguous")


def pap(ws: Workspace, a: torch.Tensor) -> None:
    """Partial sums of ``⟨p, a⟩`` into ``ws.part_pap``."""
    if ws.launch is None:
        return pap_plain(ws, a)
    _check_product(ws, a)
    _done("pap", ws.launch["pap"](a.data_ptr()))


def update(ws: Workspace, a: torch.Tensor) -> None:
    """``x += α·p``, ``r −= α·s·a`` and the partial sums of ``⟨r, r⟩``."""
    if ws.launch is None:
        return update_plain(ws, a)
    _check_product(ws, a)
    _done("update", ws.launch["update"](a.data_ptr()))


def precond(ws: Workspace) -> None:
    """``z = s·M⁻¹r`` and the partial sums of ``⟨r, z⟩``."""
    if ws.launch is None:
        return precond_plain(ws)
    _done("precond", ws.launch["precond"]())


def direction(ws: Workspace) -> None:
    """``p = z + β·p`` and the stopping flag."""
    if ws.launch is None:
        return direction_plain(ws)
    _done("direction", ws.launch["direction"]())


def iteration(ws: Workspace, a: torch.Tensor) -> None:
    """`pap`, `update`, `precond` and `direction` on the product ``a``: one
    CG iteration after it, its four launches issued by one call."""
    global launches
    if ws.launch is None:
        pap_plain(ws, a)
        update_plain(ws, a)
        precond_plain(ws)
        return direction_plain(ws)
    _check_product(ws, a)
    err = ws.launch["iteration"](a.data_ptr())
    if err != 0:
        raise RuntimeError(f"cg_iteration: kernel launch failed with CUDA error {err}")
    launches += 4

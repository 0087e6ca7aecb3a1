"""Complex products through the real-only kernels K1 and K2.

A complex shift μ makes the ADI's shifted operator ``Aᵀ + μEᵀ`` complex,
and its Krylov iteration runs in complex arithmetic (as the JAX package's
``jax.scipy`` iteration does).  Both kernels take f32/f64 only, so a
complex product ``(Dr + i·Di)(Xr + i·Xi)`` runs as real ones: the operand's
real and imaginary parts are stacked along its column axis into one real
operand ``[Xr | Xi]``, and each real part of the operator multiplies it in
one launch,

    Dr·[Xr | Xi] = [DrXr | DrXi],   Di·[Xr | Xi] = [DiXr | DiXi],

    Y = (DrXr − DiXi) + i·(DrXi + DiXr).

Two launches for a complex operator, one for a real operator on a complex
operand or a complex operator on a real one (whose stack is the operand
itself).  The operators (`ops.dia.DiaOp`, `ops.sparse.BellOp`) take this
route for their products on the card (`SplitStorage`), with the parts of
their storage split once per operator; the kernel wrappers stay real-only.
"""

from __future__ import annotations

import functools

import torch


def split(data: torch.Tensor):
    """``(real part, imaginary part)`` of operator storage, each contiguous
    (the kernels' layout); ``(data, None)`` for real storage."""
    if not data.is_complex():
        return data, None
    return data.real.contiguous(), data.imag.contiguous()


def product(launch, parts, X: torch.Tensor, dim: int):
    """``data · X`` by real launches ``launch(real_data, real_operand)``,
    ``parts = split(data)``; ``dim`` is X's column axis (1 for an ``(N, q)``
    operand, 0 for a lane-major ``(q, N)`` one)."""
    re, im = parts
    q = X.shape[dim]
    if X.is_complex():
        Xs = torch.cat([X.real, X.imag], dim=dim)
    else:
        Xs = X.to(re.dtype)
    Yr = launch(re, Xs)
    if im is None:  # real operator, complex operand
        return torch.complex(Yr.narrow(dim, 0, q), Yr.narrow(dim, q, q))
    Yi = launch(im, Xs)
    if not X.is_complex():
        return torch.complex(Yr, Yi)
    return torch.complex(Yr.narrow(dim, 0, q) - Yi.narrow(dim, q, q),
                         Yr.narrow(dim, q, q) + Yi.narrow(dim, 0, q))


class SplitStorage:
    """For an operator with storage ``data`` and transposed storage
    ``data_t``: its products through a real-only kernel wrapper, complex
    ones on the card by `product`, on the parts of the storage split once
    per operator."""

    @functools.cached_property
    def _parts(self):
        return split(self.data)

    @functools.cached_property
    def _parts_t(self):
        return split(self.data_t)

    def _by_parts(self, X: torch.Tensor) -> bool:
        """Whether a product with ``X`` takes the complex route: complex
        storage or operand on the card (on the CPU the plain version takes
        complex data)."""
        return X.device.type != "cpu" and (self.data.is_complex() or X.is_complex())

    def _product(self, wrapper, X: torch.Tensor, dim: int, t: bool = False):
        """``wrapper(storage, X)`` on ``data`` (``data_t`` if ``t``); ``dim``
        is X's column axis."""
        if self._by_parts(X):
            return product(wrapper, self._parts_t if t else self._parts, X, dim)
        return wrapper(self.data_t if t else self.data, X)

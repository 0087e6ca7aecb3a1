"""The port's counterpart of the JAX package's ``__graft_entry__.py``:
`entry`, one LRSIF Ros1 GDRE step on the banded n=256 Rail surrogate, and
`dryrun_multichip`, the multi-rank dry run."""

from __future__ import annotations

import numpy as np
import scipy.sparse.linalg as spla
import torch

from . import config
from .lowrank import lowrank, lr_with_capacity
from .models.compiled import (
    CompiledConfig, build_dia_shift_ops, pair_encode_shifts, ros1_step_compiled)
from .ops.dia import dia_pencil
from .ops.operators import lin_comb
from .utils.testmat import rail_surrogate

#: The step's shifts: one real shift, one conjugate pair, one real shift.
SHIFTS = np.asarray([-0.5, -1.0 + 0.5j, -1.0 - 0.5j, -2.0])
TAU = 20.0
CONFIG = CompiledConfig(maxiters=8, compression_interval=4, r_res=16)


def entry(device=None):
    """Return ``(fn, args)``: ``fn(*args)`` runs one fully assembled sparse
    (DIA-banded) Ros1 step — RHS assembly, the ADI loop with block-Jacobi
    preconditioned Krylov shifted solves over precomputed `DiaShiftOps`,
    the SMW feedback correction — with every tensor on ``device`` (default
    `config.device()`, the card: without one it raises; ``"cpu"`` runs on
    the CPU).  The shift buffer is the pair encoding of `SHIFTS`."""
    dev = torch.device(device) if device is not None else config.device()
    dt = config.default_dtype()
    E, A, B, C = rail_surrogate(256)
    E_op, A_op = dia_pencil(E, A, dtype=dt, device=dev)
    B_d = torch.as_tensor(B, dtype=dt, device=dev)
    C_d = torch.as_tensor(C, dtype=dt, device=dev)
    q = C.shape[0]
    L0 = spla.splu(E.tocsc()).solve(np.asarray(C).T.copy())
    X0 = lr_with_capacity(
        lowrank(torch.as_tensor(L0, dtype=dt, device=dev),
                0.01 * torch.eye(q, dtype=dt, device=dev)), 64)
    shifts = pair_encode_shifts(SHIFTS)
    lus = build_dia_shift_ops(E_op, lin_comb(A_op, -1.0 / (2.0 * TAU), E_op),
                              shifts)
    abstol = 1e-6 if dt == torch.float32 else 1e-8

    def step(E_op, A_op, B_d, C_d, X0, tau, shifts, abstol, lus):
        return ros1_step_compiled(E_op, A_op, B_d, C_d, X0, tau, shifts,
                                  abstol, CONFIG, lus)

    return step, (E_op, A_op, B_d, C_d, X0, TAU, shifts, abstol, lus)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """The multi-rank dry run over ``n_devices`` ranks on ``device`` (default
    the card; ``"cpu"`` spawns gloo ranks on the CPU): the sharded products,
    the row-sharded compiled Ros1 and Newton steps and parareal over the
    ranks, each held against one process, within `parallel.dryrun.DEADLINE`
    seconds (`parallel.dryrun.dryrun_multichip`)."""
    from .parallel.dryrun import dryrun_multichip as _dry

    return _dry(n_devices, device)

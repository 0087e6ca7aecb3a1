"""Frozen operation counts of the dense sign-function GALE solver's two
phases (the program's ``models/lyapunov_dense.py``), and the card's f64
peak they are held against.

* the sign iteration, ``_sign_iteration(M, maxiters)``: each M-step is one
  LU (``2n³/3``) and two triangular solves against ``I`` (``n³`` each),
  ``(8/3)·n³`` operations;
* the replay, ``_replay_rhs(Ctil, Minvs, cs)``: each C-update is two
  ``n × n × n`` GEMMs, ``4·n³`` operations.

Bytes count each operand read once and each result written once.  The
least time is the operations over the f64 peak: both phases are bound by
operations at the sizes they run (n = 5177: 221 ms of operations against
3 ms of bytes a sign iteration).
"""

from __future__ import annotations

#: f64 on the tensor cores (DMMA), dense: NVIDIA H100 SXM data sheet, at
#: the full 700 W power limit.
PEAK_F64_FLOP_S = 67e12


def sign_counts(M, maxiters):
    """(bytes, operations, least seconds) of one sign iteration: ``M`` read,
    the ``maxiters`` inverses and the last iterate written."""
    n, esize = M.shape[0], M.element_size()
    flops = maxiters * 8 * n**3 // 3
    nbytes = esize * (maxiters + 2) * n * n
    return nbytes, flops, flops / PEAK_F64_FLOP_S


def replay_counts(Ctil, Minvs, cs):
    """(bytes, operations, least seconds) of one replay: ``C̃`` and the
    inverses read, the result written."""
    k, n = Minvs.shape[0], Minvs.shape[1]
    esize = Minvs.element_size()
    flops = k * 4 * n**3
    nbytes = esize * (k + 2) * n * n
    return nbytes, flops, flops / PEAK_F64_FLOP_S

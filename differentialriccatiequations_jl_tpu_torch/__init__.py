"""PyTorch/CUDA port of differentialriccatiequations_jl_tpu.

Mirrors the JAX package's module names and public API::

    from differentialriccatiequations_jl_tpu_torch import (
        GALEProblem, GDREProblem, GAREProblem, solve, init,
        ADI, Ros1, Ros2, Newton, Shifts, lowrank, residual)

    sol = solve(GDREProblem(E, A, B, C, X0, (t0, tf)), Ros1(), dt=-10.0)

Solvers run where the problem's tensors are: build them on the card
(``dia_pencil(E, A, device="cuda")``, CUDA tensors) or on the CPU.  Imports
torch, numpy and scipy, never JAX.  Banded (DIA) products run through the
hand-written CUDA kernel in ``csrc/dia_spmm.cu``, block-ELL products
through ``csrc/bell_spmm.cu``, on CUDA tensors (built at first use, not at
import), and through their plain PyTorch versions on CPU tensors.  The
dense solvers (the sign-function GALE, dense Ros1–4) run on
``torch.linalg`` factorizations and f64 matrix products (cuSOLVER and
cuBLAS on the card).
"""

from . import config  # noqa: F401  (switches TF32 off)
from .lowrank import (
    LowRank, lowrank, lr_add, lr_compress, lr_dot, lr_neg, lr_norm, lr_rank, lr_scale,
    lr_sub, lr_to_dense, lr_with_capacity, lr_zero)
from .models import (
    ADI, BartelsStewart, DRESolution, GALEProblem, GAREProblem, GDREProblem, GMRES,
    Kronecker, Newton, Parareal, Ros1, Ros2, Ros3, Ros4, init, residual,
    sign_function_cache, solve, solve_gale_dense, solve_gale_gmres, solve_gale_host,
    solve_gale_kronecker, solve_gdre_dense, solve_gdre_parareal)
from .models import shifts as Shifts
from .ops.blocklinear import (
    Backslash, BlockLinearProblem, Krylov, ShermanMorrisonWoodbury, solve_blocklinear)
from .ops.operators import DenseOp, LowRankUpdateOp, as_operator, lr_update

__all__ = [
    "LowRank", "lowrank", "lr_zero", "lr_add", "lr_sub", "lr_scale", "lr_neg",
    "lr_norm", "lr_dot", "lr_rank", "lr_compress", "lr_to_dense",
    "lr_with_capacity",
    "DenseOp", "LowRankUpdateOp", "lr_update", "as_operator",
    "BlockLinearProblem", "Backslash", "ShermanMorrisonWoodbury", "Krylov",
    "solve_blocklinear",
    "GALEProblem", "GDREProblem", "GAREProblem", "DRESolution",
    "ADI", "BartelsStewart", "GMRES", "Kronecker", "Newton",
    "Ros1", "Ros2", "Ros3", "Ros4", "Parareal",
    "solve", "init", "residual", "Shifts",
    "solve_gale_dense", "solve_gale_host", "solve_gale_kronecker",
    "sign_function_cache", "solve_gdre_dense", "solve_gale_gmres",
    "solve_gdre_parareal",
]

__version__ = "0.1.0"

"""The slice as a whole: the port's Ros1 step (`entry()`'s problem and
config at n=256) against the JAX package's ``ros1_step_compiled`` on the
same numpy inputs, f64 on the CPU — with the pair-encoded shift buffer
(BiCGStab, stacked-real double steps) and with an all-real buffer (CG).

Each package builds its own operators and shift tables from the same
scipy matrices.  Tolerance: 1e-9 relative for ``L D Lᵀ`` and ``K`` — the
Krylov tolerance 10·eps amplified by the ADI; the ADI iteration counts
must be equal.
"""

import importlib

import numpy as np
import pytest
import scipy.sparse.linalg as spla
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from differentialriccatiequations_jl_tpu.ops import dia as jdia  # noqa: E402
from differentialriccatiequations_jl_tpu.ops import operators as jopers  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.entry import CONFIG, SHIFTS, TAU, entry  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.kernels import dia_spmm as k1  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models import compiled as tcomp  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops import operators as topers  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops.sparse import bell_pencil  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate  # noqa: E402

jcomp = importlib.import_module("differentialriccatiequations_jl_tpu.models.compiled")
jlr = importlib.import_module("differentialriccatiequations_jl_tpu.lowrank")

RTOL = 1e-9
N = 256
REAL_SHIFTS = np.asarray([-0.5, -1.0, -2.0])
CONFIG_J = jcomp.CompiledConfig(maxiters=CONFIG.maxiters,
                                compression_interval=CONFIG.compression_interval,
                                r_res=CONFIG.r_res)


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def jax_steps():
    """The JAX step for both buffers, compiled once for the module."""
    E, A, B, C = rail_surrogate(N)
    jE, jA = jdia.dia_pencil(E, A)
    L0 = spla.splu(E.tocsc()).solve(C.T.copy())
    X0 = jlr.lr_with_capacity(
        jlr.lowrank(jnp.asarray(L0), 0.01 * jnp.eye(C.shape[0])), 64)
    F0 = jopers.lin_comb(jA, -1.0 / (2.0 * TAU), jE)
    out = {}
    for name, shifts in (("pair", tcomp.pair_encode_shifts(SHIFTS)),
                         ("real", REAL_SHIFTS)):
        ops = jcomp.build_dia_shift_ops(jE, F0, shifts)
        X, K, iters, res = jcomp.ros1_step_compiled(
            jE, jA, jnp.asarray(B), jnp.asarray(C), X0, jnp.asarray(TAU),
            jnp.asarray(shifts), jnp.asarray(1e-8), CONFIG_J, ops)
        out[name] = (np.asarray(jlr.lr_to_dense(X)), np.asarray(K), int(iters),
                     float(res), int(X.k), ops.cfg.method)
    return out


def _check(got, ref):
    X, K, iters, res = got
    Xd, Kd, it_ref, res_ref, k_ref, _ = ref
    assert iters == it_ref
    assert X.k == k_ref
    assert _rel(X.to_dense().numpy(), Xd) <= RTOL
    assert _rel(K.numpy(), Kd) <= RTOL
    np.testing.assert_allclose(float(res), res_ref, rtol=RTOL)


def test_entry_step_pair_buffer(jax_steps):
    fn, args = entry("cpu")
    before = k1.launches
    _check(fn(*args), jax_steps["pair"])
    assert k1.launches == before  # plain path on CPU tensors
    assert jax_steps["pair"][5] == args[-1].cfg.method == "bicgstab"


def test_step_real_buffer(jax_steps):
    _, args = entry("cpu")
    E_op, A_op, B_d, C_d, X0, tau, _, abstol, _ = args
    ops = tcomp.build_dia_shift_ops(
        E_op, topers.lin_comb(A_op, -1.0 / (2.0 * tau), E_op), REAL_SHIFTS)
    assert ops.cfg.method == jax_steps["real"][5] == "cg"
    _check(tcomp.ros1_step_compiled(E_op, A_op, B_d, C_d, X0, tau, REAL_SHIFTS,
                                    abstol, CONFIG, ops), jax_steps["real"])


def test_complex_buffer_raises():
    """A 1-D complex buffer raises on block-ELL cores, which take real
    shifts only; banded cores take it (complex data, BiCGStab)."""
    _, args = entry("cpu")
    E_op, A_op = args[:2]
    ops = tcomp.build_dia_shift_ops(E_op, A_op, SHIFTS)
    assert ops.data.is_complex() and ops.cfg.method == "bicgstab"
    E, A, _, _ = rail_surrogate(256)
    bE, bA = bell_pencil(E, A, bs=16, device="cpu")
    with pytest.raises(ValueError, match="real shifts only"):
        tcomp.build_sparse_shift_ops(bE, bA, SHIFTS)

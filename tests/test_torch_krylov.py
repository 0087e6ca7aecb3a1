"""The port's Krylov solvers (CG, BiCGStab), SMW and pair-SMW solves
against the JAX package, f64 on the CPU.

Both packages solve over the same precomputed shift operators: the JAX
``DiaShiftOps`` is carried into the port with `convert`, so block-inverse
rounding is not compared twice.  The port's own `build_dia_shift_ops` is checked
against the JAX one separately.
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from differentialriccatiequations_jl_tpu.ops import dia as jdia  # noqa: E402
from differentialriccatiequations_jl_tpu.ops import operators as jopers  # noqa: E402
from differentialriccatiequations_jl_tpu_torch import convert  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.entry import SHIFTS, TAU  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.models import compiled as tcomp  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops import dia as tdia  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.ops import operators as topers  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate  # noqa: E402

jcomp = importlib.import_module("differentialriccatiequations_jl_tpu.models.compiled")

# Krylov tolerance 10·eps on the normalized RHS; both packages run the same
# iteration, so the solutions agree to a small multiple of it.
RTOL = 1e-10
N = 256
REAL_SHIFTS = np.asarray([-0.5, -1.0, -2.0])


def _rel(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _to_port(j):
    opt = {name: (None if getattr(j, name) is None else np.asarray(getattr(j, name)))
           for name in ("et_data", "et_data_t", "pair_prec_re", "pair_prec_im",
                        "pair_index")}
    return convert.dia_shift_ops_from_numpy(
        np.asarray(j.data), np.asarray(j.data_t), np.asarray(j.prec_inv),
        j.offsets, j.n, j.nnz_, j.cfg, pair_cfg=j.pair_cfg, **opt, device="cpu")


@pytest.fixture(scope="module")
def setup():
    E, A, B, _ = rail_surrogate(N)
    jE, jA = jdia.dia_pencil(E, A)
    tE, tA = tdia.dia_pencil(E, A, device="cpu")
    jF0 = jopers.lin_comb(jA, -1.0 / (2.0 * TAU), jE)
    tF0 = topers.lin_comb(tA, -1.0 / (2.0 * TAU), tE)
    buffers = {"pair": tcomp.pair_encode_shifts(SHIFTS), "real": REAL_SHIFTS}
    jops = {k: jcomp.build_dia_shift_ops(jE, jF0, s) for k, s in buffers.items()}
    rng = np.random.default_rng(11)
    K = rng.standard_normal((B.shape[1], N)) / N
    W = rng.standard_normal((N, 6))
    return dict(E=E, A=A, B=B, K=K, W=W, jE=jE, tE=tE, jF0=jF0, tF0=tF0,
                buffers=buffers, jops=jops,
                tops={k: _to_port(j) for k, j in jops.items()})


def test_build_dia_shift_ops_matches_jax(setup):
    """The port's `build_dia_shift_ops` reproduces every leaf of the JAX one."""
    for name, shifts in setup["buffers"].items():
        j = setup["jops"][name]
        t = tcomp.build_dia_shift_ops(setup["tE"], setup["tF0"], shifts)
        assert t.cfg == convert.krylov_from(j.cfg)
        assert t.pair_cfg == convert.krylov_from(j.pair_cfg)
        assert t.offsets == j.offsets
        for leaf in ("data", "data_t", "prec_inv", "et_data", "et_data_t",
                     "pair_prec_re", "pair_prec_im"):
            got, ref = getattr(t, leaf), getattr(j, leaf)
            assert (got is None) == (ref is None), leaf
            if got is not None:
                np.testing.assert_allclose(got.numpy(), np.asarray(ref),
                                           rtol=1e-12, atol=1e-14, err_msg=leaf)
        if j.pair_index is not None:
            assert t.pair_index == tuple(np.asarray(j.pair_index).tolist())
    assert setup["jops"]["pair"].cfg.method == "bicgstab"
    assert setup["jops"]["real"].cfg.method == "cg"


@pytest.mark.parametrize("buffer,slot", [("pair", 0), ("pair", 2), ("real", 1)])
def test_core_solve(setup, buffer, slot):
    """BiCGStab (pair buffer's real slots) and CG (all-real buffer)."""
    W = setup["W"]
    got = setup["tops"][buffer].core_solver(slot).solve(torch.as_tensor(W))
    ref = setup["jops"][buffer].core_solver(slot).solve(jnp.asarray(W))
    assert _rel(got.numpy(), ref) <= RTOL


def test_single_rhs_solve_matches_dense(setup):
    """A 1-D right-hand side takes the column-major path (`DiaOp.mm`, the
    `(n, q)` block-Jacobi apply); checked against a dense solve."""
    w = setup["W"][:, 0]
    core = setup["tops"]["real"].core_solver(1)
    got = core.solve(torch.as_tensor(w)).numpy()
    ref = np.linalg.solve(core.op.to_dense().numpy(), w)
    assert _rel(got, ref) <= 1e-12


def test_pair_solve(setup):
    W = np.concatenate([setup["W"], np.zeros_like(setup["W"])], axis=1)
    b = float(setup["buffers"]["pair"][1, 1])
    got = setup["tops"]["pair"].pair_solver(1, b).solve(torch.as_tensor(W))
    ref = setup["jops"]["pair"].pair_solver(1, b).solve(jnp.asarray(W))
    assert _rel(got.numpy(), ref) <= RTOL


@pytest.mark.parametrize("pair", [False, True])
def test_smw_solve(setup, pair):
    """SMW feedback correction around the core (closed loop ``F0 − B K``)."""
    B, K, W = setup["B"], setup["K"], setup["W"]
    jF = jopers.lr_update(setup["jF0"], -1.0, jnp.asarray(B), jnp.asarray(K))
    tF = topers.lr_update(setup["tF0"], -1.0, torch.as_tensor(B), torch.as_tensor(K))
    jo, to = setup["jops"]["pair"], setup["tops"]["pair"]
    if pair:
        b = float(setup["buffers"]["pair"][1, 1])
        W = np.concatenate([W, np.zeros_like(W)], axis=1)
        got = tcomp._wrap_smw_pair(to.pair_solver(1, b), tF, torch.float64)
        ref = jcomp._wrap_smw_pair(jo.pair_solver(1, b), jF, jnp.float64)
    else:
        got = tcomp._wrap_smw(to.core_solver(0), tF, torch.float64)
        ref = jcomp._wrap_smw(jo.core_solver(0), jF, jnp.float64)
    assert _rel(got.solve(torch.as_tensor(W)).numpy(), ref.solve(jnp.asarray(W))) <= RTOL

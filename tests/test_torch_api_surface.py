"""The port's public names against the JAX package's: each ``__all__``
(the package, ``ops``, ``utils``, ``models``) covers the JAX one and every
name in it resolves, ``__version__`` is the same, and
``config.set_default_dtype`` sets the dtype the Penzl Arnoldi runs in, as
in the JAX package (its ``config.py:54-56``)."""

import importlib

import numpy as np
import pytest
import torch

pytest.importorskip("jax")

JAX, PORT = "differentialriccatiequations_jl_tpu", "differentialriccatiequations_jl_tpu_torch"


@pytest.mark.parametrize("sub", ["", ".ops", ".utils", ".models"])
def test_all_covers_the_jax_package(sub):
    jmod = importlib.import_module(JAX + sub)
    tmod = importlib.import_module(PORT + sub)
    missing = sorted(set(jmod.__all__) - set(tmod.__all__))
    assert not missing, f"{PORT + sub} lacks {missing}"
    unresolved = [name for name in tmod.__all__ if not hasattr(tmod, name)]
    assert not unresolved, f"{PORT + sub}.__all__ names {unresolved}"


def test_version_matches():
    assert importlib.import_module(PORT).__version__ == importlib.import_module(JAX).__version__


def test_subpackage_names_import():
    from differentialriccatiequations_jl_tpu_torch.models import LowRank, lowrank, lr_compress
    from differentialriccatiequations_jl_tpu_torch.ops import DenseOp, prepare_shifted
    from differentialriccatiequations_jl_tpu_torch.utils import Observer, callbacks, notify, timers

    X = lr_compress(lowrank(torch.ones((6, 2), dtype=torch.float64)))
    assert isinstance(X, LowRank) and X.k == 1
    assert DenseOp(torch.eye(3)).M.device.type == "cpu"
    assert callable(prepare_shifted) and hasattr(timers, "timeit")
    assert (Observer, notify) == (callbacks.Observer, callbacks.notify)


def test_set_default_dtype_sets_the_arnoldi_dtype(monkeypatch):
    """The Penzl Arnoldi (`models.shifts._heuristic_shifts`) runs in the
    default dtype: f64 by default, f32 once set; the test restores f64."""
    from differentialriccatiequations_jl_tpu_torch import config
    from differentialriccatiequations_jl_tpu_torch.models import shifts
    from differentialriccatiequations_jl_tpu_torch.ops.dia import dia_pencil
    from differentialriccatiequations_jl_tpu_torch.utils.testmat import (
        rail_surrogate, rail_surrogate_dense)

    seen = []
    arnoldi = shifts._arnoldi_ritz

    def recording(matvec, n, k, dtype, device, desc):
        seen.append(dtype)
        return arnoldi(matvec, n, k, dtype, device, desc)

    monkeypatch.setattr(shifts, "_arnoldi_ritz", recording)
    E, A, _, _ = rail_surrogate(64)
    E_op, A_op = dia_pencil(E, A, device="cpu")
    strategy = shifts.Heuristic(4, 6, 6)
    assert config.default_dtype() == torch.float64
    ref = shifts._heuristic_shifts(strategy, E_op, A_op)
    try:
        config.set_default_dtype("float32")
        assert config.default_dtype() == torch.float32
        assert config.eps() == float(np.finfo(np.float32).eps)
        got = shifts._heuristic_shifts(strategy, E_op, A_op)
        assert rail_surrogate_dense(8, device="cpu")[0].dtype == torch.float32
        config.set_default_dtype(torch.float64)
        assert config.default_dtype() == torch.float64
    finally:
        config.set_default_dtype(torch.float64)
    assert seen == [torch.float64] * 2 + [torch.float32] * 2
    assert len(got) == len(ref)
    np.testing.assert_allclose(np.sort_complex(np.asarray(got)),
                               np.sort_complex(np.asarray(ref)), rtol=1e-3)

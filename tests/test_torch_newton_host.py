"""The host Kleinman–Newton GARE solver through the public API: the port's
`solve(GAREProblem, Newton(ADI(...)))` against the JAX package's on the
Rail surrogate at n = 371 (the reference's ``rail.jl`` Newton-ADI), f64 on
the CPU, dense operators, with Projection and with Penzl shifts.

Tolerances: equal Newton steps, line-search λs, inexact-switch events and
ADI iterations; shifts as in ``tests/test_torch_adi.py`` (1e-10 relative
where the ADI's relative residual was above 1e-6 when they were drawn: at
1.6e-8 a Projection shift already differs by 1.4e-10); the residual under
1e-10·‖Q‖ (``tests/test_rail371.py``); ``X`` within 1e-9 relative.
"""

import importlib
import warnings

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import differentialriccatiequations_jl_tpu as J  # noqa: E402
import differentialriccatiequations_jl_tpu_torch as T  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.convert import (  # noqa: E402
    config_from, gare_problem_from_numpy)
from differentialriccatiequations_jl_tpu_torch.models.problems import (  # noqa: E402
    superlinear_forcing)
from differentialriccatiequations_jl_tpu_torch.utils import callbacks as tcb  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate  # noqa: E402

jcb = importlib.import_module("differentialriccatiequations_jl_tpu.utils.callbacks")
JS = J.Shifts
RELTOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    # Beside the JAX package's CPU thread pool, torch's own pool slows the
    # small products down; never raise the count again (MKL stalls).
    torch.set_num_threads(1)


def _recorder(mod):
    class Rec(mod.Observer):
        def __init__(self):
            self.shifts, self.gates, self.norms, self.meta, self.adi = [], [], [], [], []
            self.rn0 = self.rn = None

        def observe_gale_step(self, it, X, res, rn):
            if it == 0:
                self.rn0 = rn
            self.rn = rn

        def observe_gale_metadata(self, desc, mu):
            self.shifts.append(complex(mu))
            self.gates.append(self.rn / self.rn0 if self.rn0 else 0.0)

        def observe_gale_done(self, iters, X, res, rn):
            self.adi.append(iters)

        def observe_gare_step(self, i, X, res, rn):
            self.norms.append(rn)

        def observe_gare_metadata(self, desc, md):
            self.meta.append((desc, md))

    return Rec()


def _problems(n=371):
    E, A, B, C = rail_surrogate(n)
    Ed, Ad = E.toarray(), A.toarray()
    jprob = J.GAREProblem(Ed, Ad, J.lowrank(np.asarray(B)), J.lowrank(np.asarray(C).T))

    def lr(X):
        return np.asarray(X.L), np.asarray(X.D), int(X.k)

    return jprob, gare_problem_from_numpy(Ed, Ad, lr(jprob.G), lr(jprob.Q), device="cpu")


@pytest.mark.parametrize(
    "adi_kwargs",
    [dict(shifts=JS.Projection(2)),
     dict(shifts=JS.Cyclic(JS.Heuristic(10, 20, 20)), maxiters=200)],
    ids=["projection", "penzl"])
def test_newton_adi_matches_jax(adi_kwargs):
    jprob, tprob = _problems()
    alg = J.Newton(J.ADI(ignore_initial_guess=True, **adi_kwargs), maxiters=10,
                   reltol=RELTOL)
    jr, tr = _recorder(jcb), _recorder(tcb)
    Xj = J.solve(jprob, alg, observer=jr)
    Xt = T.solve(tprob, config_from(alg), observer=tr)
    assert len(jr.norms) == len(tr.norms)  # Newton steps
    assert [d for d, _ in jr.meta] == [d for d, _ in tr.meta]
    for (_, a), (_, b) in zip(jr.meta, tr.meta):
        assert a == b if isinstance(a, bool) else np.isclose(a, b, rtol=1e-12, atol=0)
    assert jr.adi == tr.adi
    assert len(jr.shifts) == len(tr.shifts)
    for x, y, g in zip(jr.shifts, tr.shifts, jr.gates):
        if g >= 1e-6:
            assert abs(x - y) <= 1e-10 * abs(x), (x, y, g)
    nQ = float(T.lr_norm(tprob.Q))
    assert float(T.lr_norm(T.residual(tprob, Xt))) < RELTOL * nQ
    Dj, Dt = np.asarray(J.lr_to_dense(Xj)), T.lr_to_dense(Xt).numpy()
    assert np.linalg.norm(Dt - Dj) <= 1e-9 * np.linalg.norm(Dj)


def test_newton_rejects_nonidentity_inner_and_gmres():
    _, tprob = _problems(40)
    G = tprob.G
    Gbad = T.lowrank(G.L, 2.0 * torch.eye(G.r, dtype=G.L.dtype))
    with pytest.raises(NotImplementedError, match="identity inner factor"):
        T.solve(T.GAREProblem(tprob.E, tprob.A, Gbad, tprob.Q), T.Newton())
    # A GMRES inner solver is ported (ROADMAP Queue 1 item 6);
    # tests/test_torch_gmres.py holds it against the JAX package.
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        X = T.solve(tprob, T.Newton(T.GMRES(maxiters=3, warn_convergence=False), maxiters=2))
    assert torch.isfinite(X.L).all()
    assert float(T.lr_norm(T.residual(tprob, X))) < float(T.lr_norm(tprob.Q))


def test_newton_superlinear_forcing_and_observer():
    """``tests/test_newton.py``'s forcing and observer case, on the port."""
    _, tprob = _problems(40)
    rec = _recorder(tcb)
    alg = T.Newton(T.ADI(ignore_initial_guess=True, shifts=T.Shifts.Projection(2)),
                   maxiters=12, reltol=RELTOL, inexact_forcing=superlinear_forcing)
    T.solve(tprob, alg, observer=rec)
    nQ = float(T.lr_norm(tprob.Q))
    assert rec.norms[-1] < RELTOL * nQ
    assert rec.norms[-1] < rec.norms[0]
    assert any(d == "inexact" for d, _ in rec.meta)

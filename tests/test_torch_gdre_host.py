"""The host low-rank GDRE integrators through the public API: the port's
`solve(GDREProblem, Ros1()/Ros2(), dt=…)` against the JAX package's on the
Rail surrogate at n = 371 (the reference's ``rail.jl`` size), f64 on the
CPU, dense operators (dense LU shifted solves, as ``tests/test_rail371.py``
runs the JAX package), two steps of dt = -50.

Tolerances: ``K`` at the last stop within ``‖K‖·n·eps·100`` (the
reference's LRSIF-vs-dense bound); equal ADI iterations in every GALE.
The shift sequences are held equal (1e-10 relative, pairs compared as
pairs) with Penzl shifts, which both packages draw from the same Arnoldi
Ritz values.  With the default Projection shifts, only the first step's
are (those drawn while its ADI's relative residual was above 1e-6, as in
``tests/test_torch_adi.py``): from the second step on, a step's first
shifts are Ritz values of the pencil projected onto its initial residual
factor, and that factor is a small difference of large terms built from
the last step's compressed X (the warm-started Ros1 residual, the
compressed Ros2 stage right-hand side), so their trailing digits follow the
rounding of each package (2.4e-6 relative in Ros1's second step, 1.3e-9 in
Ros2's).
"""

import importlib

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")

import differentialriccatiequations_jl_tpu as J  # noqa: E402
import differentialriccatiequations_jl_tpu_torch as T  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.convert import (  # noqa: E402
    config_from, gdre_problem_from_numpy)
from differentialriccatiequations_jl_tpu_torch.utils import callbacks as tcb  # noqa: E402
from differentialriccatiequations_jl_tpu_torch.utils.testmat import rail_surrogate  # noqa: E402

jcb = importlib.import_module("differentialriccatiequations_jl_tpu.utils.callbacks")
N = 371
TSPAN = (4500.0, 4400.0)
DT = -50.0
EPS = float(np.finfo(np.float64).eps)


def _recorder(mod):
    class Rec(mod.Observer):
        def __init__(self):
            self.shifts, self.gates, self.stops, self.adi = [], [], [], []
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

        def observe_gdre_step(self, t, X, K):
            self.stops.append(t)

    return Rec()


def _canon(shifts):
    out, i = [], 0
    while i < len(shifts):
        v = shifts[i]
        if (v.imag != 0 and i + 1 < len(shifts)
                and abs(shifts[i + 1] - v.conjugate()) <= 1e-8 * abs(v)):
            out += sorted(shifts[i:i + 2], key=lambda z: -z.imag)
            i += 2
        else:
            out.append(v)
            i += 1
    return out


def _problems():
    E, A, B, C = rail_surrogate(N)
    Ed, Ad = E.toarray(), A.toarray()
    X0 = J.lowrank(np.linalg.solve(Ed, C.T), 0.01 * np.eye(C.shape[0]))
    jprob = J.GDREProblem(Ed, Ad, B, C, X0, TSPAN)
    tprob = gdre_problem_from_numpy(Ed, Ad, B, C, (np.asarray(X0.L), np.asarray(X0.D),
                                                   int(X0.k)), TSPAN, device="cpu")
    return jprob, tprob


PENZL = J.ADI(shifts=J.Shifts.Cyclic(J.Shifts.Heuristic(10, 20, 20)), maxiters=200)


@pytest.mark.parametrize(
    "alg", [J.Ros1(), J.Ros1(PENZL), J.Ros2(PENZL)],
    ids=["ros1-projection", "ros1-penzl", "ros2-penzl"])
def test_lowrank_sweep_matches_jax(alg):
    jprob, tprob = _problems()
    jr, tr = _recorder(jcb), _recorder(tcb)
    sj = J.solve(jprob, alg, dt=DT, observer=jr)
    st = T.solve(tprob, config_from(alg), dt=DT, observer=tr)
    assert list(st.t) == list(sj.t) and jr.stops == tr.stops
    assert jr.adi == tr.adi  # ADI iterations of every GALE
    a, b = _canon(jr.shifts), _canon(tr.shifts)
    assert [z.imag != 0 for z in a] == [z.imag != 0 for z in b]
    if alg.inner_alg is not None:  # Penzl shifts
        for x, y in zip(a, b):
            assert abs(x - y) <= 1e-10 * abs(x), (x, y)
    else:  # Projection shifts: the first step's
        first = jr.adi[0]
        for x, y, g in zip(a[:first], b[:first], jr.gates[:first]):
            if g >= 1e-6:
                assert abs(x - y) <= 1e-10 * abs(x), (x, y, g)
    Kj, Kt = np.asarray(sj.K[-1]), st.K[-1].numpy()
    assert np.linalg.norm(Kt - Kj) < np.linalg.norm(Kj) * N * EPS * 100
    assert len(st.X) == 2 and st.X[0] is tprob.X0


def test_lowrank_misuse_raises():
    """A low-rank GDRE takes Ros1/Ros2 only; ``dt`` must divide ``tspan``."""
    _, tprob = _problems()
    with pytest.raises(TypeError, match="low-rank GDRE supports Ros1/Ros2"):
        T.solve(tprob, T.Ros3(), dt=DT)
    with pytest.raises(ValueError, match="does not evenly divide"):
        T.solve(tprob, T.Ros1(), dt=-30.0)

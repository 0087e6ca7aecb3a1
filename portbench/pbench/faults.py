"""Faults planted in the timed path, each of which has to make ``correct``
come out false: a request kind's module names its own in ``FAULTS``, a
dict from the fault's name to a function that plants it through pytest's
``monkeypatch``.  The CPU tests plant each, for every cell of that kind;
the benchmark's own runs never do."""

from __future__ import annotations

import torch


def _compiled():
    from differentialriccatiequations_jl_tpu_torch.models import compiled

    return compiled


def _unchanged_step(E, A, B, C, X, tau, shifts, abstol, cfg, shift_lus=None):
    from differentialriccatiequations_jl_tpu_torch.models.rosenbrock_lowrank import feedback_K

    return X, feedback_K(E, B, X), 1, torch.zeros(())


def _altered(fn):
    def wrapper(*args, **kw):
        X, K, iters, res = fn(*args, **kw)
        return X, K * 1.1, iters, res
    return wrapper


def sweep(step: str) -> dict:
    """A sweep whose compiled step ``step`` returns its state unchanged, or
    a ``K`` altered where it is produced."""
    def unchanged_state(monkeypatch):
        monkeypatch.setattr(_compiled(), step, _unchanged_step)

    def altered_answer(monkeypatch):
        compiled = _compiled()
        monkeypatch.setattr(compiled, step, _altered(getattr(compiled, step)))

    return {"unchanged_state": unchanged_state, "altered_answer": altered_answer}


def _newton_unchanged(monkeypatch):
    def bad(E, A, B, X, K, res, shifts, inner_abstol, cfg, shift_lus):
        return X, 1, torch.zeros(())
    monkeypatch.setattr(_compiled(), "_newton_step_compiled", bad)


def _newton_altered(monkeypatch):
    from differentialriccatiequations_jl_tpu_torch.lowrank import LowRank

    compiled = _compiled()
    solve = compiled.solve_gare_newton_compiled

    def bad(*args, **kw):
        X, info = solve(*args, **kw)
        return LowRank(L=X.L, D=X.D * (1.0 + 1e-6), k=X.k), info
    monkeypatch.setattr(compiled, "solve_gare_newton_compiled", bad)


# A Newton step that returns its state unchanged; an ``X`` altered where the
# solve returns it.
NEWTON = {"unchanged_state": _newton_unchanged, "altered_answer": _newton_altered}

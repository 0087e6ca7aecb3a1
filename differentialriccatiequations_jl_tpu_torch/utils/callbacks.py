"""Observer/callback system (port of the GARE part of the JAX package's
``utils/callbacks.py``).

Users subclass `Observer` and override any of the hooks; all default to
no-ops.  Solvers emit events through `notify(observer, event, *args)`, which
tolerates ``observer=None``.  The Newton solver
(`models.compiled.solve_gare_newton_compiled`) emits ``gare_start``,
``gare_metadata``, ``gare_step``, ``gare_failed`` and ``gare_done``.
"""

from __future__ import annotations


class Observer:
    """Base observer of the GARE events; override the hooks you need."""

    def observe_gare_start(self, prob, alg):
        pass

    def observe_gare_step(self, iter, X, residual, residual_norm):
        pass

    def observe_gare_done(self, iters, X, residual, residual_norm):
        pass

    def observe_gare_failed(self):
        pass

    def observe_gare_metadata(self, desc, metadata):
        pass


def notify(observer, event: str, *args) -> None:
    """Emit ``event`` to ``observer`` (no-op when observer is None)."""
    if observer is None:
        return
    getattr(observer, f"observe_{event}")(*args)

"""Observer/callback system (port of the JAX package's
``utils/callbacks.py``).

Users subclass `Observer` and override any of the hooks; all default to
no-ops.  Solvers emit events through `notify(observer, event, *args)`, which
tolerates ``observer=None``:

GALE:  gale_start, gale_step, gale_done, gale_failed, gale_metadata
       (the ADI, `models.adi.ADISolver`; its shifts as
       ``gale_metadata("ADI shifts", μ)``)
GARE:  gare_start, gare_step, gare_done, gare_failed, gare_metadata
       (`models.newton.solve_gare_newton`,
       `models.compiled.solve_gare_newton_compiled`)
GDRE:  gdre_start, gdre_step, gdre_done, gdre_failed
       (`models.rosenbrock_lowrank.solve_gdre_lowrank_ros{1,2}`)
"""

from __future__ import annotations


class Observer:
    """Base observer; override the hooks you need."""

    def observe_gale_start(self, prob, alg):
        pass

    def observe_gale_step(self, iter, X, residual, residual_norm):
        pass

    def observe_gale_done(self, iters, X, residual, residual_norm):
        pass

    def observe_gale_failed(self):
        pass

    def observe_gale_metadata(self, desc, metadata):
        pass

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

    def observe_gdre_start(self, prob, alg):
        pass

    def observe_gdre_step(self, t, X, K):
        pass

    def observe_gdre_done(self):
        pass

    def observe_gdre_failed(self):
        pass


def notify(observer, event: str, *args) -> None:
    """Emit ``event`` to ``observer`` (no-op when observer is None)."""
    if observer is None:
        return
    getattr(observer, f"observe_{event}")(*args)

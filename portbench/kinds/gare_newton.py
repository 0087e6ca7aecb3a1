"""``gare_newton``: one request is a compiled Kleinman–Newton GARE solve
from ``X = 0`` with ``G = lowrank(gain·B)``, ``Q = lowrank(Cᵀ)`` and
closed-loop Penzl shifts (`requests.Newton`).  Its CPU rehearsal runs the
traffic as it stands, and it has no float32 reference control: its
reference is a residual, not a solver."""

from pbench import faults, requests


def make(config, traffic, inputs, dtype, device):
    return requests.Newton(config, traffic, inputs, dtype, device)


FAULTS = faults.NEWTON

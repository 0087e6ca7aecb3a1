"""The controls of the comparison: what it reads when the work is done in
float32, the nearest precision below the configuration's float64.  Each
limit lies below the least reading of both, where both exist.

* ``program_f32``: the program's own float32 path (the whole problem in
  float32), judged against the float64 reference;
* ``reference_f32``: the reference itself run in float32 in the program's
  place (the sweeps; the Newton cell's reference is a residual, not a
  solver), judged against the float64 reference: what a float32 solve to
  float32 accuracy gives.
"""

from __future__ import annotations

import traceback

import torch

from . import reference, requests


def program_f32(config, traffic, inputs, device):
    """Returns (numbers, record); numbers is ``None`` and ``record["error"]``
    the failure where the float32 run raised (a control that crashes has
    failed, and gives no reading)."""
    req = requests.make(config, traffic, inputs, torch.float32, device)
    record = {}
    try:
        req.prepare()
        out = req.run(record)
    except Exception:  # the control's outcome, reported by the caller
        record["error"] = traceback.format_exc(limit=3)
        return None, record
    req.release()
    numbers, _ = req.check([out], torch.float64, device)
    return numbers, record


def reference_f32(config, traffic, inputs, device):
    req = requests.make(config, traffic, inputs, torch.float64, device)
    if not isinstance(req, requests.Sweep):
        return None
    E, A, B, C = (inputs[k] for k in "EABC")
    req.L0, req.D0 = requests.initial_state(inputs, traffic)
    dt = torch.float32
    P = reference.Pencil(E, A, B, C, dtype=dt, device=device)
    sweep = reference.ros1_sweep if req.method == "ros1" else reference.ros2_sweep
    Ks, (L, D), _ = sweep(P, torch.as_tensor(req.L0, dtype=dt, device=device),
                          torch.as_tensor(req.D0, dtype=dt, device=device), req.tau, req.nsteps)
    out = {"K": [K.to("cpu", torch.float64).numpy() for K in Ks],
           "X": (L.to("cpu", torch.float64).numpy(), D.to("cpu", torch.float64).numpy())}
    numbers, _ = req.check([out], torch.float64, device)
    return numbers

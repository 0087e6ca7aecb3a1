"""``dense_ros2_sweep``: one request is a fixed-step dense Ros2 GDRE sweep
through the port's public ``solve`` (which dispatches a dense problem to
``rosenbrock_dense.solve_gdre_dense``) from the dense
``X0 = L0·(x0_scale·I)·L0ᵀ``, ``L0 = E⁻¹Cᵀ`` (`requests.initial_state`).

The check runs the benchmark's plain low-rank Ros2 sweep
(`reference.ros2_sweep`) from the same factors ``(L0, x0_scale·I)``, the
same ``τ`` and step count: in exact arithmetic the dense and the low-rank
sweeps give the same ``X`` and ``K`` (the reference package makes this
cross-check, ``test/rail.jl:55-69``).  ``k_gap`` is the worst
``‖K − K_ref‖_F/‖K_ref‖_F`` over every stop of every compared request,
``x_gap`` the worst ``‖X − L_ref D_ref L_refᵀ‖_F/‖L_ref D_ref L_refᵀ‖_F`` of
the final ``X``; a stop count that differs reads ``inf``.
"""

import functools
import math
import time

import numpy as np
import torch

from pbench import reference, requests

#: M-steps of the `short_sign` fault: the most at which the first step's
#: last iterate at n = 371 is still more than 1e-2 from −I in
#: ``‖M + I‖_F/√n`` (0.0114 after 4 steps, 7.2e-4 after 5, 4.5e-6 after 6).
SHORT_SIGN = 4


def _observer(device, record):
    """An observer that synchronises at each ``gdre_step``, records each
    step's wall in ``record["steps"]``, copies each stop's ``K`` to the host
    and counts the steps whose ``K`` or ``X`` is not finite."""
    from differentialriccatiequations_jl_tpu_torch.utils.callbacks import Observer

    class StepObserver(Observer):
        def __init__(self):
            self.Ks, self.bad = [], 0
            self.mark = time.perf_counter()

        def observe_gdre_step(self, t, X, K):
            requests._sync(device)
            now = time.perf_counter()
            Kh = K.detach().to("cpu", torch.float64).numpy()
            if self.Ks:  # the first stop is X0's
                record["steps"].append({"wall": now - self.mark})
                if not (np.isfinite(Kh).all() and bool(torch.isfinite(X).all())):
                    self.bad += 1
            self.Ks.append(Kh)
            self.mark = time.perf_counter()

    return StepObserver()


class DenseSweep:
    def __init__(self, config, traffic, inputs, dtype, device):
        self.config, self.traffic, self.inputs = config, traffic, inputs
        self.dtype, self.device = dtype, device
        t0, tf = traffic["tspan"]
        self.dt = float(traffic["dt"])
        self.tau = -self.dt
        self.nsteps = int(round((tf - t0) / self.dt))
        self.tspan = (float(t0), float(tf))
        self.L0, self.D0 = requests.initial_state(inputs, traffic)

    def prepare(self):
        """The dense pencil and ``X0`` on the device, and one warm-up step."""
        from differentialriccatiequations_jl_tpu_torch import GDREProblem, Ros2, solve

        dt, dev = self.dtype, self.device
        E_op, A_op = requests.program_operators(self.config, self.inputs, dt, dev)
        L0 = torch.as_tensor(self.L0, dtype=dt, device=dev)
        X0 = L0 @ torch.as_tensor(self.D0, dtype=dt, device=dev) @ L0.T
        B = torch.as_tensor(self.inputs["B"], dtype=dt, device=dev)
        C = torch.as_tensor(self.inputs["C"], dtype=dt, device=dev)
        self.solve, self.alg = solve, Ros2()
        self.prob = GDREProblem(E_op, A_op, B, C, X0, self.tspan)
        warm = GDREProblem(E_op, A_op, B, C, X0, (self.tspan[0], self.tspan[0] + self.dt))
        self.solve(warm, self.alg, dt=self.dt, observer=_observer(dev, {"steps": []}))
        requests._sync(dev)

    def run(self, record: dict) -> dict:
        """One sweep; ``record["steps"]`` gets each step's wall.  Returns the
        host copies of ``K`` at every stop and of the final ``X``."""
        record["steps"] = []
        obs = _observer(self.device, record)
        sol = self.solve(self.prob, self.alg, dt=self.dt, observer=obs)
        X = sol.X[-1].detach().to("cpu", torch.float64).numpy()
        record["attempted"] = len(record["steps"])
        record["failed"] = obs.bad
        return {"K": obs.Ks, "X": X}

    def release(self):
        self.prob = None

    def reference_sweep(self, dtype, device):
        """The reference's sweep from the same factors: (Ks, (L, D), adi)."""
        E, A, B, C = (self.inputs[k] for k in "EABC")
        P = reference.Pencil(E, A, B, C, dtype=dtype, device=device)
        return reference.ros2_sweep(P, torch.as_tensor(self.L0, dtype=dtype, device=device),
                                    torch.as_tensor(self.D0, dtype=dtype, device=device),
                                    self.tau, self.nsteps)

    def check(self, outputs: list, dtype, device) -> tuple:
        """(numbers, notes): ``k_gap`` and ``x_gap`` against the reference."""
        Ks, (L, D), adi = self.reference_sweep(dtype, device)
        Ks = [K.to("cpu", torch.float64).numpy() for K in Ks]
        L64, D64 = L.to(torch.float64), D.to(torch.float64)
        Xr = L64 @ D64 @ L64.T
        x_norm = float(torch.linalg.norm(Xr))
        k_gap = x_gap = 0.0
        for out in outputs:
            if len(out["K"]) != len(Ks):
                return {"k_gap": math.inf, "x_gap": math.inf}, {"stops": len(out["K"])}
            for Kp, Kr in zip(out["K"], Ks):
                k_gap = max(k_gap, float(np.linalg.norm(Kp - Kr) / np.linalg.norm(Kr)))
            Xp = torch.as_tensor(out["X"], dtype=torch.float64, device=device)
            x_gap = max(x_gap, float(torch.linalg.norm(Xp - Xr)) / x_norm)
        if not math.isfinite(k_gap) or not math.isfinite(x_gap):
            k_gap = x_gap = math.inf
        notes = {"ref_adi_iters": sum(adi.iterations), "ref_worst_res": max(adi.residuals),
                 "ref_rank": int(L.shape[1]), "compared": len(outputs)}
        return {"k_gap": k_gap, "x_gap": x_gap}, notes


def make(config, traffic, inputs, dtype, device):
    return DenseSweep(config, traffic, inputs, dtype, device)


def tiny(config, traffic):
    """The CPU rehearsal's cut: the first two steps."""
    t0 = traffic["tspan"][0]
    return config, dict(traffic, tspan=[t0, t0 + 2 * traffic["dt"]])


def reference_f32(req, device):
    """The reference sweep in float32 in the program's place, its ``X``
    densified, judged by ``req.check``."""
    Ks, (L, D), _ = req.reference_sweep(torch.float32, device)
    L64, D64 = L.to(torch.float64), D.to(torch.float64)
    out = {"K": [K.to("cpu", torch.float64).numpy() for K in Ks],
           "X": (L64 @ D64 @ L64.T).cpu().numpy()}
    numbers, _ = req.check([out], torch.float64, device)
    return numbers


# --- faults planted in the timed path: each must make `correct` false ----------


def _plant(monkeypatch, wrap):
    """Replace the dense Ros2 step, looked up in ``rosenbrock_dense._STEPPERS``."""
    from differentialriccatiequations_jl_tpu_torch.models import rosenbrock_dense
    from differentialriccatiequations_jl_tpu_torch.models.problems import Ros2

    monkeypatch.setitem(rosenbrock_dense._STEPPERS, Ros2,
                        wrap(rosenbrock_dense._STEPPERS[Ros2]))


def _unchanged_state(monkeypatch):
    _plant(monkeypatch, lambda step: lambda Ed, Ad, B, CtC, X, K, tau, **kw: (X, K))


def _altered_answer(monkeypatch):
    def wrap(step):
        def altered(*args, **kw):
            X, K = step(*args, **kw)
            return X, K * 1.1
        return altered
    _plant(monkeypatch, wrap)


def _short_sign(monkeypatch):
    _plant(monkeypatch, lambda step: functools.partial(step, sign_iters=SHORT_SIGN))


FAULTS = {"unchanged_state": _unchanged_state, "altered_answer": _altered_answer,
          "short_sign": _short_sign}

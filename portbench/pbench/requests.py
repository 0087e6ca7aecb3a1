"""The general generator: the inputs, the program's pencil and the
request, each from the file that a name in the cell's files picks
(`byname.load`), with every size and setting read from the traffic file and
the configuration file:

* ``generators/<generator>.py``, for the configuration's ``"generator"``:
  ``build(config, seed) -> dict``, the matrices from the seed
  (``rail_surrogate``);
* ``formats/<format>.py``, for the configuration's ``"format"``:
  ``operators(config, inputs, dtype, device) -> (E_op, A_op)``, the
  program's pencil in that storage (``dia``, ``bell``);
* ``kinds/<request>.py``, for the traffic file's ``"request"``:
  ``make(config, traffic, inputs, dtype, device)``, the request
  (``ros1_sweep``, ``ros2_sweep``, ``gare_newton``); optionally
  ``tiny(config, traffic) -> (config, traffic)``, its cut for the CPU
  rehearsal, ``FAULTS``, the faults planted in its timed path that its
  check has to catch (`faults`), and ``reference_f32(request, device)``,
  the reference run in float32 in the program's place (`control`).

A request is a whole sweep or a whole Newton solve through the program's
public compiled entries (`solve_gdre_ros1_compiled`,
`solve_gdre_ros2_compiled`, `solve_gare_newton_compiled`), restarted from
the same inputs each time, so every request does the same work.  Set-up
(`prepare`) builds the program's operators, the Penzl shifts and the
problem, and warms up the request's own shapes.  `run` drives one request,
records each step (or solve) and returns host copies of what it produced;
`check` judges those against the plain reference (`reference`), which gets
only the benchmark's own inputs.
"""

from __future__ import annotations

import math
import time
import warnings

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from . import byname, reference

GAMMA = reference.GAMMA


def kind(traffic: dict):
    """The module of the traffic file's request kind."""
    return byname.load("kinds", traffic["request"])


def build_inputs(config: dict, seed: int) -> dict:
    """The configuration's matrices from the seed, by its generator."""
    return byname.load("generators", config["generator"]).build(config, seed)


def program_operators(config: dict, inputs: dict, dtype, device):
    """The program's pencil in the configuration's storage format."""
    return byname.load("formats", config["format"]).operators(config, inputs, dtype, device)


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _host_lr(X):
    """Active factors of a program `LowRank` as host float64 arrays."""
    k = X.k
    return (X.L[:, :k].detach().to("cpu", torch.float64).numpy(),
            X.D[:k, :k].detach().to("cpu", torch.float64).numpy())


def _finite(*arrays) -> bool:
    return all(bool(np.isfinite(a).all()) for a in arrays)


def initial_state(inputs: dict, traffic: dict):
    """``X0 = lowrank(E⁻¹Cᵀ, x0_scale·I)`` as host factors, made by the
    benchmark and handed to both sides."""
    E, C = inputs["E"], np.asarray(inputs["C"])
    L0 = spla.splu(sp.csc_matrix(E)).solve(C.T.copy())
    return L0, traffic["x0_scale"] * np.eye(C.shape[0])


class Sweep:
    """``ros1_sweep`` / ``ros2_sweep``: a fixed-step LRSIF Rosenbrock sweep
    from ``X0 = lowrank(E⁻¹Cᵀ, x0_scale·I)``."""

    def __init__(self, method: str, config: dict, traffic: dict, inputs: dict, dtype, device):
        self.method, self.config, self.traffic = method, config, traffic
        self.inputs, self.dtype, self.device = inputs, dtype, device
        t0, tf = traffic["tspan"]
        self.dt = float(traffic["dt"])
        self.tau = -self.dt
        self.nsteps = int(round((tf - t0) / self.dt))
        self.tspan = (float(t0), float(tf))

    def prepare(self):
        from differentialriccatiequations_jl_tpu_torch.lowrank import lowrank
        from differentialriccatiequations_jl_tpu_torch.models import compiled
        from differentialriccatiequations_jl_tpu_torch.models.problems import GDREProblem
        from differentialriccatiequations_jl_tpu_torch.models.shifts import heuristic_shifts_host

        E, A, B, C = (self.inputs[k] for k in "EABC")
        dt, dev, tau = self.dtype, self.device, self.tau
        F = (A - E / (2.0 * tau)) if self.method == "ros1" else (GAMMA * tau * A - 0.5 * E)
        sh = self.traffic["shifts"]
        sv = np.asarray(heuristic_shifts_host(E, sp.csr_matrix(F), sh["nshifts"], sh["kp"],
                                              sh["km"]))
        if np.any(np.abs(sv.imag) > 1e-12 * np.abs(sv)):
            raise ValueError("the Penzl shifts of this pencil are not real")
        self.shifts = sv.real.copy()
        self.L0, self.D0 = initial_state(self.inputs, self.traffic)
        E_op, A_op = program_operators(self.config, self.inputs, dt, dev)
        X0 = lowrank(torch.as_tensor(self.L0, dtype=dt, device=dev),
                     torch.as_tensor(self.D0, dtype=dt, device=dev))
        Bd = torch.as_tensor(B, dtype=dt, device=dev)
        Cd = torch.as_tensor(C, dtype=dt, device=dev)
        self.cfg = compiled.CompiledConfig(**self.traffic["cfg"])
        self.solve = (compiled.solve_gdre_ros1_compiled if self.method == "ros1"
                      else compiled.solve_gdre_ros2_compiled)
        self.prob = GDREProblem(E_op, A_op, Bd, Cd, X0, self.tspan)
        self.warm = GDREProblem(E_op, A_op, Bd, Cd, X0, (self.tspan[0], self.tspan[0] + self.dt))
        eps = float(torch.finfo(dt).eps)
        # The sweep's default ADI tolerance, n·eps·‖C‖_F: a step above it failed.
        self.abstol = C.shape[1] * eps * float(np.linalg.norm(C))
        self._sweep(self.warm, None)

    def _sweep(self, prob, record):
        dev = self.device
        mark = [time.perf_counter()]
        Ks = []

        def observer(i, X, K, iters, res):
            _sync(dev)
            now = time.perf_counter()
            if record is not None and i > 0:
                record["steps"].append({"wall": now - mark[0], "iters": int(iters),
                                        "res": float(res)})
            Ks.append(K.detach().to("cpu", torch.float64).numpy())
            mark[0] = time.perf_counter()

        sol = self.solve(prob, dt=self.dt, shifts=self.shifts, cfg=self.cfg,
                         capacity=self.traffic["capacity"], observer=observer)
        _sync(dev)
        return Ks, _host_lr(sol.X[-1])

    def run(self, record: dict) -> dict:
        """One sweep; ``record["steps"]`` gets each step's wall, ADI
        iterations and accepted residual."""
        record["steps"] = []
        Ks, X = self._sweep(self.prob, record)
        record["attempted"] = len(record["steps"])
        bad = [s for s in record["steps"] if not math.isfinite(s["res"]) or s["res"] > self.abstol]
        finite = _finite(*Ks, *X)
        record["failed"] = record["attempted"] if not finite else len(bad)
        return {"K": Ks, "X": X}

    def release(self):
        self.prob = self.warm = None

    def check(self, outputs: list, dtype, device) -> tuple[dict, dict]:
        """The worst relative gap of the program's ``K`` at any stop, and of
        its final ``X``, from the reference's sweep over the same inputs.
        Returns (numbers, notes)."""
        E, A, B, C = (self.inputs[k] for k in "EABC")
        P = reference.Pencil(E, A, B, C, dtype=dtype, device=device)
        sweep = reference.ros1_sweep if self.method == "ros1" else reference.ros2_sweep
        Ks, (L, D), adi = sweep(P, torch.as_tensor(self.L0, dtype=dtype, device=device),
                                torch.as_tensor(self.D0, dtype=dtype, device=device),
                                self.tau, self.nsteps)
        Ks = [K.to("cpu", torch.float64).numpy() for K in Ks]
        L64, D64 = L.to(torch.float64), D.to(torch.float64)
        x_norm = reference.lr_fro(L64, D64)
        k_gap = x_gap = 0.0
        for out in outputs:
            if len(out["K"]) != len(Ks):
                return {"k_gap": math.inf, "x_gap": math.inf}, {"stops": len(out["K"])}
            for Kp, Kr in zip(out["K"], Ks):
                k_gap = max(k_gap, float(np.linalg.norm(Kp - Kr) / np.linalg.norm(Kr)))
            Lp = torch.as_tensor(out["X"][0], device=device)
            Dp = torch.as_tensor(out["X"][1], device=device)
            x_gap = max(x_gap, reference.lr_diff(Lp, Dp, L64, D64) / x_norm)
        if not math.isfinite(k_gap) or not math.isfinite(x_gap):
            k_gap = x_gap = math.inf
        notes = {"ref_adi_iters": sum(adi.iterations), "ref_worst_res": max(adi.residuals),
                 "ref_rank": int(L.shape[1]), "compared": len(outputs)}
        return {"k_gap": k_gap, "x_gap": x_gap}, notes


def two_steps(config: dict, traffic: dict):
    """A sweep cut for the CPU rehearsal: its first two steps, at a capacity
    that holds every column at the rehearsal's size."""
    t0 = traffic["tspan"][0]
    return config, dict(traffic, tspan=[t0, t0 + 2 * traffic["dt"]], capacity=160)


class Newton:
    """``gare_newton``: the compiled Kleinman–Newton GARE solve from
    ``X = 0`` with ``G = lowrank(gain·B)``, ``Q = lowrank(Cᵀ)`` and
    closed-loop Penzl shifts."""

    def __init__(self, config: dict, traffic: dict, inputs: dict, dtype, device):
        self.config, self.traffic, self.inputs = config, traffic, inputs
        self.dtype, self.device = dtype, device

    def prepare(self):
        from differentialriccatiequations_jl_tpu_torch.lowrank import lowrank
        from differentialriccatiequations_jl_tpu_torch.models import compiled
        from differentialriccatiequations_jl_tpu_torch.models.problems import GAREProblem

        dt, dev, t = self.dtype, self.device, self.traffic
        E_op, A_op = program_operators(self.config, self.inputs, dt, dev)
        B, C = self.inputs["B"], self.inputs["C"]
        self.prob = GAREProblem(E_op, A_op,
                                lowrank(torch.as_tensor(t["gain"] * B, dtype=dt, device=dev)),
                                lowrank(torch.as_tensor(C.T.copy(), dtype=dt, device=dev)))
        self.compiled = compiled
        self.kw = dict(shifts=compiled.PerStepHeuristic(**t["shifts"]),
                       cfg=compiled.CompiledConfig(**t["cfg"]), capacity=t["capacity"],
                       reltol=t["reltol"])
        self._solve(t["warmup_maxiters"])

    def _solve(self, maxiters):
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            X, info = self.compiled.solve_gare_newton_compiled(self.prob, maxiters=maxiters,
                                                                **self.kw)
        _sync(self.device)
        return X, info

    def run(self, record: dict) -> dict:
        X, info = self._solve(self.traffic["maxiters"])
        Xh = _host_lr(X)
        record["newton_steps"] = int(info["newton_steps"])
        record["attempted"] = 1
        record["failed"] = 0 if (info["converged"] and _finite(*Xh)) else 1
        return {"X": Xh}

    def release(self):
        self.prob = None

    def check(self, outputs: list, dtype, device) -> tuple[dict, dict]:
        """The worst relative GARE residual of the program's ``X``, evaluated
        by the reference."""
        E, A, B, C = (self.inputs[k] for k in "EABC")
        P = reference.Pencil(E, A, B, C, dtype=dtype, device=device)
        worst = 0.0
        for out in outputs:
            L = torch.as_tensor(out["X"][0], dtype=dtype, device=device)
            D = torch.as_tensor(out["X"][1], dtype=dtype, device=device)
            r = reference.gare_residual(P, self.traffic["gain"], L, D)
            worst = max(worst, r if math.isfinite(r) else math.inf)
        return {"gare_res": worst}, {"compared": len(outputs)}


def make(config: dict, traffic: dict, inputs: dict, dtype, device):
    """The request of the traffic file's kind, not yet prepared."""
    return kind(traffic).make(config, traffic, inputs, dtype, device)

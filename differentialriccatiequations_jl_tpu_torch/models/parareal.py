"""Parareal (parallel-in-time) LRSIF GDRE solver.

Port of the JAX package's ``models/parareal.py``.  The time horizon is split
into ``S`` slabs; the fine propagator (``n_fine`` compiled LRSIF Ros1 steps,
`ros1_step_compiled`) advances every slab from its boundary state, and the
cheap coarse propagator (one Ros1 step per slab, ``τ_coarse = n_fine·τ_fine``)
runs serially and stitches the slabs together with the classic parareal
correction

    U_{s+1}^{k+1} = G(U_s^{k+1}) + F(U_s^k) − G(U_s^k)

which, on low-rank states, is a lazy LDLᵀ three-term sum followed by one
column compression back to the slab capacity (`_parareal_combine`).

After ``k`` iterations the first ``k`` slab boundaries are the serial fine
solution (up to compression), so ``max_iters = slabs`` reproduces the
sequential sweep.

The JAX package vmaps the fine step over the slabs and shards the slab axis
over a ``jax.sharding.Mesh``.  Here the step is driven from the host (ranks
are host ints, every Krylov iteration reads one value back), so the slabs run
one after another on the caller's device; with ``mesh`` (a 1-D
`torch.distributed` `DeviceMesh`, `parallel.make_mesh`) each rank runs the
fine sweeps of its ``S/W`` slabs, the results are all-gathered at fixed
shapes, and every rank then runs the same serial coarse correction (SPMD).
A batched ``while_loop`` in JAX keeps each slab's carry per lane, so each
slab's ADI count is its own; the loop here gives the same counts.
"""

from __future__ import annotations

import dataclasses
import warnings

import torch

from ..lowrank import LowRank, lr_add, lr_compress, lr_norm, lr_sub, lr_with_capacity
from ..ops.operators import lin_comb
from ..utils.callbacks import notify
from .compiled import (
    _abstol_default, build_step_shift_solvers, check_shift_pairing,
    encode_shifts_for_operator, ros1_step_compiled)
from .problems import DRESolution, Parareal
from .rosenbrock_lowrank import feedback_K, time_grid

__all__ = ["Parareal", "solve_gdre_parareal"]


def _parareal_combine(Gnew: LowRank, F: LowRank, Gold: LowRank,
                      capacity: int) -> LowRank:
    """U = compress(Gnew + (F − Gold)) back to the slab capacity."""
    corr = lr_sub(F, Gold, r_out=2 * capacity)
    s = lr_add(Gnew, corr, r_out=3 * capacity)
    return lr_compress(s, r_out=capacity)


def _boundary_delta(X: LowRank, Y: LowRank, capacity: int) -> torch.Tensor:
    return lr_norm(lr_sub(X, Y, r_out=2 * capacity))


def _fine_sweep(E, A, B, C, Xs, tau_f, shifts, abstol, cfg, lus, n_fine: int,
                with_states: bool = False):
    """Every slab of ``Xs`` advanced ``n_fine`` fine steps, one slab after
    another.  Returns (final states, per-slab lists of the step states (or
    ``None``), per-slab lists of the step feedbacks, total ADI iterations,
    the largest ADI residual norm)."""
    finals, states, Ks = [], [], []
    its, rmax = 0, 0.0
    for X in Xs:
        Xst, Kst = [], []
        for _ in range(n_fine):
            X, K, it, res = ros1_step_compiled(E, A, B, C, X, tau_f, shifts,
                                               abstol, cfg, lus)
            its += it
            rmax = max(rmax, float(res))
            Kst.append(K)
            if with_states:
                Xst.append(X)
        finals.append(X)
        states.append(Xst if with_states else None)
        Ks.append(Kst)
    return finals, (states if with_states else None), Ks, its, rmax


def _coarse_step(E, A, B, C, X, tau_c, cshifts, abstol, cfg, lus) -> LowRank:
    """One coarse Ros1 step."""
    Xn, _, _, _ = ros1_step_compiled(E, A, B, C, X, tau_c, cshifts, abstol,
                                     cfg, lus)
    return Xn


def _fine_sweep_sharded(mesh, sweep, Xs, with_states):
    """`_fine_sweep` with the slabs split over the ranks of ``mesh``: each
    rank sweeps its ``S/W`` consecutive slabs, then all-gathers give every
    rank every slab's result, at fixed shapes (every state at the slab
    capacity, the ranks carried as a tensor)."""
    import torch.distributed as dist

    W, rank = mesh.size(), mesh.get_local_rank()
    Sl = len(Xs) // W
    finals, states, Ks, its, rmax = sweep(Xs[rank * Sl:(rank + 1) * Sl], with_states)

    def gather(t):
        parts = [torch.empty_like(t) for _ in range(W)]
        dist.all_gather(parts, t.contiguous(), group=mesh.get_group())
        return torch.cat(parts)

    def gather_states(slabs):  # [slab][i] states → [slab][i] gathered states
        L = gather(torch.stack([torch.stack([X.L for X in sl]) for sl in slabs]))
        D = gather(torch.stack([torch.stack([X.D for X in sl]) for sl in slabs]))
        k = gather(torch.tensor([[X.k for X in sl] for sl in slabs], device=L.device))
        return [[LowRank(L=L[s, i], D=D[s, i], k=int(k[s, i])) for i in range(L.shape[1])]
                for s in range(L.shape[0])]

    finals = [sl[0] for sl in gather_states([[X] for X in finals])]
    states = gather_states(states) if with_states else None
    Ks = [list(sl) for sl in gather(torch.stack([torch.stack(sl) for sl in Ks]))]
    meta = gather(torch.tensor([[its, rmax]], dtype=torch.float64, device=finals[0].device))
    return finals, states, Ks, int(meta[:, 0].sum()), float(meta[:, 1].max())


def solve_gdre_parareal(prob, *, dt: float, shifts, cfg,
                        alg: Parareal | None = None,
                        slabs: int | None = None,
                        max_iters: int | None = None,
                        reltol: float | None = None,
                        capacity: int = 128,
                        abstol: float | None = None,
                        coarse_shifts=None,
                        mesh=None, axis_name: str = "slab",
                        save_state: bool = False,
                        krylov_cfg=None, observer=None) -> DRESolution:
    """Parareal LRSIF GDRE sweep (fine propagator = compiled Ros1).

    Parameters mirror `solve_gdre_ros1_compiled` plus the parareal knobs.
    ``coarse_shifts``: the coarse propagator's shift buffer (default
    ``shifts``); its shifted cores are built on ``A − E/(2·n_fine·τ)``.
    ``mesh``: optional 1-D `DeviceMesh` with a dimension named
    ``axis_name`` over an initialised process group (`parallel.make_mesh`);
    the slabs' fine sweeps are split over its ranks (the slab count must be
    divisible by its size).  Returns a `DRESolution` whose ``K``/``t``
    cover every fine step.  With ``save_state=True`` the ``X`` list holds the
    full fine-state trajectory (one state per ``t`` entry, from the final
    fine sweep); otherwise ``X`` holds the ``slabs+1`` slab boundary states,
    whose times are ``sol.parareal_info["boundary_times"]``.  Convergence
    metadata lives in ``sol.parareal_info``; ``sol.adi_iters``/
    ``sol.adi_res_max`` describe the **final** fine sweep (the returned
    trajectory) like the serial drivers, while cumulative totals over all
    parareal iterations are in ``parareal_info``.
    """
    alg = alg or Parareal(slabs=slabs or 4, max_iters=max_iters,
                          reltol=reltol if reltol is not None else 1e-8)
    if slabs is not None:
        alg = dataclasses.replace(alg, slabs=slabs)
    if max_iters is not None:
        alg = dataclasses.replace(alg, max_iters=max_iters)
    if reltol is not None:
        alg = dataclasses.replace(alg, reltol=reltol)
    S = alg.slabs
    K_max = alg.max_iters if alg.max_iters is not None else S

    E, A, B, C = prob.E, prob.A, prob.B, prob.C
    tstops = time_grid(prob.tspan, dt)
    nsteps = len(tstops) - 1
    if nsteps % S:
        raise ValueError(f"nsteps={nsteps} not divisible by slabs={S}")
    n_fine = nsteps // S
    tau_f = float(tstops[0] - tstops[1])
    tau_c = n_fine * tau_f
    if mesh is not None:
        names = tuple(mesh.mesh_dim_names or ())
        if axis_name not in names:
            raise ValueError(f"mesh has no dimension named '{axis_name}' "
                             f"(dimensions: {names}); pass axis_name=")
        if S % mesh.size():
            raise ValueError(f"slabs={S} not divisible by mesh dimension "
                             f"'{axis_name}' size {mesh.size()}")
        if mesh.device_type != B.device.type:
            raise ValueError(f"mesh is on '{mesh.device_type}', the problem on "
                             f"'{B.device.type}'")

    if abstol is None:
        abstol = _abstol_default(prob)

    core_f = lin_comb(A, -1.0 / (2.0 * tau_f), E)
    shifts = encode_shifts_for_operator(shifts, core_f)
    check_shift_pairing(shifts)
    cshifts = (shifts if coarse_shifts is None
               else encode_shifts_for_operator(coarse_shifts, core_f))
    lus_f = build_step_shift_solvers(E, core_f, shifts, krylov_cfg)
    lus_c = build_step_shift_solvers(
        E, lin_comb(A, -1.0 / (2.0 * tau_c), E), cshifts, krylov_cfg)

    def coarse(X):
        return _coarse_step(E, A, B, C, X, tau_c, cshifts, abstol, cfg, lus_c)

    def sweep(Xs, with_states=False):
        return _fine_sweep(E, A, B, C, Xs, tau_f, shifts, abstol, cfg, lus_f,
                           n_fine, with_states)

    def fine(Xs, with_states=False):
        if mesh is None:
            return sweep(Xs, with_states)
        return _fine_sweep_sharded(mesh, sweep, Xs, with_states)

    X0 = lr_with_capacity(lr_compress(prob.X0, r_out=prob.X0.r), capacity)
    notify(observer, "gdre_start", prob, alg)

    # Initialization: serial coarse sweep (parareal iteration 0).
    U = [X0]
    Gold = []
    for s in range(S):
        g = coarse(U[s])
        Gold.append(g)
        U.append(g)

    deltas = []
    iters_sweeps = 0
    res_max_sweeps = 0.0
    it_done = 0
    stopped_by = "max_iters"
    plateau_run = 0
    for k in range(K_max):
        Fb, _, _, its, rmax = fine(U[:S])
        iters_sweeps += its
        res_max_sweeps = max(res_max_sweeps, rmax)
        Unew = [X0]
        for s in range(S):
            if s < k + 1:
                # The first k+1 boundaries are converged (classical
                # parareal exactness): the fine value is the update.
                Us1 = Fb[s]
            else:
                Gnew = coarse(Unew[s])
                Us1 = _parareal_combine(Gnew, Fb[s], Gold[s], capacity)
                Gold[s] = Gnew
            Unew.append(Us1)
        # One host read for the S boundary updates.
        ds = torch.stack([_boundary_delta(Unew[s + 1], U[s + 1], capacity)
                          for s in range(S)])
        delta_max = float(ds.max())
        U = Unew
        deltas.append(delta_max)
        it_done = k + 1
        # One event per parareal iteration (coarse+fine sweep pair).
        notify(observer, "gdre_step", float(tstops[-1]), U[-1], None)
        if delta_max <= alg.reltol * float(lr_norm(U[-1])):
            stopped_by = "reltol"
            break
        if alg.plateau_factor is not None and len(deltas) >= 2:
            # Boundary updates stopped shrinking: require the stall on two
            # consecutive iterations before calling it the arithmetic
            # noise floor (a single slow step is not a plateau).
            plateau_run = (plateau_run + 1
                           if delta_max > alg.plateau_factor * deltas[-2]
                           else 0)
            if plateau_run >= 2:
                stopped_by = "plateau"
                break

    # Final fine sweep from the converged boundaries: yields the full
    # K(t) trajectory of the parareal solution (and its GALE residuals).
    Fb, Xs_st, Ks, its_f, rmax_f = fine(U[:S], with_states=save_state)
    K_list = [feedback_K(E, B, X0)] + [K for slab in Ks for K in slab]
    if save_state:
        # Time-ordered full trajectory, aligned 1:1 with ``tstops`` like
        # the serial save_state drivers.
        Xs = [X0] + [X for slab in Xs_st for X in slab]
    else:
        Xs = [X0] + Fb

    sol = DRESolution(Xs, K_list, tstops)
    # Like the serial drivers: iters/res of the *returned* trajectory
    # (= the final fine sweep); cumulative totals in parareal_info.
    sol.adi_iters = int(its_f)
    sol.adi_res_max = float(rmax_f)
    if stopped_by == "plateau":
        warnings.warn(
            "parareal stopped on a boundary-update plateau (arithmetic "
            f"noise floor) before reaching reltol={alg.reltol:g}: last "
            f"delta {deltas[-1]:.3e} vs target "
            f"{alg.reltol * float(lr_norm(U[-1])):.3e}; the returned "
            "trajectory is converged only to the delta floor")
    sol.parareal_info = {
        "iterations": it_done,
        "stopped_by": stopped_by,
        "deltas": deltas,
        "slabs": S,
        "n_fine": n_fine,
        "boundary_times": [float(tstops[s * n_fine]) for s in range(S + 1)],
        "fine_iters_total": int(iters_sweeps) + int(its_f),
        "res_max_all_sweeps": max(float(res_max_sweeps), float(rmax_f)),
    }
    notify(observer, "gdre_done")
    return sol

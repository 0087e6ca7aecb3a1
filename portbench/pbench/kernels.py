"""Instruments for the traced request: the benchmark's ranges around the
program's public kernel entry points, with each call's bytes, operations
and least time counted from its operand shapes (`roofline`), and the
roofline share they give."""

from __future__ import annotations

from . import roofline, trace

K1_RANGE = "portbench.k1"
K2_RANGE = "portbench.k2"


def _k1_mm(data, offsets, X, *a, **kw):
    """``dia_mm(data, offsets, X)``: ``X (N, q)``."""
    return _k1(data, X.shape[1], X.element_size(), False)


def _k1_mm_t(data, offsets, Xt, Z=None, alpha=1.0, beta=0.0):
    """``dia_mm_t(data, offsets, Xt, Z, alpha, beta)``: ``Xt (q, N)``."""
    return _k1(data, Xt.shape[0], Xt.element_size(), Z is not None)


def _k1(data, q, esize, epilogue):
    if q == 0:
        return 0, 0, 0.0
    ndiag, N = data.shape
    nbytes, flops = roofline.k1_counts(ndiag, N, q, esize, epilogue)
    return nbytes, flops, roofline.bound_s("k1", esize, nbytes, flops)[0]


def _k2_mm(cols, data, X):
    """``bell_mm(cols, data, X)``: ``X (n, q)``, ``data (nb, K, bs, bs)``."""
    n, q = X.shape
    if q == 0:
        return 0, 0, 0.0
    nb, K, bs, _ = data.shape
    esize = X.element_size()
    nbytes, flops = roofline.k2_counts(nb, K, bs, n, q, esize)
    return nbytes, flops, roofline.bound_s("k2", esize, nbytes, flops)[0]


def k1(run):
    from differentialriccatiequations_jl_tpu_torch.kernels import dia_spmm

    return trace.wrapped(dia_spmm, {"dia_mm": _k1_mm, "dia_mm_t": _k1_mm_t}, K1_RANGE,
                         run.meter)


def k2(run):
    from differentialriccatiequations_jl_tpu_torch.kernels import bell_spmm

    return trace.wrapped(bell_spmm, {"bell_mm": _k2_mm}, K2_RANGE, run.meter)


def roofline_pct(run, rng: str):
    """The summed least times of the range's calls over the device time of
    the kernels they launched, in %; ``None`` without a traced device time."""
    if run.trace is None:
        return None
    device_s = run.trace["ranges"].get(rng, {}).get("device_s", 0.0)
    bound = run.meter.calls[rng]["bound_s"] if rng in run.meter.calls else 0.0
    if device_s <= 0.0 or bound <= 0.0:
        return None
    return 100.0 * bound / device_s


def idle_pct(run):
    """The device's idle share, in %: the traced request's busy seconds over
    the mean wall of untraced requests of the same work, run before the
    profiler started, which carry none of its cost on the host."""
    if run.trace is None or run.trace["busy_s"] <= 0.0 or not run.untraced_walls:
        return None
    wall = sum(run.untraced_walls) / len(run.untraced_walls)
    return 100.0 * (1.0 - run.trace["busy_s"] / wall)

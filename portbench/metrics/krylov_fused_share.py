"""The share of the window's Krylov iterations run by the fused CG
iteration: the program's ``ops.blocklinear.krylov_fused_iterations`` over
its ``ops.blocklinear.krylov_iterations``.  Silent where no iteration ran
fused: a program without that counter, or a run on the CPU, whose solves
all take the unfused loops.

Read as ``krylov_fused_share.<suffix>`` too (``.step``, ``.newton``): one
reader for each end-to-end metric it moves."""

FUSED = "ops.blocklinear.krylov_fused_iterations"
ALL = "ops.blocklinear.krylov_iterations"


def read(run):
    if not run.counters.get(FUSED) or not run.counters.get(ALL):
        return None
    return run.counters[FUSED] / run.counters[ALL]

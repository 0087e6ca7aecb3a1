"""The dense replays' share of the card's f64 peak (%): the operations of
each ``models.lyapunov_dense._replay_rhs`` call of the traced request
(``len(Minvs)·4·n³``, `dense_counts.replay_counts`), counted in a
``portbench.replay`` range, at 67 TFLOP/s, over the device time of the
kernels those calls launched (cuBLAS DGEMMs)."""

from pbench import dense_counts, kernels, trace

RANGE = "portbench.replay"


def instrument(run):
    from differentialriccatiequations_jl_tpu_torch.models import lyapunov_dense

    return trace.wrapped(lyapunov_dense, {"_replay_rhs": dense_counts.replay_counts},
                         RANGE, run.meter)


def read(run):
    return kernels.roofline_pct(run, RANGE)

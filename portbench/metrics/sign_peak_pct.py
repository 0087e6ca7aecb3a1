"""The dense sign iteration's share of the card's f64 peak (%): the
operations of each ``models.lyapunov_dense._sign_iteration`` call of the
traced request (``maxiters·(8/3)·n³``, `dense_counts.sign_counts`), counted
in a ``portbench.sign`` range, at 67 TFLOP/s, over the device time of the
kernels those calls launched (cuSOLVER's ``getrf`` and ``getrs``)."""

from pbench import dense_counts, kernels, trace

RANGE = "portbench.sign"


def instrument(run):
    from differentialriccatiequations_jl_tpu_torch.models import lyapunov_dense

    return trace.wrapped(lyapunov_dense, {"_sign_iteration": dense_counts.sign_counts},
                         RANGE, run.meter)


def read(run):
    return kernels.roofline_pct(run, RANGE)

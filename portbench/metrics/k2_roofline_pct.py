"""Kernel K2's share of its roofline (%): the least times of the K2 calls
of the traced request, from their operand shapes, over the device time of
the kernels those calls launched."""

from pbench import kernels


def instrument(run):
    return kernels.k2(run)


def read(run):
    return kernels.roofline_pct(run, kernels.K2_RANGE)

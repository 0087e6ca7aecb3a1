"""Kernel K1's share of its roofline (%): the least times of the K1 calls
of the traced request, from their operand shapes, over the device time of
the kernels those calls launched.

Read as ``k1_roofline_pct.<suffix>`` too (``.step``, ``.newton``): one
reader for each end-to-end metric it moves."""

from pbench import kernels


def instrument(run):
    return kernels.k1(run)


def read(run):
    return kernels.roofline_pct(run, kernels.K1_RANGE)

"""The device's idle share (%): one minus the union of all kernel, copy and
memset intervals of the traced request over the wall of an untraced
request of the same work, run before the profiler started.  The profiler
slows the host, not the device (and the host stays slower after it), so the
traced request's own wall would count its cost as idle.

Read as ``device_idle_pct.<suffix>`` too (``.step``, ``.newton``): one
reader for each end-to-end metric it moves."""

from pbench import kernels


def read(run):
    return kernels.idle_pct(run)

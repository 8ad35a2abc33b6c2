"""device_idle_share.serve: 1 minus the union of the device's operations
(kernels, copies, sets) over the profiled sub-window's length."""

from portbench.metrics._share import idle_share


def read(rec, info):
    return idle_share(rec)

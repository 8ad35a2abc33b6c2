"""moe_roofline: the grouped expert products' least time for the calls of
the profiled sub-window (the family's ``moe_call``) over their device time
there (class "MoE")."""

from portbench.metrics._share import kernel_roofline


def read(rec, info):
    return kernel_roofline(rec, info, "MoE")

"""cast_share.serve: device time of the int8 weights' conversion copies
(the kernel class "cast copies" of ``trace.CLASSES``) over the device's
busy time in the profiled sub-window."""

from portbench.metrics._share import class_share


def read(rec, info):
    return class_share(rec, "cast copies")

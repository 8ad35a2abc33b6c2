"""twin_roofline: the test family's kernel class "Ktwin" against its
roofline, as a new kernel's metric reads it."""

from portbench.metrics._share import kernel_roofline


def read(rec, info):
    return kernel_roofline(rec, info, "Ktwin")

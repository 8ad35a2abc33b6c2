"""mla_roofline: the latent attention kernel's least time for the calls of
the profiled sub-window (the family's ``mla_call``: operations at 989
TFLOP/s or bytes at 3.35 TB/s, the larger) over its device time there
(the kernel and the merge of its split partials, class "MLA")."""

from portbench.metrics._share import kernel_roofline


def read(rec, info):
    return kernel_roofline(rec, info, "MLA")

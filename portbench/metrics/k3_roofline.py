"""k3_roofline: K3's least time for the calls of the profiled sub-window
(``roofline.k3_call`` per call: K/V bytes of the visible slots at 3.35 TB/s
or operations at 989 TFLOP/s, the larger) over K3's device time there (its
paged kernels and, where no K1 runs, the merges of its split partials)."""

from portbench.metrics._share import kernel_roofline


def _time(cls):
    t = cls.get("K3", [0.0, 0])[0]
    if "K1" not in cls:
        t += cls.get("K1/K3 merge", [0.0, 0])[0]
    return t


def read(rec, info):
    return kernel_roofline(rec, info, "K3", _time)

"""Shared arithmetic of the device-trace readers (not a metric itself). A
kernel's roofline metric returns ``kernel_roofline(rec, info, "<class>")``.
"""


def class_share(rec, cls):
    s = rec.get("trace")
    if not s or not s["busy_s"]:
        return None
    return 100.0 * s["classes"].get(cls, [0.0, 0])[0] / s["busy_s"]


def idle_share(rec):
    s = rec.get("trace")
    if not s or not s["window_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])


def kernel_roofline(rec, info, cls, time_s=None):
    """A kernel class's share of its roofline: its least time over the
    metered calls (``kernel_bounds[cls]``, which ``FlopMeter`` counts from
    the family's ``kernel_calls``) over its device time in the profiled
    sub-window (the class's, or ``time_s(classes)``). None where either is
    missing."""
    s = rec.get("trace")
    b = (rec.get("kernel_bounds") or {}).get(cls)
    if not s or not b or not b["calls"]:
        return None
    t = (s["classes"].get(cls, [0.0, 0])[0] if time_s is None
         else time_s(s["classes"]))
    if not t:
        return None
    return {"value": 100.0 * b["bound_s"] / t, "bound": b["kind"],
            "power_limit_w": info["power_limit_w"]}

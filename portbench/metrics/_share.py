"""Shared arithmetic of the device-trace readers (not a metric itself)."""


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

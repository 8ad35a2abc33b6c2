"""k3_roofline: K3's least time for the calls of the profiled sub-window
(``roofline.k3_call`` per call: K/V bytes of the visible slots at 3.35 TB/s
or operations at 989 TFLOP/s, the larger) over K3's device time there (its
paged kernels and, where no K1 runs, the merges of its split partials)."""


def read(rec, info):
    s, k3 = rec.get("trace"), rec.get("k3")
    if not s or not k3 or not k3["calls"]:
        return None
    cls = s["classes"]
    t = cls.get("K3", [0.0, 0])[0]
    if "K1" not in cls:
        t += cls.get("K1/K3 merge", [0.0, 0])[0]
    if not t:
        return None
    return {"value": 100.0 * k3["bound_s"] / t, "bound": k3["kind"],
            "power_limit_w": info["power_limit_w"]}

"""mfu.serve: the operations the serving forwards of the metered window
must do (the family's ``forward_flops``, counted from each forward's
shapes), over the window's seconds and the card's bf16 peak."""

from portbench import roofline


def read(rec, info):
    flops, secs = rec.get("flops_serve"), rec.get("window_s")
    if not flops or not secs:
        return None
    return {"value": 100.0 * flops / secs / roofline.PEAK_BF16_FLOPS,
            "peak": "989 TFLOP/s bf16", "power_limit_w": info["power_limit_w"]}

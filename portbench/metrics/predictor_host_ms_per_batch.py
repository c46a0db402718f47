"""Serve loop: the predictor's host milliseconds a batch outside the wait
on the device (``timings`` load + dispatch + stitch + save over the
window's batches)."""


def read(ctx):
    w = ctx["window"]
    if "timings" not in w or not w.get("batches"):
        return None
    t = w["timings"]
    return 1e3 * (t["load"] + t["dispatch"] + t["stitch"] + t["save"]) / w["batches"]

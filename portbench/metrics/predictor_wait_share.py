"""Serve loop: the share (%) of the window the predictor's host spent
waiting on device results (``StandardPredictor.timings["fetch"]``)."""


def read(ctx):
    w = ctx["window"]
    if "timings" not in w:
        return None
    return 100.0 * w["timings"]["fetch"] / w["window_s"]

"""Data: host milliseconds a step spent drawing the batch from the
``TrainLoader`` (the benchmark's span around the iterator it hands to
``train.train``), over the window."""


def read(ctx):
    w = ctx["window"]
    if not w.get("loader_draws"):
        return None
    return 1e3 * w["loader_s"] / w["loader_draws"]

"""Device: the share (%) of the traced tail in which no kernel, memcpy or
memset ran on the card (1 - the union of their intervals over the tail)."""


def read(ctx):
    t = ctx["trace"]
    if not t or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])

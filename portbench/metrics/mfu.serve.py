"""Model step: the share (%) of the card's peaks that the served slices of
the window reach: the reference generator's FLOPs a slice (dense convs and
matmuls by precision, the K1 layers' FIRs at their polyphase need in fp32)
at their peaks, times the window's slices/s."""


def read(ctx):
    rate = ctx["rate"].get("slices_per_s")
    if not rate:
        return None
    y = ctx["yardstick"]
    return y.mfu(y.serve_work(ctx["config"]), rate)

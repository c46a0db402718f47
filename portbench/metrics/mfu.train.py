"""Model step: the share (%) of the card's peaks that the window's train
steps reach: the reference step's FLOPs (both phases, R1, both backward
passes; the K1 layers' FIRs at their polyphase need in fp32) at their
peaks a step, over the window's time a step."""


def read(ctx):
    rate = ctx["rate"].get("img_per_s")
    if not rate:
        return None
    y = ctx["yardstick"]
    return y.mfu(y.train_work(ctx["config"]), rate, items=ctx["config"]["loaders"]["batch_size"])

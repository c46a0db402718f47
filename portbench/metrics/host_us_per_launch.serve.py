"""Model step: the host microseconds the G_ema forward takes to enqueue a
kernel: the time in ``afcm.serve.g_ema`` less its blocked time, over the
launches started in it, in the traced tail (``harness/spans.py``)."""

from portbench.harness import spans

G_EMA = "afcm.serve.g_ema"


def read(ctx):
    tail = spans.tail_of(ctx)
    if tail is None or not tail.launches([G_EMA]):
        return None
    return (tail.host_us([G_EMA]) - tail.blocked_us([G_EMA])) / tail.launches([G_EMA])

"""Model step: the share (%) of the traced tail in which the card idled
while the serve loop dispatched a batch (inside ``afcm.serve.dispatch``:
padding, the copies to the card, the G_ema forward's enqueue;
``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    tail = spans.tail_of(ctx)
    return None if tail is None else tail.idle_share(["afcm.serve.dispatch"])

"""Model step: the share (%) of the traced tail in which the card idled
while the train step updated the nets (``afcm.train.D.update``,
``afcm.train.G.update``: the gradients' fill, reductions and scrub, Adam)
and G_ema (``afcm.train.ema``) (``harness/spans.py``)."""

from portbench.harness import spans

UPDATES = ["afcm.train.D.update", "afcm.train.G.update", "afcm.train.ema"]


def read(ctx):
    tail = spans.tail_of(ctx)
    return None if tail is None else tail.idle_share(UPDATES)

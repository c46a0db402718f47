"""Train loop: the host milliseconds a step spent blocked on the card
(synchronizations and synchronous copies) while copying its batch to the
card (``afcm.train.h2d``), over the traced tail's steps
(``afcm.train.step``; ``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    return spans.per_request(ctx, "afcm.train.step",
                             lambda t: t.blocked_us(["afcm.train.h2d"]) / 1e3)

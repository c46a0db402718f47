"""Serve loop: the host milliseconds a batch spent blocked on the card
(synchronizations and synchronous copies) inside ``afcm.serve.dispatch``,
over the traced tail's batches (``harness/spans.py``)."""

from portbench.harness import spans

DISPATCH = "afcm.serve.dispatch"


def read(ctx):
    return spans.per_request(ctx, DISPATCH, lambda t: t.blocked_us([DISPATCH]) / 1e3)

"""Device: the share (%) of the traced tail in which the card idled under
no span of the port (``afcm.*``) nor of the benchmark (``portbench.*``):
the idle time the spans leave unexplained (``harness/spans.py``)."""

from portbench.harness import spans


def read(ctx):
    tail = spans.tail_of(ctx)
    return None if tail is None else tail.idle_share(None)

"""K2 (``filtered_lrelu_bwd_*`` kernels): the sum of its launches' bounds
(the backward's bytes, or its FMAs with the up passes recomputed) over its
device time in the traced tail."""

PATTERN = "filtered_lrelu_bwd_"


def read(ctx):
    from portbench.harness.rooflines import roofline
    return roofline(ctx, PATTERN, backward=True)

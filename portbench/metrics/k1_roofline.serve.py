"""K1 (``filtered_lrelu_fwd_*`` kernels): the sum of its launches' bounds
(bytes at 3.35 TB/s or polyphase FIR FMAs at 67 TFLOP/s fp32, whichever
is larger) over its device time in the traced tail."""

PATTERN = "filtered_lrelu_fwd_"


def read(ctx):
    from portbench.harness.rooflines import roofline
    return roofline(ctx, PATTERN, backward=False)

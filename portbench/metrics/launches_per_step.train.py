"""Model step: the kernel launches a train step (``cudaLaunchKernel*`` and
``cuLaunchKernel*`` on any thread, started inside ``afcm.train.step``:
autograd launches the backward's kernels from its own thread), over the
traced tail's steps (``harness/spans.py``)."""

from portbench.harness import spans

STEP = "afcm.train.step"


def read(ctx):
    return spans.per_request(ctx, STEP, lambda t: t.launches([STEP]))

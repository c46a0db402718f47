"""Model step: the kernel launches a batch (``cudaLaunchKernel*`` and
``cuLaunchKernel*`` on any thread, started inside ``afcm.serve.dispatch``),
over the traced tail's batches (``harness/spans.py``)."""

from portbench.harness import spans

DISPATCH = "afcm.serve.dispatch"


def read(ctx):
    return spans.per_request(ctx, DISPATCH, lambda t: t.launches([DISPATCH]))

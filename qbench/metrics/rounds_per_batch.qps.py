"""Algorithm-2 probe rounds a ``search_batch`` ran, the mean over the
window's batches (``BatchResult.rounds``)."""


def read(ctx):
    if not ctx.batches:
        return None
    return sum(b["rounds"] for b in ctx.batches) / len(ctx.batches)

"""Rows compared a query, the scan work the plans asked for:
``BatchResult.comparisons`` over the batch size, over the window."""


def read(ctx):
    if not ctx.batches:
        return None
    return (sum(b["comparisons"] for b in ctx.batches)
            / sum(b["size"] for b in ctx.batches))

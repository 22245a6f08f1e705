"""Share of a batch's plans that ran on the card, in %: the program's
``quake.plan.on_card`` spans (a fused plan: the centroid pass, and for
APS the estimator and probe choice, on the index's device) over the
traced window's ``quake.search_batch`` spans.  A program that counts
batches but has no such span reads 0."""


def read(ctx):
    if not ctx.trace:
        return None
    try:
        from repro_torch.obs.tracing import program_totals
    except ImportError:             # a program without the spans
        return None
    t = program_totals()
    n = t.get("quake.search_batch.count", 0)
    if not n:
        return None
    return 100.0 * t.get("quake.plan.on_card.count", 0) / n

"""Snapshot pages in a batch's scanned unions: the program's
``quake.plan.union_pages`` (pages in each union the pack expands, summed
over a batch's rounds) over the traced window's ``quake.search_batch``
spans.  A program without the counter reports none."""


def read(ctx):
    if not ctx.trace:
        return None
    try:
        from repro_torch.obs.tracing import program_totals
    except ImportError:             # a program without the spans
        return None
    t = program_totals()
    n = t.get("quake.search_batch.count", 0)
    if not n or "quake.plan.union_pages" not in t:
        return None
    return t["quake.plan.union_pages"] / n

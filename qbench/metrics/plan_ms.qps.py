"""Host milliseconds a batch in the program's planner: the ``quake.plan``
spans (``plan_rounds``, ``plan_batch``) less their ``quake.wait`` copies,
over the traced window's ``quake.search_batch`` spans.  The spans record
only while the profiler does, so the totals cover the traced window."""


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
    return (t.get("quake.plan.ns", 0) - t.get("quake.plan.wait_ns", 0)) \
        / n / 1e6

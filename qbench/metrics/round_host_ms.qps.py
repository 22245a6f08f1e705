"""Host milliseconds a batch in the program's Algorithm-2 round loop: the
``quake.rounds`` spans (``run_round_loop``) less their ``quake.wait``
copies, over the traced window's ``quake.search_batch`` spans."""


def read(ctx):
    if not ctx.trace:
        return None
    try:
        from repro_torch.obs.tracing import program_totals
    except ImportError:             # a program without the spans
        return None
    t = program_totals()
    n = t.get("quake.search_batch.count", 0)
    if not n or not t.get("quake.rounds.count", 0):
        return None
    return (t.get("quake.rounds.ns", 0) - t.get("quake.rounds.wait_ns", 0)) \
        / n / 1e6

"""Share of the device snapshot's slots that hold a row (%): the
program's ``quake.snapshot.live_rows`` over ``quake.snapshot.slots``,
which the executor adds for the snapshot that serves each batch of the
traced window.  A program without the counters reports none."""


def read(ctx):
    if not ctx.trace:
        return None
    try:
        from repro_torch.obs.tracing import program_totals
    except ImportError:             # a program without the spans
        return None
    t = program_totals()
    slots = t.get("quake.snapshot.slots", 0)
    if not slots:
        return None
    return 100.0 * t.get("quake.snapshot.live_rows", 0) / slots

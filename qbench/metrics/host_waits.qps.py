"""Copies the host blocks on a batch: the program's ``quake.wait`` spans
(device-to-host pulls and pageable host-to-device uploads) over the
traced window's ``quake.search_batch`` spans."""


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
    return t.get("quake.wait.count", 0) / n

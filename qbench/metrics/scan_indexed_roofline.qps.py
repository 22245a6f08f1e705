"""The indexed scan's share of its roofline over the traced window (%):
the summed bound of every call (``roofline/scan_indexed.py``) over the
scan's kernel time in the profiler trace."""


def read(ctx):
    return ctx.roofline("scan_indexed")

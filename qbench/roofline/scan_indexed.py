"""What one call of the indexed partition scan (``scan_topk_indexed``,
``kernels/csrc/scan_topk_indexed.cu``) needs: each live row of the union
slots that some query probes read once, the queries read once, the top-k
(an f32 distance and an int32 index each) written once, and 2 d
operations for each (query, live row) pair the mask selects."""

TARGET = ("repro_torch.kernels.scan_topk_indexed", "scan_topk_indexed_cuda")
KERNELS = ("grouped_scan_kernel", "group_queries_kernel", "tile_list_kernel",
           "merge_lists_kernel")


def matches(name: str) -> bool:
    """The f32/bf16 scan's kernels (the int8 scan's carry ``Q8``)."""
    return any(k in name for k in KERNELS) and "Q8" not in name


def record(queries, data, valid, sel, qmask, **_kw) -> dict:
    """The call's counts, as device scalars (no synchronisation)."""
    live = valid.sum(1)[sel.long()]
    used = qmask.any(0)
    return {"b": int(qmask.shape[0]), "d": int(data.shape[2]),
            "elem": int(data.element_size()),
            "rows": (live * used).sum(),
            "active": (qmask.long() * live[None, :]).sum()}


def work(rec: dict, k: int):
    """(flops, bytes) of one recorded call."""
    b, d, elem = rec["b"], rec["d"], rec["elem"]
    nbytes = float(rec["rows"]) * d * elem + b * d * elem + b * k * 8
    return 2.0 * d * float(rec["active"]), nbytes

"""Indexed partition scan + top-k: the batched executor's hot loop.

Replaces the JAX package's ``scan_topk_indexed_pallas``.  For B queries
over a union of U selected partitions of a ``(P, S, d)`` snapshot it
returns the ascending top-``k_pad`` of

    ||x||^2 + bias - 2 q.x   (L2)      or      bias - q.x   (IP)

where ``bias`` is MASK_DIST on invalid rows and query b sees union slot u
only where ``qmask[b, u]``.  Indices are flat, ``partition * S + slot``;
``||q||^2`` is left to the caller.  Equal distances keep the smaller flat
index.  Misses are MASK_DIST with index -1.

``scan_topk_indexed`` launches the CUDA kernel (``csrc/
scan_topk_indexed.cu``) for CUDA tensors and runs the plain version
beside it for CPU tensors.  Both kernels run the grouped driver of
``csrc/scan_grouped.cuh``: the queries are grouped on the device by the
union slots they probe (``group_queries_plain`` is that step in plain
PyTorch), and one block scans one partition for a tile of its queries.
Two designs do the scanning.  The register-tiled design (``TILED``,
tiles of ``QW`` queries) scans the calls where the products bound the
scan: ``design`` sends it f32 rows of ``TILED_MIN_D`` and wider, a
multiple of 4 and 16-byte aligned, in calls of ``TILED_MIN_B`` queries
or more.  The row-per-thread design (tiles of ``QT`` queries) scans the
rest (narrower or unaligned f32 rows, small calls, bf16 rows and int8
codes): a block stages its rows in column chunks through a ring, and its
tile's queries whole while they fit beside the ring (up to 1,892 f32 or
1,888 bf16 values, or 4,832 int8 codes, on an H100's 227 KB a block),
past that a column chunk a stage of the ring too (``QUERY_CHUNKS``).
The library lays out the design it is given, and each scan call that
takes the tiled one adds to the program counter ``quake.scan.tiled``.
Every ``k_pad`` up to ``K_MAX`` runs on the
kernels; past what a block's shared memory holds, the per-query top-K
buffers go to a global scratch the wrapper allocates.

The int8 variant ``scan_topk_indexed_q8`` (``csrc/scan_topk_indexed_q8.cu``,
replacing ``scan_topk_indexed_q8_pallas``) scans IVF-residual int8 codes:
the int8 product is dequantized with per-query and per-row scales and the
exact query-centroid term ``qc`` (``ref.scan_indexed_q8_ref`` states the
formula).  ``quantize_int8`` / ``quantize_int8_residual`` make the codes.

On ``meta`` tensors both ``*_cuda`` wrappers make the card call's
allocations, launch nothing and load no library (``meta_placement``
stands in for the library's placement query), and add ``work`` to
``build.META_WORK``; the dispatchers send them there inside
``build.card_route_on_meta``.  A meta call cannot see the mask, so its
work counts every (query, union slot) pair and every row as live: an
upper bound.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from ..obs import tracing
from . import build, ref
from .ref import MASK_DIST, quantize_int8, quantize_int8_residual

__all__ = ["K_MAX", "LAUNCHES", "LAUNCHES_Q8", "LAUNCHES_TILED", "QT",
           "QUERY_CHUNKS", "QW", "TILED", "TILED_MIN_B", "TILED_MIN_D",
           "buffer_size", "design", "meta_placement", "work",
           "group_queries_cuda", "group_queries_plain", "live_rows",
           "slot_order",
           "quantize_int8", "quantize_int8_residual", "scan_topk_indexed",
           "scan_topk_indexed_cuda", "scan_topk_indexed_plain",
           "scan_topk_indexed_q8", "scan_topk_indexed_q8_cuda",
           "scan_topk_indexed_q8_plain"]

Tensor = torch.Tensor

LAUNCHES = build.LaunchCounter("scan_topk_indexed")
LAUNCHES_Q8 = build.LaunchCounter("scan_topk_indexed_q8")
LAUNCHES_TILED = build.LaunchCounter("scan_topk_indexed_tiled")
K_MAX = 16384                # largest k_pad the kernels take
SCRATCH_BYTES = 2 << 30      # bound on the (B, Uc, k_pad) partial lists
QT = 16                      # queries per tile, row-per-thread design
QW = 64                      # queries per tile, register-tiled design
TOPK_SCRATCH_BYTES = 256 << 20   # bound on the global top-K buffers
GLOBAL_BUFS = 1              # placement: top-K buffers in global scratch
QUERY_CHUNKS = 4             # placement flag: queries staged by chunks
TILED = 8                    # placement flag: the register-tiled design
# the narrowest f32 rows, and the fewest queries of a call, that the
# tiled design scans (both designs timed on the card at the benchmark
# cells' plans, scripts/scan_crossover.py)
TILED_MIN_D = 256
TILED_MIN_B = 32


def _check_k_pad(k_pad: int) -> None:
    if k_pad < 1 or k_pad & (k_pad - 1):
        raise ValueError(f"k_pad must be a power of two, got {k_pad}")


def _check_kernel_k_pad(k_pad: int) -> None:
    _check_k_pad(k_pad)
    if k_pad > K_MAX:
        raise ValueError(f"k_pad {k_pad} exceeds the kernels' limit "
                         f"K_MAX = {K_MAX}")


def buffer_size(k_pad: int) -> int:
    """Entries of one query's top-K buffer in the kernels: the power of
    two >= k_pad + 32, at least 64 (``csrc/scan_common.cuh``)."""
    buf = 64
    while buf < k_pad + 32:
        buf *= 2
    return buf


def work(b: int, u: int, s: int, d: int, k_pad: int, elem: int,
         q8: bool = False, rows: float = None, active: float = None
         ) -> Tuple[float, float]:
    """(operations, bytes) of one call of ``b`` queries over ``u`` union
    slots of ``s`` rows of width ``d``: the ``rows`` the selected
    partitions hold live (default every row of the union) read once (with
    int8 codes their scales and ``aux`` too), the queries read and the
    top-``k_pad`` written once, the mask and the live flags read, and 2 d
    operations for each of the ``active`` (query, live row) pairs the
    mask selects (default all ``b * u * s``)."""
    rows = u * s if rows is None else rows
    active = b * u * s if active is None else active
    if q8:
        nbytes = (rows * (d + 4 + 4 + 1) + b * (d + 4) + b * u * (4 + 1)
                  + 2 * b * k_pad * 4)
    else:
        nbytes = rows * d * elem + b * d * 4 + 2 * b * k_pad * 4 \
            + b * u + rows
    return 2.0 * active * d, float(nbytes)


def design(queries: Tensor, data: Tensor) -> int:
    """The design that scans a call of these operands: ``TILED`` (the
    register-tiled design) for f32 rows of ``TILED_MIN_D`` and wider, a
    multiple of 4 with both bases 16-byte aligned (its copies are 16
    bytes), in calls of ``TILED_MIN_B`` queries or more; else 0 (the
    row-per-thread design).  Shapes and addresses only: it reads nothing
    from the device."""
    b, d = queries.shape
    if data.dtype != torch.float32 or d < TILED_MIN_D or d % 4 \
            or b < TILED_MIN_B:
        return 0
    return 0 if (queries.data_ptr() | data.data_ptr()) % 16 else TILED


def meta_placement(k_pad: int, tiled: int = 0) -> int:
    """``_placement``'s top-K buffers, for a call on meta tensors with no
    library: with ``tiled`` (``TILED``) the tiled design's, in shared
    memory while they take at most 128 KB (``tiled::TOPK_SMEM_BYTES``);
    else the row-per-thread design's, in shared memory (0) while they
    take at most 64 KB (``TOPK_SMEM_BYTES``); past either, in global
    scratch (``GLOBAL_BUFS``).  The query layout changes no
    allocation."""
    if tiled:
        small = QW * buffer_size(k_pad) * 8 <= 128 << 10
        return TILED | (0 if small else GLOBAL_BUFS)
    return 0 if QT * buffer_size(k_pad) * 8 <= 64 << 10 else GLOBAL_BUFS


def tile_width(placement: int) -> int:
    """Queries a tile of the design that ``placement`` names."""
    return QW if placement & TILED else QT


def slot_order(sel: Tensor, nrows: Tensor, uc: int) -> Tensor:
    """(U,) int32: the order in which the kernels take the union slots,
    within each chunk of ``uc`` slots the longest partitions first (ties
    by slot), so the longest tiles start first."""
    lens = nrows[sel.long()]
    order = [u0 + torch.argsort(lens[u0:u0 + uc], descending=True,
                                stable=True)
             for u0 in range(0, sel.shape[0], uc)]
    return torch.cat(order).to(torch.int32)


def group_queries_plain(qmask: Tensor, order: Optional[Tensor] = None,
                        uc: Optional[int] = None, qt: int = QT
                        ) -> Dict[str, Tensor]:
    """The grouping step of the indexed kernels in plain PyTorch, in
    tiles of ``qt`` queries (``QT``, or ``QW`` for the tiled design).
    For each union slot u: ``qlist[u, :qcount[u]]`` the queries b with
    ``qmask[b, u]`` in increasing b (-1 after them), ``ntiles[u] =
    ceil(qcount[u] / qt)``.  The tiles are listed slot by slot in
    ``order`` (default: slot order), ``uc`` slots a chunk: ``work_u``
    names each tile's slot, ``tile_off[u]`` is where u's tiles start and
    ``chunk_off`` (chunks + 1,) where each chunk's start."""
    b, u = qmask.shape
    dev = qmask.device
    uc = u if uc is None else uc
    order = torch.arange(u, device=dev) if order is None else order.long()
    qm = qmask.t()
    qcount = qm.sum(dim=1, dtype=torch.int32)
    first = torch.argsort((~qm).to(torch.uint8), dim=1, stable=True)
    ar = torch.arange(b, device=dev)
    qlist = torch.where(ar[None, :] < qcount[:, None], first, -1)
    ntiles = ((qcount + qt - 1) // qt).to(torch.int32)
    nt = ntiles[order]
    start = torch.cumsum(nt, 0, dtype=torch.int32) - nt
    tile_off = torch.empty(u, dtype=torch.int32, device=dev)
    tile_off[order] = start
    total = nt.sum(dtype=torch.int32).reshape(1)
    chunk_off = torch.cat([start[0:u:uc], total])
    work_u = torch.repeat_interleave(order.to(torch.int32), nt)
    return {"qlist": qlist.to(torch.int32), "qcount": qcount,
            "ntiles": ntiles, "tile_off": tile_off, "chunk_off": chunk_off,
            "work_u": work_u}


def _workspace(b: int, u: int, nchunks: int, dev, qt: int = QT) -> Tensor:
    """The kernels' int32 workspace (``GroupedWs`` in
    ``csrc/scan_grouped.cuh``) for tiles of ``qt`` queries: qlist (U,
    B), qcount, ntiles, tile_off, chunk_off (chunks + 1), work_u (U *
    ceil(B / qt)) and one tile counter per chunk."""
    n = u * b + 3 * u + nchunks + 1 + u * -(-b // qt) + nchunks
    return torch.empty(n, dtype=torch.int32, device=dev)


def group_queries_cuda(qmask: Tensor, order: Optional[Tensor] = None,
                       uc: Optional[int] = None, qt: int = QT
                       ) -> Dict[str, Tensor]:
    """The grouping kernels alone on a CUDA ``qmask``, in tiles of ``qt``
    queries, unpacked as ``group_queries_plain`` returns it (qlist past
    qcount is -1)."""
    if not qmask.is_cuda or qmask.dtype != torch.bool \
            or not qmask.is_contiguous():
        raise ValueError("qmask must be a contiguous bool CUDA tensor")
    b, u = qmask.shape
    uc = u if uc is None else uc
    nch = -(-u // uc)
    if order is None:
        order = torch.arange(u, dtype=torch.int32, device=qmask.device)
    order = order.to(torch.int32).contiguous()
    ws = _workspace(b, u, nch, qmask.device, qt)
    stream = torch.cuda.current_stream(qmask.device).cuda_stream
    build.check_launch(build.lib("scan_topk_indexed").group_queries(
        qmask.data_ptr(), order.data_ptr(), ws.data_ptr(), b, u, uc, qt,
        stream), "group_queries")
    sizes = [u * b, u, u, u, nch + 1, u * -(-b // qt)]
    qlist, qcount, ntiles, tile_off, chunk_off, work_u = torch.split(
        ws[:sum(sizes)], sizes)
    ar = torch.arange(b, device=qmask.device)
    qlist = torch.where(ar[None, :] < qcount[:, None], qlist.view(u, b), -1)
    return {"qlist": qlist, "qcount": qcount, "ntiles": ntiles,
            "tile_off": tile_off, "chunk_off": chunk_off,
            "work_u": work_u[:int(chunk_off[-1])]}


@functools.lru_cache(maxsize=None)
def _placement(kind: str, d: int, k_pad: int, device: int,
               tiled: int = 0) -> int:
    """How the block of the ``kind`` kernel ("f32", "bf16" or "q8") lays
    out its shared memory for rows of width ``d`` at ``k_pad`` on CUDA
    device ``device``, in the design ``tiled`` names (``TILED`` for the
    register-tiled one, f32 only; ``design`` chooses): the top-K buffers
    in shared memory (0) or in global scratch (``GLOBAL_BUFS``), ``|
    TILED`` in the tiled design, and, in the row-per-thread design, ``|
    QUERY_CHUNKS`` where the tile's queries are staged a column chunk at
    a time (rows too wide to hold them whole).  The library decides, from
    the row type and width and the card's limit."""
    with torch.cuda.device(device):
        if kind == "q8":
            got = build.lib("scan_topk_indexed_q8").scan_indexed_q8_placement(
                d, k_pad)
        else:
            got = build.lib("scan_topk_indexed").scan_indexed_placement(
                d, k_pad, int(kind == "bf16"), int(bool(tiled)))
    if got < 0:
        build.check_launch(-got, f"scan_topk_indexed ({kind}) placement")
    return got


def _grouped_scratch(kind: str, d: int, b: int, u: int, uc: int,
                     k_pad: int, dev, tiled: int = 0
                     ) -> Tuple[Tensor, Optional[Tensor], int, int]:
    """(workspace, global top-K buffers or None, their number of
    blocks, the placement flags) for one launch of an indexed kernel in
    the design ``tiled`` names: the workspace and buffers follow the
    design's tile width."""
    if dev.type == "meta":
        where = meta_placement(k_pad, tiled)
    else:
        where = _placement(kind, d, k_pad, dev.index
                           if dev.index is not None
                           else torch.cuda.current_device(), tiled)
    qt = tile_width(where)
    ws = _workspace(b, u, -(-u // uc), dev, qt)
    if not where & GLOBAL_BUFS:
        return ws, None, 0, where
    per_block = qt * buffer_size(k_pad) * 8
    blocks = max(1, TOPK_SCRATCH_BYTES // per_block)
    gbuf = torch.empty(blocks * per_block // 4, dtype=torch.float32,
                       device=dev)
    return ws, gbuf, blocks, where


def scan_topk_indexed_plain(queries: Tensor, data: Tensor, valid: Tensor,
                            sel: Tensor, qmask: Tensor, *, k_pad: int,
                            metric: str = "l2") -> Tuple[Tensor, Tensor]:
    """The kernel's function in plain PyTorch (the CPU path and the
    reference the CUDA kernel is held against): the oracle
    ``ref.scan_selected_ref`` with queries in the storage type, without
    ``||q||^2``, over the union in partition order (so equal distances
    keep the smaller flat index), padded to ``k_pad`` columns."""
    _check_k_pad(k_pad)
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric: {metric}")
    order = torch.argsort(sel.long(), stable=True)
    d, i = ref.scan_selected_ref(
        queries.to(data.dtype), data, valid, sel.long()[order],
        qmask[:, order], k_pad, metric, with_q2=False)
    return ref.pad_topk(d, i, k_pad)


def live_rows(valid: Tensor) -> Tensor:
    """(P,) int32: one past each partition's last valid slot (0 when it
    has none) — the rows the kernel has to read."""
    s = valid.shape[1]
    last = s - 1 - torch.argmax(valid.flip(1).to(torch.uint8), dim=1)
    return torch.where(valid.any(dim=1), last + 1, 0).to(torch.int32)


def scan_topk_indexed_cuda(queries: Tensor, data: Tensor, valid: Tensor,
                           sel: Tensor, qmask: Tensor, *, k_pad: int,
                           metric: str = "l2") -> Tuple[Tensor, Tensor]:
    """Launch the CUDA kernel.  Raises on any operand it does not take."""
    _check_kernel_k_pad(k_pad)
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric: {metric}")
    dev = data.device
    for name, t in (("queries", queries), ("data", data), ("valid", valid),
                    ("sel", sel), ("qmask", qmask)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, data on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type not in ("cuda", "meta"):
        raise ValueError("scan_topk_indexed_cuda needs CUDA (or meta) "
                         "tensors")
    if data.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"data must be f32 or bf16, got {data.dtype}")
    if queries.dtype != data.dtype:
        raise ValueError("queries must be in the storage type of data")
    if valid.dtype != torch.bool or qmask.dtype != torch.bool:
        raise ValueError("valid and qmask must be bool")
    if sel.dtype != torch.int32:
        raise ValueError("sel must be int32")
    p, s, d = data.shape
    b, u = qmask.shape
    if (queries.shape != (b, d) or valid.shape != (p, s)
            or sel.shape != (u,)):
        raise ValueError(
            f"shapes disagree: queries {tuple(queries.shape)}, data "
            f"{tuple(data.shape)}, valid {tuple(valid.shape)}, sel "
            f"{tuple(sel.shape)}, qmask {tuple(qmask.shape)}")
    if p * s >= 2 ** 31:
        raise ValueError("flat indices P*S must fit in int32")
    run_d = torch.full((b, k_pad), MASK_DIST, dtype=torch.float32,
                       device=dev)
    run_i = torch.full((b, k_pad), -1, dtype=torch.int32, device=dev)
    if b == 0 or u == 0:
        return run_d, run_i
    uc = max(1, min(u, SCRATCH_BYTES // (b * k_pad * 8)))
    part_d = torch.empty((b, uc, k_pad), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, uc, k_pad), dtype=torch.int32, device=dev)
    kind = "bf16" if data.dtype == torch.bfloat16 else "f32"
    ws, gbuf, blocks, where = _grouped_scratch(kind, d, b, u, uc, k_pad,
                                               dev, design(queries, data))
    nrows = live_rows(valid)
    order = slot_order(sel, nrows, uc)
    if where & TILED:
        tracing.count("scan.tiled")
    if dev.type == "meta":
        build.META_WORK.add("scan_topk_indexed", *work(
            b, u, s, d, k_pad, data.element_size()), build.F32_FLOPS_PER_S)
        return run_d, run_i
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.lib("scan_topk_indexed").scan_indexed(
        queries.data_ptr(), data.data_ptr(), valid.data_ptr(),
        nrows.data_ptr(), sel.data_ptr(), qmask.data_ptr(),
        order.data_ptr(), ws.data_ptr(),
        part_d.data_ptr(), part_i.data_ptr(),
        None if gbuf is None else gbuf.data_ptr(), run_d.data_ptr(),
        run_i.data_ptr(), b, u, s, d, k_pad, uc, blocks, where,
        int(data.dtype == torch.bfloat16), int(metric == "l2"), stream)
    build.check_launch(err, "scan_topk_indexed")
    LAUNCHES.add()
    if where & TILED:
        LAUNCHES_TILED.add()
    return run_d, run_i


def scan_topk_indexed(queries: Tensor, data: Tensor, valid: Tensor,
                      sel: Tensor, qmask: Tensor, *, k_pad: int,
                      metric: str = "l2") -> Tuple[Tensor, Tensor]:
    """The kernel for CUDA tensors (and meta ones inside
    ``build.card_route_on_meta``), its plain version for CPU tensors."""
    if build.card_route(data):
        return scan_topk_indexed_cuda(queries, data, valid, sel, qmask,
                                      k_pad=k_pad, metric=metric)
    if data.device.type != "cpu":
        raise ValueError(f"unsupported device {data.device}")
    return scan_topk_indexed_plain(queries, data, valid, sel, qmask,
                                   k_pad=k_pad, metric=metric)


# ---------------------------------------------------------------------------
# int8 codes
# ---------------------------------------------------------------------------

def scan_topk_indexed_q8_plain(q_codes: Tensor, q_scales: Tensor,
                               codes: Tensor, scales: Tensor, aux: Tensor,
                               qc: Tensor, valid: Tensor, sel: Tensor,
                               qmask: Tensor, *, k_pad: int,
                               metric: str = "l2") -> Tuple[Tensor, Tensor]:
    """The int8 kernel's function in plain PyTorch: the oracle
    ``ref.scan_indexed_q8_ref`` over the union in partition order (equal
    distances keep the smaller flat index), padded to ``k_pad``."""
    _check_k_pad(k_pad)
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric: {metric}")
    order = torch.argsort(sel.long(), stable=True)
    d, i = ref.scan_indexed_q8_ref(
        q_codes, q_scales, codes, scales, aux, qc[:, order], valid,
        sel.long()[order], qmask[:, order], k_pad, metric)
    return ref.pad_topk(d, i, k_pad)


def scan_topk_indexed_q8_cuda(q_codes: Tensor, q_scales: Tensor,
                              codes: Tensor, scales: Tensor, aux: Tensor,
                              qc: Tensor, valid: Tensor, sel: Tensor,
                              qmask: Tensor, *, k_pad: int,
                              metric: str = "l2") -> Tuple[Tensor, Tensor]:
    """Launch the int8 CUDA kernel.  Raises on any operand it does not
    take: the codes' width must be a multiple of 4 (the kernel reads them
    as 32-bit words for ``__dp4a``)."""
    _check_kernel_k_pad(k_pad)
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric: {metric}")
    dev = codes.device
    named = (("q_codes", q_codes, torch.int8), ("q_scales", q_scales,
                                                torch.float32),
             ("codes", codes, torch.int8), ("scales", scales, torch.float32),
             ("aux", aux, torch.float32), ("qc", qc, torch.float32),
             ("valid", valid, torch.bool), ("sel", sel, torch.int32),
             ("qmask", qmask, torch.bool))
    for name, t, dtype in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, codes on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
        if t.dtype != dtype:
            raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if dev.type not in ("cuda", "meta"):
        raise ValueError("scan_topk_indexed_q8_cuda needs CUDA (or meta) "
                         "tensors")
    p, s, d = codes.shape
    b, u = qmask.shape
    if d % 4 or codes.data_ptr() % 4 or q_codes.data_ptr() % 4:
        raise ValueError(f"the codes' width must be a multiple of 4 and "
                         f"word-aligned, got d={d}")
    if (q_codes.shape != (b, d) or q_scales.shape != (b,)
            or scales.shape != (p, s) or aux.shape != (p, s)
            or valid.shape != (p, s) or qc.shape != (b, u)
            or sel.shape != (u,)):
        raise ValueError(
            f"shapes disagree: q_codes {tuple(q_codes.shape)}, codes "
            f"{tuple(codes.shape)}, scales {tuple(scales.shape)}, aux "
            f"{tuple(aux.shape)}, qc {tuple(qc.shape)}, sel "
            f"{tuple(sel.shape)}, qmask {tuple(qmask.shape)}")
    if p * s >= 2 ** 31:
        raise ValueError("flat indices P*S must fit in int32")
    run_d = torch.full((b, k_pad), MASK_DIST, dtype=torch.float32,
                       device=dev)
    run_i = torch.full((b, k_pad), -1, dtype=torch.int32, device=dev)
    if b == 0 or u == 0:
        return run_d, run_i
    uc = max(1, min(u, SCRATCH_BYTES // (b * k_pad * 8)))
    part_d = torch.empty((b, uc, k_pad), dtype=torch.float32, device=dev)
    part_i = torch.empty((b, uc, k_pad), dtype=torch.int32, device=dev)
    ws, gbuf, blocks, where = _grouped_scratch("q8", d, b, u, uc, k_pad,
                                               dev)
    nrows = live_rows(valid)
    order = slot_order(sel, nrows, uc)
    if dev.type == "meta":
        build.META_WORK.add("scan_topk_indexed_q8", *work(
            b, u, s, d, k_pad, 1, q8=True), build.INT8_OPS_PER_S)
        return run_d, run_i
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.lib("scan_topk_indexed_q8").scan_indexed_q8(
        q_codes.data_ptr(), q_scales.data_ptr(), codes.data_ptr(),
        scales.data_ptr(), aux.data_ptr(), qc.data_ptr(), valid.data_ptr(),
        nrows.data_ptr(), sel.data_ptr(), qmask.data_ptr(),
        order.data_ptr(), ws.data_ptr(),
        part_d.data_ptr(), part_i.data_ptr(),
        None if gbuf is None else gbuf.data_ptr(), run_d.data_ptr(),
        run_i.data_ptr(), b, u, s, d, k_pad, uc, blocks,
        int(bool(where & QUERY_CHUNKS)), int(metric == "l2"), stream)
    build.check_launch(err, "scan_topk_indexed_q8")
    LAUNCHES_Q8.add()
    return run_d, run_i


def scan_topk_indexed_q8(q_codes: Tensor, q_scales: Tensor, codes: Tensor,
                         scales: Tensor, aux: Tensor, qc: Tensor,
                         valid: Tensor, sel: Tensor, qmask: Tensor, *,
                         k_pad: int, metric: str = "l2"
                         ) -> Tuple[Tensor, Tensor]:
    """The int8 kernel for CUDA tensors, its plain version for CPU ones."""
    args = (q_codes, q_scales, codes, scales, aux, qc, valid, sel, qmask)
    if build.card_route(codes):
        return scan_topk_indexed_q8_cuda(*args, k_pad=k_pad, metric=metric)
    if codes.device.type != "cpu":
        raise ValueError(f"unsupported device {codes.device}")
    return scan_topk_indexed_q8_plain(*args, k_pad=k_pad, metric=metric)

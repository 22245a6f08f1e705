"""Dense scan + top-k: the APS planner's centroid pass, the cost model's
profile and per-query partition scans.

Replaces the JAX package's ``scan_topk_pallas``.  For Q queries against
N rows it returns the ascending top-``k_pad`` of ``||x||^2 + bias - 2 q.x``
(L2) or ``bias - q.x`` (IP), ``bias`` = MASK_DIST on invalid rows, with
row indices; ``||q||^2`` is left to the caller.  Equal distances keep the
smaller row index; misses are MASK_DIST with index -1.

``scan_topk`` launches the CUDA kernel (``csrc/scan_topk.cu``) for CUDA
tensors and runs the plain version beside it for CPU tensors.  The
kernel has two designs, and ``design`` picks one by the number of
queries:

- ``"tiles"`` (batches): a register-tiled f32 GEMM over tiles of 32
  queries x 128 rows with the top-K as its epilogue; row tiles are split
  over blocks as far as the card needs (``tiles_plan``), and a second
  kernel folds the splits.
- ``"rows"`` (fewer than ``CROSSOVER_Q`` queries): the rows split over
  the warps of a few blocks, read 16 bytes a lane; one launch in all,
  whose last block folds the blocks' lists (``rows_plan``).

Every ``k_pad`` up to ``K_MAX`` runs on the kernel; past what shared
memory holds, the top-K buffers live in a global scratch.
"""
from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from . import build, ref
from .scan_topk_indexed import K_MAX, TOPK_SCRATCH_BYTES, buffer_size

Tensor = torch.Tensor

LAUNCHES = build.LaunchCounter("scan_topk")
# Queries below which the row scan ("rows") beats the tiled GEMM
# ("tiles"), from both designs' device times at Q = 1-16 x N = 1,000 and
# 16,384 x d = 128, k_pad 16 and 128, on an H100 80GB HBM3 at 700 W:
# "rows" faster at Q <= 2 at every shape, about even at Q = 3, "tiles"
# faster from Q = 4 on (chip_smoke.py prints the table: its "crossover"
# rows).
CROSSOVER_Q = 3
WARPS = 8                        # warps a block, both designs
QT, RT = 32, 128                 # "tiles": queries x rows of a block tile
BLOCKS_PER_SM = 2                # "tiles": blocks an SM the split aims at
TILE_BUF_SMEM = 64 << 10         # "tiles": top-K buffers kept in smem
ROWS_PER_WARP = 32               # "rows": fewest rows a warp takes
ROW_BUF_SMEM = 128 << 10         # "rows": top-K buffers kept in smem
MERGE_BYTES = 64 << 10           # "rows": the last block's lists
TILE_MERGE_ENTRIES = 12288       # "tiles": splits x k_pad the merge folds
SCRATCH_BYTES = 256 << 20        # "tiles": bound on the split lists


def scan_topk_plain(queries: Tensor, xs: Tensor,
                    valid: Optional[Tensor] = None, *, k_pad: int,
                    metric: str = "l2") -> Tuple[Tensor, Tensor]:
    """The kernel's function in plain PyTorch: the oracle
    ``ref.scan_topk_ref`` with queries in the storage type of ``xs``,
    products in f32, without ``||q||^2``, padded to ``k_pad`` columns."""
    if k_pad < 1 or k_pad & (k_pad - 1):
        raise ValueError(f"k_pad must be a power of two, got {k_pad}")
    d, i = ref.scan_topk_ref(queries.to(xs.dtype).float(), xs.float(),
                             k_pad, metric, valid, with_q2=False)
    return ref.pad_topk(d, i, k_pad)


def design(q: int) -> str:
    """The kernel design for ``q`` queries: ``"rows"`` below
    ``CROSSOVER_Q``, else ``"tiles"``."""
    return "rows" if q < CROSSOVER_Q else "tiles"


def tiles_plan(q: int, n: int, k_pad: int, sms: int) -> Dict[str, int]:
    """Launch plan of the "tiles" design: QT-query tiles, row tiles cut
    into ``splits`` of ``tiles_per_split`` each, as many as keep the
    resident blocks (BLOCKS_PER_SM an SM) in one wave, the second
    kernel's fold within TILE_MERGE_ENTRIES and the split lists under
    SCRATCH_BYTES; ``grid`` blocks; ``gbuf`` entries of global top-K
    buffers (0: they stay in shared memory) and ``part`` entries of split
    lists (each a distance and an index)."""
    qtiles, rtiles = -(-q // QT), -(-n // RT)
    most = min(max(1, BLOCKS_PER_SM * sms // qtiles),
               max(1, TILE_MERGE_ENTRIES // k_pad),
               max(1, SCRATCH_BYTES // (q * k_pad * 8)))
    per = -(-rtiles // most)
    splits = -(-rtiles // per)
    items = qtiles * splits
    per_block = QT * buffer_size(k_pad) * 8
    glob = per_block > TILE_BUF_SMEM
    grid = min(items, max(1, TOPK_SCRATCH_BYTES // per_block)) if glob \
        else items
    return {"splits": splits, "tiles_per_split": per,
            "grid": grid, "gbuf": grid * per_block // 4 if glob else 0,
            "part": 2 * q * splits * k_pad if splits > 1 else 0}


def rows_plan(q: int, n: int, k_pad: int, sms: int) -> Dict[str, int]:
    """Launch plan of the "rows" design: ``blocks`` of WARPS warps, each
    warp ``rows_per_warp`` rows (a multiple of 32, at least
    ROWS_PER_WARP unless N is smaller); no more blocks than SMs or than
    the last block's merge holds (MERGE_BYTES of lists).  ``gbuf`` and
    ``part`` (each block's lists) as in ``tiles_plan``."""
    want = -(-n // (WARPS * ROWS_PER_WARP))
    blocks = max(1, min(want, sms, MERGE_BYTES // (k_pad * 8)))
    rows = -(-n // (blocks * WARPS * 32)) * 32
    blocks = -(-n // (rows * WARPS))
    per_block = WARPS * buffer_size(k_pad) * 8
    return {"blocks": blocks, "rows_per_warp": rows,
            "gbuf": blocks * per_block // 4 if per_block > ROW_BUF_SMEM
            else 0,
            "part": 2 * q * blocks * k_pad if blocks > 1 else 0}


@functools.lru_cache(maxsize=None)
def _sm_count(dev: torch.device) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


_WORKSPACE: Dict[Tuple[torch.device, int], Tensor] = {}


def _workspace(dev: torch.device, stream: int, n: int) -> Tensor:
    """The "rows" design's workspace for the launches on ``stream``: word
    0 its ticket (0 between launches: the last block resets it), then at
    least ``n`` words of scratch that every launch on the stream reuses in
    turn.  Made once per device and stream, and again when more is
    needed, so a call allocates only its outputs."""
    ws = _WORKSPACE.get((dev, stream))
    if ws is None or ws.numel() < n + 1:
        ws = _WORKSPACE[(dev, stream)] = torch.zeros(
            max(n + 1, 4096), dtype=torch.int32, device=dev)
    return ws


def scan_topk_cuda(queries: Tensor, xs: Tensor,
                   valid: Optional[Tensor] = None, *, k_pad: int,
                   metric: str = "l2") -> Tuple[Tensor, Tensor]:
    """Launch the CUDA kernel.  Raises on any operand it does not take."""
    if k_pad < 1 or k_pad & (k_pad - 1) or k_pad > K_MAX:
        raise ValueError(f"k_pad must be a power of two <= K_MAX = "
                         f"{K_MAX}, got {k_pad}")
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric: {metric}")
    dev = xs.device
    if dev.type != "cuda":
        raise ValueError("scan_topk_cuda needs CUDA tensors")
    if xs.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"xs must be f32 or bf16, got {xs.dtype}")
    if queries.dtype != xs.dtype:
        raise ValueError("queries must be in the storage type of xs")
    n, d = xs.shape
    q = queries.shape[0]
    if queries.shape != (q, d):
        raise ValueError(f"queries {tuple(queries.shape)} vs xs "
                         f"{tuple(xs.shape)}")
    for name, t in (("queries", queries), ("xs", xs), ("valid", valid)):
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xs on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != (n,)):
        raise ValueError("valid must be a bool (N,) mask")
    if n >= 2 ** 31:
        raise ValueError("row indices must fit in int32")
    if q == 0 or n == 0:
        return ref.pad_topk(torch.empty((q, 0), device=dev),
                            torch.empty((q, 0), dtype=torch.int32,
                                        device=dev), k_pad)
    out_d = torch.empty((q, k_pad), dtype=torch.float32, device=dev)
    out_i = torch.empty((q, k_pad), dtype=torch.int32, device=dev)
    stream = torch._C._cuda_getCurrentRawStream(dev.index)
    rows = design(q) == "rows"
    plan = (rows_plan if rows else tiles_plan)(q, n, k_pad, _sm_count(dev))
    half, glob = plan["part"] // 2, plan["gbuf"]
    ticket = base = None
    if rows and half:              # word 0 the ticket, then the scratch
        ticket = _workspace(dev, stream, plan["part"] + glob).data_ptr()
        base = ticket + 4
    elif plan["part"] + glob:      # held until the launch is enqueued
        scratch = torch.empty(plan["part"] + glob, dtype=torch.int32,
                              device=dev)
        base = scratch.data_ptr()
    ptrs = (queries.data_ptr(), xs.data_ptr(),
            None if valid is None else valid.data_ptr(),
            base if half else None, base + 4 * half if half else None,
            base + 4 * plan["part"] if glob else None)
    outs = (out_d.data_ptr(), out_i.data_ptr())
    kern = build.lib("scan_topk")
    is_bf16, l2 = int(xs.dtype == torch.bfloat16), int(metric == "l2")
    # rows of whole 16-byte units: the kernels copy and load 16 bytes
    vec = int(xs.data_ptr() % 16 == 0 and queries.data_ptr() % 16 == 0
              and d * xs.element_size() % 16 == 0)
    if rows:
        err = kern.scan_dense_rows(
            *ptrs, ticket, *outs, q, n, d, k_pad, plan["blocks"],
            plan["rows_per_warp"], vec, is_bf16, l2, stream)
    else:
        err = kern.scan_dense_tiles(
            *ptrs, *outs, q, n, d, k_pad, plan["splits"],
            plan["tiles_per_split"], plan["grid"], vec, is_bf16, l2, stream)
    build.check_launch(err, "scan_topk")
    LAUNCHES.add()
    return out_d, out_i


def scan_topk(queries: Tensor, xs: Tensor, valid: Optional[Tensor] = None,
              *, k_pad: int, metric: str = "l2") -> Tuple[Tensor, Tensor]:
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if xs.is_cuda:
        return scan_topk_cuda(queries, xs, valid, k_pad=k_pad,
                              metric=metric)
    if xs.device.type != "cpu":
        raise ValueError(f"unsupported device {xs.device}")
    return scan_topk_plain(queries, xs, valid, k_pad=k_pad, metric=metric)

"""Dense scan + top-k: the APS planner's centroid pass.

Replaces the JAX package's ``scan_topk_pallas``.  For Q queries against
N rows it returns the ascending top-``k_pad`` of ``||x||^2 + bias - 2 q.x``
(L2) or ``bias - q.x`` (IP), ``bias`` = MASK_DIST on invalid rows, with
row indices; ``||q||^2`` is left to the caller.  Equal distances keep the
smaller row index; misses are MASK_DIST with index -1.

``scan_topk`` launches the CUDA kernel (``csrc/scan_topk.cu``, which
shares its top-K code with the indexed scans) for CUDA tensors and runs
the plain version beside it for CPU tensors.  Every ``k_pad`` up to
``K_MAX`` runs on the kernel; past ``K_SMEM`` each warp's top-K buffer
lives in a global scratch the wrapper allocates.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import build, ref
from .ref import MASK_DIST
from .scan_topk_indexed import K_MAX, TOPK_SCRATCH_BYTES, buffer_size

Tensor = torch.Tensor

LAUNCHES = build.LaunchCounter("scan_topk")
CHUNK_ROWS = 256             # rows per pass-one block (raised for huge N)
SCRATCH_BYTES = 256 << 20    # bound on the (Q, chunks, k_pad) partial lists
K_SMEM = 1024                # larger k_pad keeps its buffers in global memory
WARPS = 8                    # queries per pass-one block


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
    named = [("queries", queries), ("xs", xs)]
    if valid is not None:
        named.append(("valid", valid))
    for name, t in named:
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, xs on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xs.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"xs must be f32 or bf16, got {xs.dtype}")
    if queries.dtype != xs.dtype:
        raise ValueError("queries must be in the storage type of xs")
    n, d = xs.shape
    q = queries.shape[0]
    if queries.shape != (q, d):
        raise ValueError(f"queries {tuple(queries.shape)} vs xs "
                         f"{tuple(xs.shape)}")
    if valid is not None and (valid.dtype != torch.bool
                              or valid.shape != (n,)):
        raise ValueError("valid must be a bool (N,) mask")
    if n >= 2 ** 31:
        raise ValueError("row indices must fit in int32")
    out_d = torch.full((q, k_pad), MASK_DIST, dtype=torch.float32,
                       device=dev)
    out_i = torch.full((q, k_pad), -1, dtype=torch.int32, device=dev)
    if q == 0 or n == 0:
        return out_d, out_i
    max_chunks = max(1, SCRATCH_BYTES // (q * k_pad * 8))
    rows = max(CHUNK_ROWS, -(-n // max_chunks))
    gbuf, blocks = None, 0
    if k_pad > K_SMEM:
        # a block's buffers in global memory: at least one row block of
        # k_pad rows, and few enough row blocks that one query tile's
        # buffers fit the scratch bound
        per_block = WARPS * buffer_size(k_pad) * 8
        fit = max(1, TOPK_SCRATCH_BYTES // per_block)
        rows = max(rows, k_pad, -(-n // fit))
        n_chunks = -(-n // rows)
        blocks = max(n_chunks, min(n_chunks * -(-q // WARPS), fit))
        gbuf = torch.empty(blocks * per_block // 4, dtype=torch.float32,
                           device=dev)
    n_chunks = -(-n // rows)
    part_d = torch.empty((q, n_chunks, k_pad), dtype=torch.float32,
                         device=dev)
    part_i = torch.empty((q, n_chunks, k_pad), dtype=torch.int32,
                         device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.lib("scan_topk").scan_dense(
        queries.data_ptr(), xs.data_ptr(),
        None if valid is None else valid.data_ptr(),
        part_d.data_ptr(), part_i.data_ptr(),
        None if gbuf is None else gbuf.data_ptr(), out_d.data_ptr(),
        out_i.data_ptr(), q, n, d, rows, k_pad, blocks,
        int(xs.dtype == torch.bfloat16), int(metric == "l2"), stream)
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

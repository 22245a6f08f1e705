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
beside it for CPU tensors.

The int8 variant ``scan_topk_indexed_q8`` (``csrc/scan_topk_indexed_q8.cu``,
replacing ``scan_topk_indexed_q8_pallas``) scans IVF-residual int8 codes:
the int8 product is dequantized with per-query and per-row scales and the
exact query-centroid term ``qc`` (``ref.scan_indexed_q8_ref`` states the
formula).  ``quantize_int8`` / ``quantize_int8_residual`` make the codes.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import build, ref
from .ref import MASK_DIST, quantize_int8, quantize_int8_residual

__all__ = ["K_MAX", "LAUNCHES", "LAUNCHES_Q8", "live_rows",
           "quantize_int8", "quantize_int8_residual", "scan_topk_indexed",
           "scan_topk_indexed_cuda", "scan_topk_indexed_plain",
           "scan_topk_indexed_q8", "scan_topk_indexed_q8_cuda",
           "scan_topk_indexed_q8_plain"]

Tensor = torch.Tensor

LAUNCHES = build.LaunchCounter("scan_topk_indexed")
LAUNCHES_Q8 = build.LaunchCounter("scan_topk_indexed_q8")
K_MAX = 1024                 # largest k_pad the kernel's buffers take
SCRATCH_BYTES = 256 << 20    # bound on the (B, Uc, k_pad) partial lists


def _check_k_pad(k_pad: int) -> None:
    if k_pad < 1 or k_pad & (k_pad - 1):
        raise ValueError(f"k_pad must be a power of two, got {k_pad}")


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
    _check_k_pad(k_pad)
    if k_pad > K_MAX:
        raise ValueError(f"k_pad {k_pad} exceeds the kernel's {K_MAX}")
    if metric not in ("l2", "ip"):
        raise ValueError(f"unknown metric: {metric}")
    dev = data.device
    for name, t in (("queries", queries), ("data", data), ("valid", valid),
                    ("sel", sel), ("qmask", qmask)):
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, data on {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if dev.type != "cuda":
        raise ValueError("scan_topk_indexed_cuda needs CUDA tensors")
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
    nrows = live_rows(valid)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.lib("scan_topk_indexed").scan_indexed(
        queries.data_ptr(), data.data_ptr(), valid.data_ptr(),
        nrows.data_ptr(), sel.data_ptr(), qmask.data_ptr(),
        part_d.data_ptr(), part_i.data_ptr(), run_d.data_ptr(),
        run_i.data_ptr(), b, u, s, d, k_pad, uc,
        int(data.dtype == torch.bfloat16), int(metric == "l2"), stream)
    build.check_launch(err, "scan_topk_indexed")
    LAUNCHES.add()
    return run_d, run_i


def scan_topk_indexed(queries: Tensor, data: Tensor, valid: Tensor,
                      sel: Tensor, qmask: Tensor, *, k_pad: int,
                      metric: str = "l2") -> Tuple[Tensor, Tensor]:
    """The kernel for CUDA tensors, its plain version for CPU tensors."""
    if data.is_cuda:
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
    _check_k_pad(k_pad)
    if k_pad > K_MAX:
        raise ValueError(f"k_pad {k_pad} exceeds the kernel's {K_MAX}")
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
    if dev.type != "cuda":
        raise ValueError("scan_topk_indexed_q8_cuda needs CUDA tensors")
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
    nrows = live_rows(valid)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = build.lib("scan_topk_indexed_q8").scan_indexed_q8(
        q_codes.data_ptr(), q_scales.data_ptr(), codes.data_ptr(),
        scales.data_ptr(), aux.data_ptr(), qc.data_ptr(), valid.data_ptr(),
        nrows.data_ptr(), sel.data_ptr(), qmask.data_ptr(),
        part_d.data_ptr(), part_i.data_ptr(), run_d.data_ptr(),
        run_i.data_ptr(), b, u, s, d, k_pad, uc, int(metric == "l2"),
        stream)
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
    if codes.is_cuda:
        return scan_topk_indexed_q8_cuda(*args, k_pad=k_pad, metric=metric)
    if codes.device.type != "cpu":
        raise ValueError(f"unsupported device {codes.device}")
    return scan_topk_indexed_q8_plain(*args, k_pad=k_pad, metric=metric)

"""The plain reference that decides ``correct``: exact k-NN in PyTorch over
the rows the harness made, and the comparison of the program's answers
against it.  It imports nothing of the port and takes no state from it:
the program's answers are only judged here."""
from __future__ import annotations

import contextlib
from typing import Dict

import torch


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 values rounded to TF32's 10-bit mantissa (to nearest, ties
    away), as the tensor cores read their inputs in TF32 mode."""
    i = t.contiguous().view(torch.int32)
    r = (i + 0x1000) & ~0x1FFF
    return r.view(torch.float32)


@contextlib.contextmanager
def matmul_precision(tf32: bool):
    """TF32 off (the configurations' f32) or on (the control)."""
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


def _dot(q: torch.Tensor, x: torch.Tensor, tf32: bool) -> torch.Tensor:
    if tf32 and q.device.type != "cuda":
        return tf32_round(q) @ tf32_round(x).T
    with matmul_precision(tf32):
        return q @ x.T


def exact_topk(queries: torch.Tensor, rows: torch.Tensor, k: int,
               tf32: bool = False, block: int = 256):
    """(dists (Q, k) f32, ids (Q, k) int64) of each query's k nearest
    rows by squared L2, ascending.  f32 with TF32 off; ``tf32=True``
    computes the dot products in TF32 (the control)."""
    x2 = (rows * rows).sum(1)
    out_d, out_i = [], []
    for j0 in range(0, queries.shape[0], block):
        q = queries[j0:j0 + block]
        d = x2[None, :] - 2.0 * _dot(q, rows, tf32)
        dd, ii = torch.topk(d, k, dim=1, largest=False, sorted=True)
        out_d.append(torch.clamp(dd + (q * q).sum(1, keepdim=True), min=0))
        out_i.append(ii)
    return torch.cat(out_d), torch.cat(out_i).long()


def judge(ids: torch.Tensor, dists: torch.Tensor, queries: torch.Tensor,
          rows: torch.Tensor, want: torch.Tensor, block: int = 1024) -> Dict[str, torch.Tensor]:
    """Judge answers (ids (Q, k), dists (Q, k), misses -1 / inf) to
    ``queries`` against ``rows`` and the exact top-k ``want`` (Q, k).  Returns per-block sums on the device:

    * ``dist_gap``: the largest |answered - exact| squared distance of an
      answered row, over ||q||^2 + ||x||^2 (f64, difference form);
    * ``bad_ids``: answered ids that are out of range, a repeat within the
      row, or have no finite distance (a miss,
      id -1, is no answer: it costs recall);
    * ``empty``: rows with no answer at all;
    * ``unsorted``: rows whose distances are not ascending;
    * ``recall``: the summed recall@k of the rows."""
    n = rows.shape[0]
    k = want.shape[1]
    gap = torch.zeros((), dtype=torch.float64, device=rows.device)
    bad = torch.zeros((), dtype=torch.int64, device=rows.device)
    unsorted = torch.zeros((), dtype=torch.int64, device=rows.device)
    empty = torch.zeros((), dtype=torch.int64, device=rows.device)
    recall = torch.zeros((), dtype=torch.float64, device=rows.device)
    for j0 in range(0, ids.shape[0], block):
        i = ids[j0:j0 + block]
        dd = dists[j0:j0 + block].double()
        q = queries[j0:j0 + block].double()
        miss = i < 0
        ok = (i >= 0) & (i < n)
        safe = torch.where(ok, i, torch.zeros_like(i))
        srt, _ = torch.sort(i, dim=1)
        rep = torch.zeros_like(ok)
        rep[:, 1:] = (srt[:, 1:] == srt[:, :-1]) & (srt[:, 1:] >= 0)
        ok &= torch.isfinite(dd)
        bad += (~ok & ~miss).sum() + rep.sum()
        empty += miss.all(1).sum()
        xr = rows[safe].double()
        exact = ((xr - q[:, None, :]) ** 2).sum(-1)
        scale = (xr * xr).sum(-1) + (q * q).sum(-1, keepdim=True)
        g = torch.where(ok, (dd - exact).abs() / scale,
                        torch.zeros_like(exact))
        gap = torch.maximum(gap, g.max())
        fin = torch.where(torch.isfinite(dd), dd,
                          torch.full_like(dd, float("inf")))
        unsorted += (fin[:, 1:] < fin[:, :-1]).any(1).sum()
        w = want[j0:j0 + block]
        hit = ((i[:, :, None] == w[:, None, :]) & (w[:, None, :] >= 0))
        recall += hit.any(1).sum(1).double().sum() / k
    return {"dist_gap": gap, "bad_ids": bad, "unsorted": unsorted,
            "empty": empty, "recall": recall}

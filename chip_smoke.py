#!/usr/bin/env python3
"""Drive the PyTorch port's paths on one NVIDIA GPU and check them.

    python3 chip_smoke.py [--n 1000000] [--batch 1024] [--seed 0]
                          [--wiki-n 1000000] [--months 12]
                          [--serve-months 12]

With no arguments it runs five paths, each with the kernels' launch
counts set to 0 just before it and read just after:

1. The main path, the SIFT1M-shaped cell: 1,000,000 clustered synthetic
   vectors of d=128 (L2; a mixture of 8192 Gaussian clusters with sizes
   proportional to i^-0.5, about eight clusters per partition),
   ``QuakeIndex.build`` with P = sqrt(n) = 1000 partitions,
   ``search_batch`` of B=1024 queries at k=100 and recall target 0.9 (the
   vectorized planner, the fused planner, ``nprobe=32, rounds=1`` and
   bf16 storage), an insert burst of 10,000 vectors and 5,000 deletes,
   and a search again.
2. int8 serving on the same index: APS rounds and ``nprobe=32,
   rounds=1`` through the int8 executor (IVF-residual codes, the q8 scan
   kernel, exact re-rank of the top-2k), then a second insert/delete
   burst that the int8 executor must serve by a full rebuild.
3. The dynamic loop (paper Fig. 4): the Wikipedia-style workload at
   ``--wiki-n`` vectors of d=128 (inner product; its generator's 12
   months), a latency model profiled on the card (device time per query
   of a B-query scan, with the paper's tau rescaled to it), and per
   month the insert burst, per-query APS searches that record access
   statistics, ``Maintainer.run()``, the index invariants, and one
   batched search through the f32 and the int8 executors, held against
   the exact ground truth.  Each month also reports the pass that the
   single-query latency model would make on the same statistics, rolled
   back after it.
4. Online serving (``launch/serve.replay_runtime``) of the same
   Wikipedia-style workload at ``--wiki-n`` vectors (its first
   ``--serve-months`` months of inserts and 1024 queries; the generator
   makes no deletes): ``ServingRuntime`` with k=10 at recall target 0.9,
   the fused planner (its centroid pass on the card, through the dense
   scan kernel), flushes of 256 queries or after 5 ms (the deadline
   ticker), the
   result cache, drift-triggered maintenance under the default
   triggers, metrics, ``scan_backend="auto"`` (the device rounds on the
   card) and a WAL with checkpoints under a temporary directory
   (``fsync="batch"``).  Then the admission groups after the last write
   replayed through both scan backends (the same ids), one warm flush
   under ``torch.profiler``, those queries again at int8 storage (the q8
   kernel), one more insert burst through a runtime re-attached to the
   WAL directory, and ``ServingRuntime.recover`` on that directory (it
   must replay the insert and land on the live fingerprint).  The
   kernels are held against their plain versions on this path's own
   operands: the largest insert burst's assignment, the largest
   centroid pass, and up to four rounds of each indexed scan (the q8
   scan bit-equal).  It prints recall@10 per month, latency,
   throughput, rounds and riders, cache, maintenance, durability and
   recovery numbers beside the card's name and power limit.
5. LM serving (``LM_CONFIG``, qwen2.5-14b), after the
   Quake paths' tensors are freed.  First exact f32 checks at full width
   and two layers: prefill logits with the flash kernel against the
   plain attention, and decode at position t against a re-prefill over
   t + 1 tokens.  Then the served model at full width and depth in bf16
   from seeded random weights: ``prefill`` of 4 prompts of 4,096 seeded
   tokens, 32 greedy ``decode_step``s into a cache padded to 4,096 + 32,
   gates of 48 flash launches per prefill and none per decode step, the
   flash kernel's share of a warm prefill's device time, and decode step
   8 against a re-prefill of the prompts and their first 8 tokens
   (printed, ungated).  The kernel is held against its plain version at
   layers 0 and 47's operands and the JAX tests' f32 shapes, and timed
   at one request of ``LM_TIME_LEN`` tokens (prefill_32k's).

It then holds each CUDA kernel against its plain PyTorch version at the
shapes the paths gave it, times both and a one-library-call yardstick,
profiles one warm ``search_batch``, and prints one JSON line of kernels,
the card's name and power limit, and a last JSON line with the device.
The dense scan is held and timed at each of its callers' shapes (the
centroid pass, the latency profile at the serving batch and at one
query, one-query partition probes), beside an empty kernel's launch, the
kernels one one-query call launches (one, and no memset), both of its
designs' times around their crossover and one per-query probe split
into its copy in, scan and pull-back.

It exits non-zero, printing no result, when CUDA is unavailable or the
port is not beside it, and on any failed check.  Detailed records go to
``chiprun_out/chip_smoke/``.
"""
from __future__ import annotations

import argparse
import contextlib
import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
OUT_DIR = ROOT / "chiprun_out" / "chip_smoke"

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
# kernel vs plain: |diff| <= TOL_REL * |d| + TOL_ABS per entry, the f32
# rounding of the same dot products summed in another order.  The kernels'
# distances leave ||q||^2 out, so |d| is about ||x||^2 (~5e3 here) and the
# bound about 0.06, well under the gap between neighbouring entries.
TOL_REL, TOL_ABS = 1e-5, 1e-2
BF16_RECALL = 0.8             # bf16 vs f32 id overlap (the JAX tests' bar)
APS_RECALL_MIN = 0.85         # recall@100 of the APS path at target 0.9
INT8_OVERLAP = 0.85           # int8 vs f32 id overlap (the JAX tests' bar)
INT8_OPS_PER_S = 1979e12      # H100 SXM dense int8 (the bound of the q8 scan)
BF16_FLOPS_PER_S = 989e12     # H100 SXM dense bf16 (the bound of attention)
# flash kernel vs its plain version, per entry: f32 within
# FLASH_F32_TOL * |o| + FLASH_F32_TOL (tests/test_kernels.py's bound for
# the TPU kernel); bf16 within one bf16 ulp of the output, 2^-7 * |o|, plus
# 1e-3 (a score that differs in its last f32 bit can round p the other way)
FLASH_F32_TOL = 2e-5
FLASH_BF16_REL, FLASH_BF16_ABS = 2.0 ** -7, 1e-3
# f32 LM logits (kernel vs plain attention, decode vs re-prefill): within
# LM_TOL * |x| + LM_TOL (tests/test_kernels.py's prefill bound)
LM_TOL = 1e-4
# the LM path: a config of repro_torch.configs.lm_archs at its full width
# and depth; prompts x tokens, greedy decode steps; the tokens of the one
# request at which the kernel is timed (prefill_32k's request)
LM_CONFIG = "qwen25_14b"
LM_PROMPTS, LM_PROMPT_LEN, LM_DECODE = 4, 4096, 32
LM_TIME_LEN = 32768
# the serving path: k, recall target, the planner (the fused one plans on
# the card: its centroid pass is the dense scan kernel; the vectorized
# one plans in host numpy), and the near-tie allowance of its host/device
# agreement (two f32 scans that sum in another order; a differing id must
# lie within 2 * (REL * |kth| + ABS) of the k-th exact distance)
SERVE_K, SERVE_TARGET, SERVE_PLANNER = 10, 0.9, "fused"
SERVE_TIE_REL, SERVE_TIE_ABS = 1e-5, 1e-5
# the serving rounds held against the plain versions: at most this many
# per scan, each one whose plain version's gather of the union (its rows
# in the storage type and widened to f32) fits in this many bytes
SERVE_CHECK_ROUNDS, SERVE_PLAIN_BYTES = 4, 16e9


def fail(msg: str) -> None:
    print(f"chip_smoke: FAILED: {msg}", file=sys.stderr)
    raise SystemExit(1)


def parse_args():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--batch", type=int, default=1024)
    ap.add_argument("--k", type=int, default=100)
    ap.add_argument("--insert", type=int, default=10_000)
    ap.add_argument("--delete", type=int, default=5_000)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clusters", type=int, default=8192)
    ap.add_argument("--power", type=float, default=0.5)
    ap.add_argument("--wiki-n", type=int, default=1_000_000)
    ap.add_argument("--months", type=int, default=12)
    ap.add_argument("--month-queries", type=int, default=512,
                    help="per-query searches per month (access statistics)")
    ap.add_argument("--serve-months", type=int, default=12,
                    help="months of the workload the serving path replays")
    return ap.parse_args()


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if out.returncode != 0:
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def timed(fn):
    """(fn(), its device time in ms) for one call."""
    import torch
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def median_ms(*fns, rounds: int = 5):
    """``cuda_ms`` of each of ``fns``, the median over ``rounds`` rounds
    that take the functions in turn: in a long process a collection or a
    page fault on the host lands in one window of 10 calls, not in the
    median, and the functions compared share the host's state."""
    import statistics
    gc.collect()
    times = [[] for _ in fns]
    for _ in range(rounds):
        for t, fn in zip(times, fns):
            t.append(cuda_ms(fn))
    return [statistics.median(t) for t in times]


def device_ms(fn, reps: int = 10) -> float:
    """Device time of one call of ``fn``: ``reps`` calls enqueued while a
    spin kernel holds the card (the port's ``cost_model._device_ms``), so
    the CUDA events bracket the card's work and not the wrapper's host
    dispatch, which ``cuda_ms`` also pays once a kernel is shorter."""
    import torch
    from repro_torch.core.cost_model import _device_ms
    fn()
    return _device_ms(fn, reps, torch.device("cuda")) / reps


def recall_at(ids, gt) -> float:
    import numpy as np
    k = gt.shape[1]
    hits = [len(set(a[a >= 0].tolist()) & set(b.tolist())) / k
            for a, b in zip(ids, gt)]
    return float(np.mean(hits))


def compare_topk(name, d_k, i_k, d_p, i_p):
    """Kernel vs plain top-k lists (B, K): every distance within its
    tolerance; away from the k-th distance (whose neighbours outside the
    list are unseen), ids equal position by position wherever the plain
    list has no near-tie, and equal as sets.  Returns (largest |distance
    diff|, largest tolerance)."""
    import torch
    d_k, d_p = d_k.double(), d_p.double()
    real = d_p < 1e37
    if not torch.equal(real, d_k < 1e37):
        fail(f"{name}: kernel and plain disagree on which entries miss")
    tol = torch.where(real, TOL_REL * d_p.abs() + TOL_ABS, 0.0)
    diff = torch.where(real, (d_k - d_p).abs(), 0.0)
    err = float(diff.max()) if diff.numel() else 0.0
    if bool((diff > tol).any()):
        fail(f"{name}: {int((diff > tol).sum())} distances beyond their "
             f"tolerance, max |diff| {err:.3g}")
    kth = torch.where(real, d_p, float("-inf")).max(dim=1,
                                                   keepdim=True).values
    firm = real & (d_p < kth - 2 * tol)
    step = (d_p[:, 1:] - d_p[:, :-1]).abs()
    gap = torch.full_like(d_p, float("inf"))
    gap[:, 1:] = step
    gap[:, :-1] = torch.minimum(gap[:, :-1], step)
    bad = (i_k != i_p) & firm & (gap > 2 * tol)
    if bool(bad.any()):
        b, j = (int(v) for v in torch.nonzero(bad)[0])
        fail(f"{name}: {int(bad.sum())} ids differ away from ties; first at "
             f"query {b}, position {j}: kernel id {int(i_k[b, j])} at "
             f"{float(d_k[b, j])!r}, plain id {int(i_p[b, j])} at "
             f"{float(d_p[b, j])!r}, k-th {float(kth[b, 0])!r}")
    same = i_p[:, :, None] == i_k[:, None, :]
    lost = firm & ~same.any(dim=2)
    extra = real & (d_k < kth - 2 * tol) & ~same.any(dim=1)
    if bool(lost.any()) or bool(extra.any()):
        fail(f"{name}: id sets differ: {int(lost.sum())} ids missing and "
             f"{int(extra.sum())} extra, away from the k-th distance")
    print(f"{name}: ids differ at {int(((i_k != i_p) & real).sum())} of "
          f"{int(real.sum())} positions, all at near-ties")
    return err, float(tol.max()) if tol.numel() else 0.0


def profile_call(fn, what: str = "search_batch",
                   match: str = "") -> dict:
    """Device busy time of one warm call of ``fn`` under torch.profiler,
    beside its wall time, the kernels that took the most device time, and
    the device time of the kernels whose name holds ``match``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t) * 1e3
    rows = []   # kernels only: the ops that launch them repeat their time
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0) or 0.0
        if e.device_type == torch.autograd.DeviceType.CUDA and dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    busy_ms = sum(r[0] for r in rows)
    prof.export_chrome_trace(str(OUT_DIR / f"{what}_trace.json"))
    out = {"wall_ms_profiled": wall_ms,
           "device_busy_ms": busy_ms if rows else None,
           "idle_share": 1.0 - busy_ms / wall_ms if rows else None,
           "top": [{"name": k[:80], "calls": c, "device_ms": ms}
                   for ms, c, k in rows[:12]],
           "port_kernels": [{"name": k[:80], "calls": c, "device_ms": ms}
                            for ms, c, k in rows if "quake::" in k]}
    if match:
        out["match_ms"] = sum(r[0] for r in rows if match in r[2]) \
            if rows else None
    print(f"profile of one warm {what}: wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms" if rows else
          "profile: the profiler saw no device time (not measured)")
    for r in out["top"]:
        print(f"  {r['device_ms']:8.3f} ms {r['calls']:5d}x {r['name']}")
    for r in out["port_kernels"]:
        if r not in out["top"]:
            print(f"  {r['device_ms']:8.3f} ms {r['calls']:5d}x {r['name']}"
                  f" (the port's)")
    return out


def burst(idx, rng, n_insert, n_delete, first_id, dim):
    """An insert burst near the members of 20 partitions (new content on
    a few topics) and deletes of older vectors there."""
    import numpy as np
    lvl0 = idx.levels[0]
    hot = rng.choice(np.nonzero(lvl0.sizes() >= 64)[0], size=20,
                     replace=False)
    pool = np.concatenate([lvl0.vectors[j] for j in hot])
    new_x = (pool[rng.integers(0, len(pool), n_insert)]
             + rng.normal(size=(n_insert, dim)).astype(np.float32)
             * 0.1).astype(np.float32)
    new_ids = np.arange(first_id, first_id + n_insert, dtype=np.int64)
    old_ids = np.concatenate([lvl0.ids[j] for j in hot])
    del_ids = rng.choice(old_ids, size=min(n_delete, len(old_ids)),
                         replace=False)
    return new_x, new_ids, del_ids


def overlap(a, b) -> float:
    """Mean share of b's ids (per row, -1 left out) that a also has."""
    import numpy as np
    return float(np.mean([len(set(x[x >= 0].tolist())
                              & set(y[y >= 0].tolist()))
                          / max(int((y >= 0).sum()), 1)
                          for x, y in zip(a, b)]))


def bound(nbytes: float, ops: float, ops_per_s: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate of their type."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def worklist(sti, qmask, sel_l, nrows) -> dict:
    """The grouped driver's work list at one plan: the grouping kernel
    held against its plain version (exactly), then the (query, union
    slot) pairs, the tiles of up to QT queries, the mean queries a tile,
    the rows the kernel reads (each tile reads its partition's live rows)
    against ``rows_read`` (each selected partition's live rows once), and
    their ratio, the times a partition is read on average."""
    import torch
    order = sti.slot_order(sel_l.to(torch.int32), nrows, len(sel_l))
    want = sti.group_queries_plain(qmask, order)
    got = sti.group_queries_cuda(qmask, order)
    for name, t in want.items():
        if not torch.equal(got[name], t):
            fail(f"group_queries: the kernel's {name} differs from the "
                 f"plain version's")
    ntiles = want["ntiles"].long()
    pairs = int(want["qcount"].sum())
    tiles = int(ntiles.sum())
    kernel_rows = int((ntiles * nrows[sel_l].long()).sum())
    rows_read = int(nrows[torch.unique(sel_l)].sum())
    return {"pairs": pairs, "tiles": tiles,
            "queries_per_tile": pairs / max(tiles, 1),
            "kernel_rows": kernel_rows, "rows_read": rows_read,
            "reads_per_partition": kernel_rows / max(rows_read, 1)}


def count_kernels(fn) -> dict:
    """Device kernels and memsets that one warm call of ``fn`` launches,
    from torch.profiler's device events."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    memsets = [n for n in names if "memset" in n.lower()]
    kernels = [n for n in names if n not in memsets
               and "memcpy" not in n.lower()]
    return {"kernels": len(kernels), "memsets": len(memsets),
            "names": sorted(set(k[:60] for k in kernels))}


def scan_topk_phase(st, ops, idx, q, dev, launches, seed) -> dict:
    """The dense scan at the shapes of its four callers: the centroid
    pass (Q = B queries against the P centroids, k_pad of m = max(ceil(
    f_m P), min_candidates)), the lambda profile at the serving batch and
    at one query (N = 16,384, k_pad 128), and one-query probes of a
    partition (N ~ 1,000 from the index, and 16,384; k_pad 16 and 128).
    Each is held against the plain version and timed by events and by
    device time beside the library call (``torch.matmul`` + ``torch.
    topk``, ||x||^2 outside the timing).  Also: the launch time of an
    empty kernel (the floor of the one-query rows), the device kernels
    one Q = 1 call launches (gated: one, and no memset), both designs'
    device times around the crossover, and one ``QuakeIndex.
    _scan_vectors`` call split into its host-to-card copy, the kernel
    and the pull-back.  Returns the ``kernels`` row (the centroid pass's
    numbers, the others under ``shapes``)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed + 17)
    cents = torch.as_tensor(idx.levels[0].centroids, device=dev)
    q_dev = torch.as_tensor(q, device=dev)
    b, d = q.shape
    nc = cents.shape[0]
    m = min(max(int(np.ceil(idx.config.f_m * nc)),
                idx.config.min_candidates), nc)
    sizes = idx.levels[0].sizes()
    part = int(np.argmin(np.abs(sizes - 1000)))       # a ~1,000-row probe
    x_part = torch.as_tensor(idx.levels[0].vectors[part], device=dev)

    def rand(rows):
        return torch.as_tensor(rng.normal(size=(rows, d)).astype(
            np.float32), device=dev)
    x16k = rand(16384)
    q_prof = rand(b)
    cases = [("centroid_pass", q_dev, cents, ops._next_pow2(m)),
             ("profile_batch", q_prof, x16k, 128),
             ("profile_one", q_prof[:1], x16k, 128),
             ("probe_k16", q_dev[:1], x_part, 16),
             ("probe_k128", q_dev[:1], x_part, 128),
             ("probe16k_k16", q_dev[:1], x16k, 16),
             ("probe16k_k128", q_dev[:1], x16k, 128)]
    lib = st.build.lib("scan_topk")
    stream = torch.cuda.current_stream().cuda_stream
    empty = {"ms": cuda_ms(lambda: lib.launch_empty(stream)),
             "device_ms": device_ms(lambda: lib.launch_empty(stream))}
    print(f"scan_topk: an empty kernel's launch takes {empty['ms']:.4f} ms "
          f"by events ({empty['device_ms']:.4f} device time)")
    shapes = {}
    for name, qq, xx, kp in cases:
        nq, nx = qq.shape[0], xx.shape[0]
        before = st.LAUNCHES.count
        dk, ik = st.scan_topk_cuda(qq, xx, k_pad=kp)
        per_call = st.LAUNCHES.count - before
        dp, ip_ = st.scan_topk_plain(qq, xx, k_pad=kp)
        err, tol = compare_topk(f"scan_topk {name}", dk, ik, dp, ip_)
        x2 = (xx * xx).sum(1)

        def kern(qq=qq, xx=xx, kp=kp):
            return st.scan_topk_cuda(qq, xx, k_pad=kp)

        def library(qq=qq, xx=xx, x2=x2, kp=min(kp, nx)):
            return torch.topk(x2 - 2.0 * torch.matmul(qq, xx.T), kp, dim=1,
                              largest=False)
        bound_ms, bound_by = bound((nq + nx) * d * 4 + 2 * nq * kp * 4,
                                   2.0 * nq * nx * d, F32_FLOPS_PER_S)
        ms, lib_ms = median_ms(kern, library)
        row = {"Q": nq, "N": nx, "d": d, "k_pad": kp,
               "design": st.design(nq), "launches_per_call": per_call,
               "max_abs_err": err, "tol": tol, "ms": ms,
               "device_ms": device_ms(kern),
               "plain_ms": cuda_ms(lambda: st.scan_topk_plain(
                   qq, xx, k_pad=kp)),
               "library_ms": lib_ms, "library_device_ms": device_ms(library),
               "bound_ms": bound_ms, "bound_by": bound_by}
        if nq == 1 and nx == x_part.shape[0]:
            row["profiled"] = count_kernels(kern)
            if row["profiled"]["kernels"] != 1 or \
                    row["profiled"]["memsets"]:
                fail(f"scan_topk {name}: one call launched "
                     f"{row['profiled']}, not one kernel and no memset")
        shapes[name] = row
        row["faster_than_library"] = {
            "events": row["ms"] < row["library_ms"],
            "device": row["device_ms"] < row["library_device_ms"]}
        print(f"scan_topk {name} (Q={nq}, N={nx}, k_pad {kp}, "
              f"{row['design']}): err {err:.3g}, {row['ms']:.4f} ms "
              f"({row['device_ms']:.4f} device), library "
              f"{row['library_ms']:.4f} ({row['library_device_ms']:.4f}), "
              f"bound {bound_ms:.5f} ({bound_by}), plain "
              f"{row['plain_ms']:.4f}; faster than the library "
              f"{row['faster_than_library']}"
              + (f"; kernels a call {row['profiled']}"
                 if "profiled" in row else ""))
    # both designs' device times around the crossover
    crossover = []
    saved = st.CROSSOVER_Q
    try:
        for nq in (1, 2, 3, 4, 6, 8):
            for xx in (x_part, x16k):
                for kp in (16, 128):
                    row = {"Q": nq, "N": xx.shape[0], "k_pad": kp}
                    for design, cut in (("rows", nq + 1), ("tiles", 0)):
                        st.CROSSOVER_Q = cut
                        row[design] = device_ms(
                            lambda: st.scan_topk_cuda(q_prof[:nq], xx,
                                                      k_pad=kp))
                    crossover.append(row)
    finally:
        st.CROSSOVER_Q = saved
    print("scan_topk crossover (device ms; the wrapper takes rows below "
          f"Q = {st.CROSSOVER_Q}):")
    for r in crossover:
        print(f"  Q={r['Q']:2d} N={r['N']:6d} k_pad {r['k_pad']:4d}: rows "
              f"{r['rows']:.4f}, tiles {r['tiles']:.4f}")
    # one per-query probe: host-to-card copy, kernel, pull-back
    xs_np = idx.levels[0].vectors[part]
    x2_np = idx.levels[0].sqnorms[part]
    ids_np = idx.levels[0].ids[part]
    q1 = np.ascontiguousarray(q[0])
    kk = 10

    def wall(fn, reps=200):
        fn()
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        return (time.perf_counter() - t) / reps * 1e3
    qd = torch.as_tensor(q1[None, :], device=dev)
    xd = torch.as_tensor(xs_np, device=dev)
    dd, ii = ops.scan_topk(qd, xd, kk, metric=idx.config.metric)

    def copy_in():
        torch.as_tensor(q1[None, :], device=dev)
        torch.as_tensor(xs_np, device=dev)
        torch.cuda.synchronize()

    def scan():
        ops.scan_topk(qd, xd, kk, metric=idx.config.metric)
        torch.cuda.synchronize()

    def pull():
        dd[0].cpu().numpy()
        ii[0].cpu().numpy()
    probe = {"rows": int(xs_np.shape[0]), "k": kk,
             "scan_vectors_ms": wall(lambda: idx._scan_vectors(
                 q1, xs_np, x2_np, ids_np, kk)),
             "copy_in_ms": wall(copy_in), "scan_ms": wall(scan),
             "pull_back_ms": wall(pull)}
    print(f"per-query probe of {probe['rows']} rows (host clock): "
          f"_scan_vectors {probe['scan_vectors_ms']:.4f} ms = copy in "
          f"{probe['copy_in_ms']:.4f} + ops.scan_topk "
          f"{probe['scan_ms']:.4f} + pull back {probe['pull_back_ms']:.4f}")
    main = shapes["centroid_pass"]
    return {"name": "scan_topk", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/scan_topk.cu",
            "replaces": "src/repro/kernels/scan_topk.py:168",
            "launches": launches["scan_topk"],
            **{k: main[k] for k in ("max_abs_err", "tol", "ms", "device_ms",
                                    "plain_ms", "bound_ms", "bound_by",
                                    "library_ms", "library_device_ms")},
            "shape": {k: main[k] for k in ("Q", "N", "d", "k_pad",
                                           "design")},
            "shapes": shapes, "empty_kernel": empty,
            "crossover": crossover, "per_query_probe": probe}


def main() -> int:
    args = parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; nothing was run",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    try:
        import numpy as np
        from repro_torch.core import (BatchedSearchExecutor, QuakeIndex,
                                      get_executor, plan_batch)
        from repro_torch.data import datasets
        from repro_torch.kernels import build, ops, ref
        from repro_torch.kernels import flash_attention as fa
        from repro_torch.kernels import kmeans_assign as ka
        from repro_torch.kernels import scan_topk as st
        from repro_torch.kernels import scan_topk_indexed as sti
        from repro_torch.kernels.ref import MASK_DIST
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    record = {"args": vars(args)}
    card = card_line()
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)}")
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    # ---- build the kernels ------------------------------------------------
    t0 = time.perf_counter()
    took = build.build_all()
    build_s = time.perf_counter() - t0
    print(f"kernels built in {build_s:.1f} s ({took})")
    logs = {n: build.build_log(n) for n in build.SIGNATURES}
    (OUT_DIR / "ptxas.log").write_text(
        "\n".join(f"== {n}\n{l}" for n, l in logs.items()))
    for n, l in logs.items():
        for line in (l or "").splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas {n}: {line.strip()}")
    record["build_s"] = build_s

    steps, step_launches = {}, {}
    counters = {"scan_topk_indexed": sti.LAUNCHES, "scan_topk": st.LAUNCHES,
                "kmeans_assign": ka.LAUNCHES,
                "scan_topk_indexed_q8": sti.LAUNCHES_Q8,
                "flash_attention": fa.LAUNCHES}
    path_launches = {}

    def start_path():
        for c in counters.values():
            c.reset()

    def end_path(name, needs):
        got = {n: c.count for n, c in counters.items()}
        path_launches[name] = got
        print(f"launches on the {name} path: {got}")
        for n in needs:
            if got[n] <= 0:
                fail(f"kernel {n} was not launched on the {name} path")
        return got

    def step(name, fn):
        before = {n: c.count for n, c in counters.items()}
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        steps[name] = time.perf_counter() - t
        step_launches[name] = {n: c.count - before[n]
                               for n, c in counters.items()}
        print(f"step {name}: {steps[name]:.3f} s, launches "
              f"{step_launches[name]}")
        return out

    # ---- path 1: the main path ------------------------------------------
    ds = step("data", lambda: datasets.clustered(
        args.n, args.dim, n_clusters=args.clusters, power=args.power,
        seed=args.seed))
    q = datasets.queries_near(ds, args.batch, seed=args.seed + 1)
    gt = step("ground_truth", lambda: ds.ground_truth(q, args.k,
                                                      device=dev))
    start_path()
    idx = step("build", lambda: QuakeIndex.build(ds.vectors, device=dev))
    runs = {}

    def search(name, fn, min_recall=None):
        r = step(name, fn)
        rec = recall_at(r.ids, gt)
        runs[name] = {"recall@k": rec, "mean_nprobe": float(r.nprobe.mean()),
                      "rounds": int(r.rounds),
                      "vectors_scanned": int(r.vectors_scanned),
                      "partitions_scanned": int(r.partitions_scanned),
                      "wall_s": steps[name]}
        print(f"  {name}: recall@{args.k} {rec:.4f}, mean nprobe "
              f"{r.nprobe.mean():.2f}, rounds {r.rounds}, vectors "
              f"{r.vectors_scanned}")
        if not np.isfinite(r.dists[r.ids >= 0]).all():
            fail(f"{name}: non-finite distances")
        if r.ids.shape != (args.batch, args.k):
            fail(f"{name}: result shape {r.ids.shape}")
        if min_recall is not None and rec < min_recall:
            fail(f"{name}: recall {rec:.4f} < {min_recall}")
        return r

    search("search_vectorized",
           lambda: idx.search_batch(q, args.k, recall_target=0.9),
           APS_RECALL_MIN)
    search("search_vectorized_warm",
           lambda: idx.search_batch(q, args.k, recall_target=0.9),
           APS_RECALL_MIN)
    fused = BatchedSearchExecutor(idx, planner="fused")
    search("search_fused",
           lambda: fused.search(q, args.k, recall_target=0.9),
           APS_RECALL_MIN)
    del fused            # its snapshot copy is not needed again
    torch.cuda.empty_cache()
    search("search_nprobe32",
           lambda: idx.search_batch(q, args.k, nprobe=32, rounds=1))
    search("search_bf16",
           lambda: idx.search_batch(q, args.k, recall_target=0.9,
                                    storage_dtype="bf16"), BF16_RECALL)

    # the vectors ever inserted, by id (ids are contiguous), and which live
    all_x = [ds.vectors]
    alive = np.ones(args.n, dtype=bool)

    def update(rng, first_id):
        new_x, new_ids, del_ids = burst(idx, rng, args.insert, args.delete,
                                        first_id, args.dim)
        step(f"insert@{first_id}", lambda: idx.insert(new_x, new_ids))
        removed = step(f"delete@{first_id}", lambda: idx.delete(del_ids))
        if removed != len(del_ids):
            fail(f"deleted {removed} of {len(del_ids)}")
        all_x.append(new_x)
        alive.resize(first_id + len(new_ids), refcheck=False)
        alive[new_ids] = True
        alive[del_ids] = False
        live_ids = np.nonzero(alive)[0]
        x_live = np.concatenate(all_x)[alive]
        q_new = np.concatenate([q[: args.batch // 2],
                                new_x[: args.batch - args.batch // 2]])
        ds_live = datasets.VectorDataset(
            x_live, np.zeros(len(live_ids), dtype=np.int64), ds.centers)
        return q_new, live_ids[ds_live.ground_truth(q_new, args.k,
                                                    device=dev)]

    q2, gt = update(np.random.default_rng(args.seed + 2), args.n)
    ex = get_executor(idx)
    r_after = search("search_after_update",
                     lambda: idx.search_batch(q2, args.k, recall_target=0.9),
                     APS_RECALL_MIN)
    print(f"f32 executor: delta_refreshes {ex.delta_refreshes}, "
          f"full_rebuilds {ex.full_rebuilds}")
    if ex.delta_refreshes != 1 or ex.full_rebuilds != 1:
        fail("the update should refresh the snapshot by one delta")
    idx.check_invariants()
    launches = end_path("main", ("scan_topk_indexed", "scan_topk",
                                 "kmeans_assign"))

    # ---- path 2: int8 serving on the same index -------------------------
    start_path()
    ex8 = get_executor(idx, "int8")
    search("int8_search",
           lambda: idx.search_batch(q2, args.k, recall_target=0.9,
                                    storage_dtype="int8"), APS_RECALL_MIN)
    before = sti.LAUNCHES_Q8.count
    r8 = search("int8_search_warm",
                lambda: idx.search_batch(q2, args.k, recall_target=0.9,
                                         storage_dtype="int8"),
                APS_RECALL_MIN)
    q8_per_search = sti.LAUNCHES_Q8.count - before
    print(f"q8 kernel launches per warm int8 search_batch: {q8_per_search} "
          f"({r8.rounds} rounds)")
    ov = overlap(r8.ids, r_after.ids)
    print(f"  int8 ids overlap the f32 ids: {ov:.4f}")
    if ov < INT8_OVERLAP:
        fail(f"int8 overlap with f32 {ov:.4f} < {INT8_OVERLAP}")
    search("int8_nprobe32",
           lambda: idx.search_batch(q2, args.k, nprobe=32, rounds=1,
                                    storage_dtype="int8"))
    rebuilds = ex8.full_rebuilds
    q3, gt = update(np.random.default_rng(args.seed + 3),
                    args.n + args.insert)
    search("int8_after_update",
           lambda: idx.search_batch(q3, args.k, recall_target=0.9,
                                    storage_dtype="int8"), APS_RECALL_MIN)
    print(f"int8 executor: delta_refreshes {ex8.delta_refreshes}, "
          f"full_rebuilds {rebuilds} -> {ex8.full_rebuilds}")
    if ex8.delta_refreshes != 0 or ex8.full_rebuilds != rebuilds + 1:
        fail("the int8 executor must requantize by one full rebuild")
    idx.check_invariants()
    end_path("int8", ("scan_topk_indexed_q8", "kmeans_assign"))
    record.update(steps=steps, step_launches=step_launches, runs=runs,
                  q8_per_warm_search=q8_per_search,
                  snapshot={"P": int(ex._snap.num_partitions),
                            "S_cap": int(ex._snap.capacity),
                            "S_cap_int8": int(ex8._snap.capacity)})

    # ---- kernels vs their plain versions, at the paths' shapes ----------
    kernels = []
    snap = ex.snapshot()
    valid = ex._valid
    plan = plan_batch(idx, q, args.k, recall_target=0.9)
    sel = plan.sel_dev.to(torch.int32).contiguous()
    sel_l = sel.long()
    qmask = plan.qmask_dev.contiguous()
    k_pad = ops._next_pow2(args.k)
    nrows = sti.live_rows(valid)
    pairs = qmask.sum(dim=0).long()
    live = nrows[sel_l].long()
    active_rows = int((pairs * live).sum())
    uniq = torch.unique(sel_l)
    rows_read = int(nrows[uniq].sum())
    bf16_snap = get_executor(idx, "bf16").snapshot().data
    q_dev = torch.as_tensor(q, device=dev)
    b, d = q.shape
    u = int(sel.shape[0])
    # the second timed plan: nprobe=32, rounds=1 (many queries a slot)
    plan32 = plan_batch(idx, q, args.k, nprobe=32)
    sel32 = plan32.sel_dev.to(torch.int32).contiguous()
    qmask32 = plan32.qmask_dev.contiguous()
    work = {"aps": worklist(sti, qmask, sel_l, nrows),
            "nprobe32": worklist(sti, qmask32, sel32.long(), nrows)}
    for name, w in work.items():
        print(f"work list at the {name} plan: {w['pairs']} (query, slot) "
              f"pairs in {w['tiles']} tiles, {w['queries_per_tile']:.2f} "
              f"queries a tile; the kernel reads {w['kernel_rows']} rows "
              f"for rows_read {w['rows_read']} "
              f"({w['reads_per_partition']:.3f} reads a partition)")
    n_chk = 64          # queries of the nprobe=32 plan held against plain

    def library_scan(gather, valid_t, metric, kp):
        """torch.topk over a torch.matmul on the gathered union rows."""
        blocks = gather()
        xs_u = blocks.reshape(-1, d)
        ok = valid_t.index_select(0, sel_l).reshape(-1)
        aux = torch.where(ok, 0.0, MASK_DIST)
        if metric == "l2":
            aux = aux + (xs_u * xs_u).sum(1)
        coef = -2.0 if metric == "l2" else -1.0
        out = []
        for b0 in range(0, b, 64):
            dist = aux + coef * torch.matmul(q_dev[b0:b0 + 64], xs_u.T)
            m = qmask[b0:b0 + 64].repeat_interleave(blocks.shape[1], 1)
            dist = torch.where(m, dist, MASK_DIST)
            out.append(torch.topk(dist, kp, dim=1, largest=False))
        return out

    for dtype_name, data_t in (("f32", snap.data), ("bf16", bf16_snap)):
        qc = q_dev.to(data_t.dtype).contiguous()
        elem = data_t.element_size()
        for metric in ("l2", "ip"):
            def kern():
                return sti.scan_topk_indexed_cuda(
                    qc, data_t, valid, sel, qmask, k_pad=k_pad,
                    metric=metric)

            def plain():
                return sti.scan_topk_indexed_plain(
                    qc, data_t, valid, sel, qmask, k_pad=k_pad,
                    metric=metric)
            dk, ik = kern()
            (dp, ip_), plain_ms = timed(plain)
            err, tol = compare_topk(f"scan_topk_indexed {dtype_name} "
                                    f"{metric}", dk, ik, dp, ip_)
            if dtype_name == "bf16":
                d32, i32 = sti.scan_topk_indexed_plain(
                    q_dev, snap.data, valid, sel, qmask, k_pad=k_pad,
                    metric=metric)
                ov = recall_at(ik.cpu().numpy(),
                               i32.cpu().numpy()[:, :args.k])
                if ov < BF16_RECALL:
                    fail(f"bf16 {metric} overlap with f32 {ov:.3f}")
            ms = cuda_ms(kern)
            dev_ms = device_ms(kern)
            if (dtype_name, metric) == ("f32", "l2"):
                record["profile_scan_topk_indexed"] = profile_call(
                    kern, "scan_topk_indexed")

            def kern32(nq=b):
                return sti.scan_topk_indexed_cuda(
                    qc[:nq], data_t, valid, sel32, qmask32[:nq], k_pad=k_pad,
                    metric=metric)
            dk32, ik32 = kern32(n_chk)
            compare_topk(f"scan_topk_indexed {dtype_name} {metric} at "
                         f"nprobe=32 (first {n_chk} queries)", dk32, ik32,
                         *sti.scan_topk_indexed_plain(
                             qc[:n_chk], data_t, valid, sel32,
                             qmask32[:n_chk], k_pad=k_pad, metric=metric))
            ms32, dev_ms32 = cuda_ms(kern32), device_ms(kern32)
            lib_ms = timed(lambda: library_scan(
                lambda: data_t.index_select(0, sel_l).float(), valid,
                metric, k_pad))[1]
            bound_ms, bound_by = bound(
                rows_read * d * elem + b * d * elem + 2 * b * k_pad * 4
                + b * u + rows_read, 2.0 * active_rows * d, F32_FLOPS_PER_S)
            kernels.append({
                "name": ("scan_topk_indexed" if (dtype_name, metric)
                         == ("f32", "l2") else
                         f"scan_topk_indexed[{dtype_name},{metric}]"),
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/scan_topk_indexed.cu",
                "replaces": "src/repro/kernels/scan_topk_indexed.py:85",
                "launches": launches["scan_topk_indexed"],
                "max_abs_err": err, "tol": tol, "ms": ms,
                "device_ms": dev_ms,
                "plain_ms": plain_ms, "bound_ms": bound_ms,
                "bound_by": bound_by, "library_ms": lib_ms,
                "shape": {"B": b, "U": u, "S": int(data_t.shape[1]),
                          "d": d, "k_pad": k_pad,
                          "active_pair_rows": active_rows},
                "work_list": work["aps"],
                "nprobe32": {"ms": ms32, "device_ms": dev_ms32,
                             "U": int(sel32.shape[0]),
                             "work_list": work["nprobe32"]}})
            print(f"scan_topk_indexed {dtype_name} {metric}: err {err:.3g}"
                  f" (tol {tol:.3g}), {ms:.4f} ms ({dev_ms:.4f} device "
                  f"time) vs plain {plain_ms:.1f} ms, bound "
                  f"{bound_ms:.4f} ms; {ms32:.4f} ms ({dev_ms32:.4f}) at "
                  f"nprobe=32")
    del bf16_snap

    # the int8 scan at the same plan, k_scan = 2k (the re-rank's list)
    snap8 = ex8.snapshot()
    kp8 = ops._next_pow2(2 * args.k)
    nrows8 = sti.live_rows(ex8._valid)
    live8 = nrows8[sel_l].long()
    active8 = int((pairs * live8).sum())
    rows8 = int(nrows8[uniq].sum())

    def dequantized():
        return (snap8.centroids.index_select(0, sel_l)[:, None, :]
                + snap8.data.index_select(0, sel_l).float()
                * snap8.scales.index_select(0, sel_l)[..., None])

    for metric in ("l2", "ip"):
        operands = ref.q8_scan_operands(q_dev, snap8.data, snap8.scales,
                                        ex8._valid, sel, metric,
                                        snap8.centroids)
        args8 = (*operands[:2], snap8.data, snap8.scales, *operands[2:],
                 ex8._valid, sel, qmask)

        def kern():
            return sti.scan_topk_indexed_q8_cuda(*args8, k_pad=kp8,
                                                 metric=metric)

        def plain():
            return sti.scan_topk_indexed_q8_plain(*args8, k_pad=kp8,
                                                  metric=metric)
        dk, ik = kern()
        (dp, ip_), plain_ms = timed(plain)
        err, tol = compare_topk(f"scan_topk_indexed_q8 {metric}", dk, ik,
                                dp, ip_)
        ms = cuda_ms(kern)
        dev_ms = device_ms(kern)
        if metric == "l2":
            record["profile_scan_topk_indexed_q8"] = profile_call(
                kern, "scan_topk_indexed_q8")
        ops32 = ref.q8_scan_operands(q_dev, snap8.data, snap8.scales,
                                     ex8._valid, sel32, metric,
                                     snap8.centroids)
        args32 = (*ops32[:2], snap8.data, snap8.scales, *ops32[2:],
                  ex8._valid, sel32, qmask32)

        def kern32(nq=b):
            a = args32
            return sti.scan_topk_indexed_q8_cuda(
                a[0][:nq], a[1][:nq], *a[2:5], a[5][:nq], a[6], a[7],
                a[8][:nq], k_pad=kp8, metric=metric)
        dk32, ik32 = kern32(n_chk)
        a = args32
        dp32, ip32 = sti.scan_topk_indexed_q8_plain(
            a[0][:n_chk], a[1][:n_chk], *a[2:5], a[5][:n_chk], a[6], a[7],
            a[8][:n_chk], k_pad=kp8, metric=metric)
        compare_topk(f"scan_topk_indexed_q8 {metric} at nprobe=32 (first "
                     f"{n_chk} queries)", dk32, ik32, dp32, ip32)
        if not torch.equal(dk32, dp32):
            fail(f"scan_topk_indexed_q8 {metric} at nprobe=32: distances "
                 f"not bit-equal to the plain version's")
        ms32, dev_ms32 = cuda_ms(kern32), device_ms(kern32)
        lib_ms = timed(lambda: library_scan(dequantized, ex8._valid, metric,
                                            kp8))[1]
        bound_ms, bound_by = bound(
            rows8 * (d + 4 + 4 + 1) + b * (d + 4) + b * u * (4 + 1)
            + 2 * b * kp8 * 4, 2.0 * active8 * d, INT8_OPS_PER_S)
        kernels.append({
            "name": ("scan_topk_indexed_q8" if metric == "l2"
                     else "scan_topk_indexed_q8[ip]"),
            "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/scan_topk_indexed_q8.cu",
            "replaces": "src/repro/kernels/scan_topk_indexed.py:210",
            "launches": path_launches["int8"]["scan_topk_indexed_q8"],
            "max_abs_err": err, "tol": tol, "ms": ms,
            "device_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": lib_ms,
            "library": "gather + dequantize, torch.matmul, torch.topk",
            "shape": {"B": b, "U": u, "S": int(snap8.capacity), "d": d,
                      "k_pad": kp8, "active_pair_rows": active8,
                      "rows_read": rows8},
            "work_list": worklist(sti, qmask, sel_l, nrows8),
            "nprobe32": {"ms": ms32, "device_ms": dev_ms32,
                         "U": int(sel32.shape[0]),
                         "work_list": worklist(sti, qmask32, sel32.long(),
                                               nrows8)}})
        print(f"scan_topk_indexed_q8 {metric}: err {err:.3g} (tol "
              f"{tol:.3g}), {ms:.4f} ms ({dev_ms:.4f} device time) vs "
              f"plain {plain_ms:.1f} ms, library {lib_ms:.1f} ms, bound "
              f"{bound_ms:.4f} ms; {ms32:.4f} ms ({dev_ms32:.4f}) at "
              f"nprobe=32")
        if err != 0.0:
            fail(f"scan_topk_indexed_q8 {metric}: distances differ from "
                 f"the plain version's by {err!r}, not 0")
        if metric == "l2":
            flat = ik[:, :2 * args.k].cpu().numpy()
            t = time.perf_counter()
            ex8._rerank_exact(q, flat, args.k)
            record["rerank_gather_ms"] = (time.perf_counter() - t) * 1e3
            print(f"exact re-rank of the B x 2k candidates: "
                  f"{record['rerank_gather_ms']:.1f} ms (host)")

    # the dense scan at its callers' shapes (the centroid pass first)
    kernels.append(scan_topk_phase(st, ops, idx, q, dev, launches,
                                   args.seed))
    cents = torch.as_tensor(idx.levels[0].centroids, device=dev)
    nc = cents.shape[0]

    # assignment: an insert burst against the base centroids, and an
    # exact-tie case (a centroid duplicated at a smaller index)
    xs = torch.as_tensor(all_x[1], device=dev)
    aux = (cents * cents).sum(1)
    err, tol, ap = hold_assign(ka, "kmeans_assign", xs, cents, aux)
    tied = cents.clone()
    top = int(torch.mode(ap.long()).values)
    lo_idx = 0 if top != 0 else 1
    tied[lo_idx] = tied[top]
    aux_t = (tied * tied).sum(1)
    at, _ = ka.kmeans_assign_cuda(xs, tied, aux_t)
    at_p, _ = ka.kmeans_assign_plain(xs, tied, aux_t)
    hit = ap == top
    if not bool((at[hit] == lo_idx).all()) or not torch.equal(
            at[hit], at_p[hit]):
        fail("kmeans_assign: exact ties must go to the smallest index")
    ms = cuda_ms(lambda: ka.kmeans_assign_cuda(xs, cents, aux))
    dev_ms = device_ms(lambda: ka.kmeans_assign_cuda(xs, cents, aux))
    plain_ms = cuda_ms(lambda: ka.kmeans_assign_plain(xs, cents, aux))

    def library():
        return torch.argmin(torch.cdist(xs, cents), dim=1)
    lib_ms, lib_dev_ms = cuda_ms(library), device_ms(library)
    n_x = xs.shape[0]
    bound_ms, bound_by = bound((n_x + nc) * d * 4 + n_x * 8,
                               2.0 * n_x * nc * d, F32_FLOPS_PER_S)
    kernels.append({
        "name": "kmeans_assign", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans_assign.py:67",
        "launches": launches["kmeans_assign"], "max_abs_err": err,
        "tol": tol, "ms": ms, "device_ms": dev_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": lib_ms,
        "library_device_ms": lib_dev_ms,
        "shape": {"N": n_x, "C": nc, "d": d, "tied_points": int(hit.sum())}})
    print(f"kmeans_assign: err {err:.3g} (tol {tol:.3g}), {ms:.4f} ms "
          f"({dev_ms:.4f} device time), library {lib_ms:.4f} ms "
          f"({lib_dev_ms:.4f})")
    torch.cuda.synchronize()

    # ---- where the time of one warm search_batch goes ------------------
    record["profile"] = profile_call(
        lambda: idx.search_batch(q, args.k, recall_target=0.9))
    del idx, ex, ex8, snap, snap8, valid, plan, sel, qmask, ds, all_x
    torch.cuda.empty_cache()

    # ---- path 3: the dynamic loop (paper Fig. 4) ------------------------
    t = time.perf_counter()
    wl = wiki_workload(args)
    workload_s = time.perf_counter() - t
    record["dynamic"] = run_dynamic(args, wl, dev, start_path, end_path)
    record["dynamic"]["workload_s"] = workload_s
    gc.collect()
    torch.cuda.empty_cache()

    # ---- path 5: online serving (launch/serve.replay_runtime) -----------
    t = time.perf_counter()
    record["serving"] = run_serving(args, wl, dev, start_path, end_path)
    record["serving"]["path_s"] = time.perf_counter() - t
    print(f"serving path took {record['serving']['path_s']:.1f} s")
    for row in kernels:      # each kernel's launches on the serving path
        base = row["name"].split("[")[0]
        if base == "scan_topk_indexed_q8":
            row["serving_launches"] = \
                record["serving"]["int8_launches"][base]
        elif base in record["serving"]["launches"]:
            row["serving_launches"] = record["serving"]["launches"][base]
        if row["name"] in record["serving"]["kernel_checks"]:
            # held against the plain version on the serving path's own
            # operands
            row["serving_check"] = \
                record["serving"]["kernel_checks"][row["name"]]
    del wl
    gc.collect()
    torch.cuda.empty_cache()

    # ---- path 4: LM serving (prefill -> decode) ---------------------------
    t = time.perf_counter()
    record["lm"], row = run_lm(args, dev, start_path, end_path)
    record["lm"]["path_s"] = time.perf_counter() - t
    print(f"lm path took {record['lm']['path_s']:.1f} s")
    kernels.append(row)
    record.update(kernels=kernels, card=card, path_launches=path_launches,
                  total_s=time.perf_counter() - t_start)
    (OUT_DIR / "record.json").write_text(json.dumps(record, indent=1))
    print(f"chip_smoke: all paths passed in "
          f"{record['total_s']:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


def dry_pass(idx, lam, tau):
    """The maintenance pass that ``lam`` with commit threshold ``tau``
    makes on the index's current statistics; the index is rolled back
    after it (``checkpoint_index`` / ``restore_index``)."""
    import dataclasses
    from repro_torch.core import Maintainer, checkpoint_index, restore_index
    ckpt, cfg = checkpoint_index(idx), idx.config
    idx.config = dataclasses.replace(cfg, tau_ns=tau)
    try:
        return Maintainer(idx, lam).run()
    finally:
        idx.config = cfg
        restore_index(idx, ckpt)


def wiki_workload(args):
    """The Wikipedia-style workload the dynamic loop and the serving path
    share (inner product, ``--wiki-n`` vectors, 1024 queries a month)."""
    from repro_torch.data.wikipedia import wikipedia_workload
    return wikipedia_workload(n_total=args.wiki_n, dim=args.dim,
                              months=args.months,
                              queries_per_month=max(args.batch,
                                                    args.month_queries),
                              seed=args.seed)


def run_dynamic(args, wl, dev, start_path, end_path) -> dict:
    """The dynamic loop on the Wikipedia-style workload: build, profile
    lambda on the card, then per month the insert burst, per-query APS
    searches (which record access statistics), one maintenance pass, the
    invariants, and one batched search through the f32 and the int8
    executors against the exact ground truth (recall@10 on the card).

    Maintenance is priced by lambda per query of a B-query scan, the
    batched path that serves the month's queries; each month also runs,
    and rolls back, the pass that the single-query lambda (the JAX
    package's ``profile``) would make on the same statistics.

    Fails when a pass's cost change net of refinement and level changes
    differs from the sum of its committed actions' verify deltas (the
    commit gate's accounting), no split commits, the invariants break,
    int8 overlaps f32 by less than INT8_OVERLAP, or the int8 executor
    patches its snapshot instead of rebuilding it.  A rise of the raw
    cost (refinement moves points after the gate, in the reference too)
    is reported per month, not gated."""
    import numpy as np
    import torch
    from repro_torch.core import (Maintainer, QuakeConfig, QuakeIndex,
                                  get_executor, profile)
    from repro_torch.core import kmeans
    from repro_torch.core.cost_model import paper_tau_ns
    from repro_torch.data.workload import IncrementalGroundTruth
    k = 10
    out = {"months": []}
    start_path()
    # lambda per query, in device time: the serving batch's scan, which
    # prices maintenance, and the single-query scan, whose pass is
    # reported beside it.  tau is the paper's, rescaled to each lambda.
    t = time.perf_counter()
    lams = {f"batch{b}": profile(args.dim, device=dev, batch=b)
            for b in (args.batch, 1)}
    out["profile_s"] = time.perf_counter() - t
    lam, lam_q = lams[f"batch{args.batch}"], lams["batch1"]
    tau, tau_q = paper_tau_ns(lam), paper_tau_ns(lam_q)
    card = card_line()
    out["lambda"] = {name: {"c_fixed": m.c_fixed, "c_lin": m.c_lin,
                            "c_sel": m.c_sel, "tau_ns": paper_tau_ns(m)}
                     for name, m in lams.items()}
    out["lambda"]["card"] = card
    print(f"dynamic: lambda profiled on {card} (ns per query, device "
          f"time; tau = 250 ns * lambda(500) / 1.2e6 ns):")
    for name, m in lams.items():
        print(f"  {name}: lambda(s) = {m.c_fixed:.3f} + {m.c_lin:.6f} s + "
              f"{m.c_sel:.6f} s log2 s, tau = {paper_tau_ns(m):.5f} ns")
    t = time.perf_counter()
    idx = QuakeIndex.build(wl.initial_vectors, wl.initial_ids,
                           config=QuakeConfig(metric="ip", tau_ns=tau),
                           device=dev)
    out["build_s"] = time.perf_counter() - t
    print(f"dynamic: {len(wl.initial_ids)} initial vectors, "
          f"{idx.num_partitions} partitions, built in {out['build_s']:.1f} "
          f"s")
    # k-means on the card is reproducible: two builds of one sample at
    # one seed give bit-equal centroids and the same assignments
    sample = wl.initial_vectors[:100_000]
    n_c = int(np.sqrt(len(sample)))
    c1, a1 = kmeans.kmeans(sample, n_c, seed=args.seed, device=dev)
    c2, a2 = kmeans.kmeans(sample, n_c, seed=args.seed, device=dev)
    out["kmeans_repeat"] = {"points": len(sample), "clusters": n_c,
                            "assignments_differ": int((a1 != a2).sum()),
                            "centroid_max_diff": float(np.abs(c1 - c2).max())}
    print(f"dynamic: two k-means builds of {len(sample)} vectors into "
          f"{n_c} clusters at seed {args.seed}: "
          f"{out['kmeans_repeat']['assignments_differ']} assignments "
          f"differ, largest centroid |diff| "
          f"{out['kmeans_repeat']['centroid_max_diff']!r}")
    if out["kmeans_repeat"]["assignments_differ"] or \
            out["kmeans_repeat"]["centroid_max_diff"]:
        fail("k-means on the card is not reproducible")
    maint = Maintainer(idx, lam)
    gt = IncrementalGroundTruth(wl.dataset, wl.initial_ids, device=dev)
    ex8 = get_executor(idx, "int8")
    seen_version = None      # index version the int8 snapshot last served
    inserted, splits, q_splits = 0, 0, 0
    print(f"month  vectors  parts    ins  pq_recall  pq_nprobe  pq_ms  splits "
          f"merges rejected  cost_before  cost_after    priced  unpriced  "
          f"maint_s | batch1: splits rejected | f32_rec  int8_rec  overlap")
    for op in wl.operations:
        if op.kind == "insert":
            idx.insert(op.vectors, op.ids)
            gt.insert(op.ids)
            inserted += len(op.ids)
            continue
        row = {"month": len(out["months"]) + 1, "inserted": inserted}
        inserted = 0
        qs = op.queries
        truth = gt.topk(qs, k)
        n_pq = args.month_queries
        torch.cuda.synchronize()
        t = time.perf_counter()
        hits, nps = [], []
        for qq, tt in zip(qs[:n_pq], truth):
            r = idx.search(qq, k, recall_target=0.9)
            hits.append(len(set(r.ids.tolist()) & set(tt.tolist())) / k)
            nps.append(r.nprobe[0])
        row.update(pq_queries=n_pq, pq_recall=float(np.mean(hits)),
                   pq_nprobe=float(np.mean(nps)),
                   pq_ms=(time.perf_counter() - t) / n_pq * 1e3)
        t = time.perf_counter()
        rq = dry_pass(idx, lam_q, tau_q)
        row.update(batch1_s=time.perf_counter() - t,
                   batch1_splits=rq.splits, batch1_merges=rq.merges,
                   batch1_rejected=rq.rejected_splits + rq.rejected_merges,
                   batch1_cost_before=rq.cost_before,
                   batch1_cost_after=rq.cost_after)
        q_splits += rq.splits
        t = time.perf_counter()
        rep = maint.run()
        priced = sum(a["delta"] for a in rep.actions if a["committed"])
        row.update(maint_s=time.perf_counter() - t, splits=rep.splits,
                   merges=rep.merges, rejected=rep.rejected_splits
                   + rep.rejected_merges, cost_before=rep.cost_before,
                   cost_after=rep.cost_after, priced=priced,
                   unpriced=rep.unpriced_cost, level_added=rep.level_added,
                   level_removed=rep.level_removed)
        splits += rep.splits
        # the commit gate's accounting: the splits and merges it committed
        # moved the cost by exactly the sum of their verify deltas
        moved = rep.cost_after - rep.unpriced_cost - rep.cost_before
        if abs(moved - priced) > 1e-6 * max(abs(rep.cost_before), 1.0):
            fail(f"month {row['month']}: the committed actions moved the "
                 f"cost by {moved:.6f}, their verify deltas sum to "
                 f"{priced:.6f}")
        try:
            idx.check_invariants()
        except AssertionError as e:
            fail(f"month {row['month']}: invariants broke after "
                 f"maintenance ({e!r})")
        qb = qs[:args.batch]
        rebuilds = ex8.full_rebuilds
        changed = seen_version is not None and idx.version != seen_version
        r32 = idx.search_batch(qb, k, recall_target=0.9)
        r8 = idx.search_batch(qb, k, recall_target=0.9, storage_dtype="int8")
        seen_version = idx.version
        row.update(vectors=idx.num_vectors, partitions=idx.num_partitions,
                   f32_recall=recall_at(r32.ids, truth[:args.batch]),
                   int8_recall=recall_at(r8.ids, truth[:args.batch]),
                   overlap=overlap(r8.ids, r32.ids),
                   int8_rebuilds=ex8.full_rebuilds,
                   int8_deltas=ex8.delta_refreshes)
        out["months"].append(row)
        print(f"{row['month']:5d} {row['vectors']:8d} {row['partitions']:6d}"
              f" {row['inserted']:6d} {row['pq_recall']:10.4f} "
              f"{row['pq_nprobe']:10.2f} {row['pq_ms']:6.2f} "
              f"{row['splits']:6d} {row['merges']:6d} {row['rejected']:8d} "
              f"{row['cost_before']:12.3f} {row['cost_after']:11.3f} "
              f"{row['priced']:9.3f} {row['unpriced']:9.3f} "
              f"{row['maint_s']:8.2f} | {row['batch1_splits']:14d} "
              f"{row['batch1_rejected']:8d} | {row['f32_recall']:7.4f} "
              f"{row['int8_recall']:9.4f} {row['overlap']:8.4f}")
        if row["overlap"] < INT8_OVERLAP:
            fail(f"month {row['month']}: int8 overlaps f32 by "
                 f"{row['overlap']:.4f} < {INT8_OVERLAP}")
        if ex8.delta_refreshes != 0 or (
                changed and ex8.full_rebuilds != rebuilds + 1):
            fail(f"month {row['month']}: the int8 executor must rebuild "
                 f"after a change (rebuilds {rebuilds} -> "
                 f"{ex8.full_rebuilds}, deltas {ex8.delta_refreshes})")
    if len(out["months"]) < 3:
        fail(f"the dynamic loop ran {len(out['months'])} months, not 3")
    if splits == 0:
        fail("no maintenance split was committed over the dynamic loop")
    rises = [(m["month"], m["cost_after"] - m["cost_before"])
             for m in out["months"] if m["cost_after"] > m["cost_before"]]
    out.update(splits=splits, batch1_splits=q_splits, raw_rises=rises)
    print(f"dynamic: {splits} splits committed at lambda batch{args.batch}; "
          f"{q_splits} would be at lambda batch1 (passes rolled back)")
    print(f"dynamic: cost_after <= cost_before in "
          f"{len(out['months']) - len(rises)} of {len(out['months'])} "
          f"passes; raw rises (month, ns): "
          + (", ".join(f"({m}, {d:+.3f})" for m, d in rises) or "none"))
    out["launches"] = end_path("dynamic", ("scan_topk", "kmeans_assign",
                                           "scan_topk_indexed",
                                           "scan_topk_indexed_q8"))
    return out


def serving_agreement(index, queries, groups, k, after_device=None):
    """Replay ``groups`` (lists of query rows in admission order) single-
    threaded through two runtimes over ``index``, one per scan backend;
    ``after_device()`` runs between the two.  Returns per backend (the
    per-query results, the runtime's rounds, its indexed-scan
    launches)."""
    from repro_torch.core import ServingConfig, ServingRuntime
    from repro_torch.kernels import scan_topk_indexed as sti
    out = {}
    for backend in ("device", "host"):
        rt = ServingRuntime(index, ServingConfig(
            k=k, recall_target=SERVE_TARGET, flush_size=10 ** 9,
            ticker=False, scan_backend=backend, planner=SERVE_PLANNER,
            record_stats=False, metrics=False, maint_min_ops=10 ** 9,
            maint_max_ops=None))
        before = sti.LAUNCHES.count
        qids = []
        for rows in groups:
            qids += [rt.submit_query(queries[r]) for r in rows]
            rt.flush()
        rt.drain()
        out[backend] = ([rt.result(i) for i in qids],
                        rt.stats()["rounds_run"],
                        sti.LAUNCHES.count - before)
        rt.close()
        if backend == "device" and after_device is not None:
            after_device()
    return out


@contextlib.contextmanager
def patched(*swaps):
    """Set each (object, attribute, value) of ``swaps`` for the block and
    put the old values back after it."""
    old = [(obj, name, getattr(obj, name)) for obj, name, _ in swaps]
    for obj, name, value in swaps:
        setattr(obj, name, value)
    try:
        yield
    finally:
        for obj, name, value in old:
            setattr(obj, name, value)


def capture_rounds(real, calls, data_arg, by_ref, limit):
    """A stand-in for an indexed-scan wrapper ``real`` that records the
    operands of up to ``limit`` calls whose plain version fits in
    SERVE_PLAIN_BYTES of card memory (it gathers the union's rows of
    argument ``data_arg`` and widens them to f32), then launches as
    ``real`` does.  The snapshot's operands (positions ``by_ref``) are
    kept by reference, the round's own cloned."""
    def run(*a, **kw):
        codes, sel = a[data_arg], a[-2]
        elem = codes.element_size()
        need = (int(sel.shape[0]) * int(codes.shape[1]) * int(codes.shape[2])
                * (elem + (4 if elem != 4 else 0)))
        if len(calls) < limit and need <= SERVE_PLAIN_BYTES:
            calls.append(([t if i in by_ref else t.clone()
                           for i, t in enumerate(a)], dict(kw)))
        return real(*a, **kw)
    return run


def hold_rounds(name, calls, kern, plain, exact):
    """Hold each captured round's kernel result against its plain
    version (``compare_topk``; ``exact``: distances bit-equal).  Returns
    the check's record."""
    if not calls:
        fail(f"{name}: no round of the serving path was captured")
    errs, shapes = [], []
    for i, (a, kw) in enumerate(calls):
        dk, ik = kern(*a, **kw)
        dp, ip_ = plain(*a, **kw)
        b, u = int(a[-1].shape[0]), int(a[-2].shape[0])
        err, tol = compare_topk(f"{name} serving round {i} (B {b}, U {u}, "
                                f"k_pad {kw['k_pad']})", dk, ik, dp, ip_)
        if exact and err != 0.0:
            fail(f"{name} serving round {i}: distances differ from the "
                 f"plain version's by {err!r}, not 0")
        errs.append(err)
        shapes.append({"B": b, "U": u, "S": int(a[-3].shape[1]),
                       "k_pad": kw["k_pad"]})
    return {"rounds": len(calls), "max_abs_err": max(errs),
            "shapes": shapes}


def exact_ip(index, q, ids):
    """Exact f64 inner-product distances (-q.x) of the external ``ids``,
    in their order, from the index's host rows: the arbiter of a
    near-tie at the k-th distance."""
    import numpy as np
    lvl0 = index.levels[0]
    x = []
    for e in ids:
        j = index.id_map[int(e)]
        x.append(lvl0.vectors[j][np.nonzero(lvl0.ids[j] == e)[0][0]])
    return -(np.stack(x).astype(np.float64) @ q.astype(np.float64))


def run_serving(args, wl, dev, start_path, end_path) -> dict:
    """The online serving path: ``launch/serve.replay_runtime`` drives the
    Wikipedia-style workload through ``ServingRuntime`` (micro-batching
    with a 5 ms deadline ticker, riding probe rounds on the card, the
    result cache, drift-triggered maintenance, metrics, a WAL with
    checkpoints under a temporary directory); then a replay of the
    admission groups after the last write through both scan backends,
    the idle share of one warm flush, those queries again at int8
    storage, one more insert burst through a runtime re-attached to the
    WAL directory, and ``ServingRuntime.recover`` on that directory.

    Fails unless every query reaches a terminal status with no scan
    fault, every device round launched the indexed-scan kernel and no
    round ran on the host, every insert burst launched ``kmeans_assign``,
    the int8 leg launched the q8 kernel, the kernels agree with their
    plain versions on this path's own operands (the largest insert
    burst's assignment, the largest centroid pass and up to
    SERVE_CHECK_ROUNDS rounds of the f32 and the int8 scans; the int8
    scan bit-equal), the two backends return the same ids (a differing
    id only at a near-tie with the k-th distance, by exact f64 scores),
    and the recovery replays the WAL's insert into an index whose
    fingerprint equals the live one's."""
    import dataclasses
    import shutil
    import tempfile
    import numpy as np
    import torch
    from repro_torch.core import (QuakeConfig, QuakeIndex, ServingConfig,
                                  ServingRuntime)
    from repro_torch.core import serving as srv
    from repro_torch.faults import index_state_fingerprint
    from repro_torch.kernels import kmeans_assign as ka
    from repro_torch.kernels import scan_topk as st
    from repro_torch.kernels import scan_topk_indexed as sti
    from repro_torch.launch import serve
    k = SERVE_K
    card = card_line()
    out = {"card": card, "kernel_checks": {}}
    checks = out["kernel_checks"]
    # the months of this path: the workload's operations up to its
    # ``serve_months``-th query op
    ops, n_q = [], 0
    for op in wl.operations:
        if n_q == args.serve_months:
            break
        ops.append(op)
        n_q += op.kind == "query"
    wl = dataclasses.replace(wl, operations=ops)
    wal = tempfile.mkdtemp(prefix="quake_wal_")
    scfg = ServingConfig(k=k, recall_target=SERVE_TARGET, flush_size=256,
                         flush_deadline_ms=5.0, ticker=True,
                         cache_entries=4096, metrics=True,
                         scan_backend="auto", storage_dtype="f32",
                         planner=SERVE_PLANNER, wal_dir=wal, fsync="batch",
                         record_admissions=True)
    cfg = QuakeConfig(metric="ip", recall_target=SERVE_TARGET)
    # counted on the way: rounds served on the host, the kmeans_assign
    # launches of each insert burst, and the largest burst's operands
    host_rounds, insert_kmeans, in_insert, burst = [0], [], [False], {}
    real_host_scan, real_insert = srv.host_scan_round, QuakeIndex.insert
    real_assign = ka.kmeans_assign

    def counted_host_scan(*a, **kw):
        host_rounds[0] += 1
        return real_host_scan(*a, **kw)

    def counted_insert(self, *a, **kw):
        before = ka.LAUNCHES.count
        in_insert[0] = True
        try:
            return real_insert(self, *a, **kw)
        finally:
            in_insert[0] = False
            insert_kmeans.append(ka.LAUNCHES.count - before)

    def captured_assign(xs, cents, aux):
        size = int(xs.shape[0]) * int(cents.shape[0])
        if in_insert[0] and size > burst.get("size", 0):
            burst.update(size=size, args=(xs.clone(), cents.clone(),
                                          aux.clone()))
        return real_assign(xs, cents, aux)

    start_path()
    torch.cuda.reset_peak_memory_stats()
    t = time.perf_counter()
    with patched((srv, "host_scan_round", counted_host_scan),
                 (QuakeIndex, "insert", counted_insert),
                 (ka, "kmeans_assign", captured_assign)):
        summary = serve.replay_runtime(wl, cfg, scfg, verbose=False,
                                       device=dev, gt_device=dev)
    out["replay_s"] = time.perf_counter() - t
    out["replay_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["launches"] = end_path("serving", ())
    rt, index = summary["runtime"], summary["index"]
    st_ = summary["stats"]
    lat = np.asarray(summary["latencies_s"], dtype=np.float64)
    res = list(rt.results.values())
    rider_cells = sum(r.rounds for r in res)
    dstats = st_["durability"]
    n_queries, query_s = summary["n_queries"], summary["query_s"]
    stall_s = summary["query_maintenance_s"]
    durability_s = dstats["wal_append_s"] + dstats["checkpoint_s"]
    out.update(
        months=len(summary["recalls"]), queries=n_queries,
        recall_per_month=summary["recalls"],
        recall=float(np.mean(summary["recalls"])),
        p50_latency_ms=float(np.percentile(lat, 50)) * 1e3,
        p99_latency_ms=float(np.percentile(lat, 99)) * 1e3,
        serve_s=summary["serve_s"], query_s=query_s,
        qps=n_queries / query_s,
        query_maintenance_s=stall_s,
        search_s=query_s - stall_s,
        search_qps=n_queries / (query_s - stall_s),
        rounds=st_["rounds_run"], admitted_batches=st_["admitted_batches"],
        riders_per_round=rider_cells / max(st_["rounds_run"], 1),
        partitions_streamed=st_["partitions_streamed"],
        riding_savings=st_["riding_savings"],
        cache_hits=st_["cache_hits"],
        cache_hit_rate=st_["cache_hits"] / max(st_["queries_submitted"], 1),
        maintenance_passes=st_["maintenance_runs"],
        maintenance_reasons=st_["maintenance_reasons"],
        maintenance_s=rt.maintenance.snapshot()["pass_s"],
        maintenance_history=rt.maintenance.snapshot()["history"],
        partitions=index.num_partitions, vectors=index.num_vectors,
        wal_bytes=dstats["wal_bytes_written"],
        wal_appends=dstats["wal_appends"],
        checkpoints=dstats["checkpoints_written"],
        partitions_written=dstats["partitions_written"],
        partitions_linked=dstats["partitions_linked"],
        wal_s=dstats["wal_append_s"], checkpoint_s=dstats["checkpoint_s"],
        attach_s=dstats["attach_s"], durability_s=durability_s,
        durability_overhead=durability_s / summary["serve_s"],
        status_counts=st_["status_counts"], scan_faults=st_["scan_faults"],
        host_rounds=host_rounds[0], insert_kmeans_launches=insert_kmeans,
        calibration=summary.get("calibration"))
    print(f"serving [{card}]: {out['queries']} queries over {out['months']} "
          f"months, {out['vectors']} vectors in {out['partitions']} "
          f"partitions at the end; replay {out['replay_s']:.1f} s, peak "
          f"device memory {out['replay_peak_gb']:.2f} GB")
    print(f"serving [{card}]: recall@{k} per month "
          + " ".join(f"{r:.4f}" for r in out["recall_per_month"])
          + f"; overall {out['recall']!r}")
    per_month = lat[:len(lat) // out["months"] * out["months"]].reshape(
        out["months"], -1) * 1e3
    out["latency_ms_per_month"] = [
        {"p50": float(np.percentile(m, 50)), "p99": float(np.percentile(m, 99)),
         "max": float(m.max())} for m in per_month]
    print(f"serving [{card}]: submit-to-result latency p50 "
          f"{out['p50_latency_ms']!r} ms, p99 {out['p99_latency_ms']!r} ms; "
          f"per month p50/p99/max ms "
          + " ".join(f"{m['p50']:.1f}/{m['p99']:.1f}/{m['max']:.1f}"
                     for m in out["latency_ms_per_month"]))
    print(f"serving [{card}]: end to end {out['qps']!r} queries/s (all "
          f"{n_queries} queries over the {query_s!r} s of query ops, the "
          f"maintenance and checkpoints inside them included; "
          f"{out['serve_s']!r} s with writes); per layer, the query ops "
          f"without the {stall_s!r} s of maintenance passes and "
          f"checkpoints that ran inside them: {out['search_qps']!r} "
          f"queries/s over {out['search_s']!r} s")
    print(f"serving [{card}]: {out['rounds']} rounds for "
          f"{out['admitted_batches']} admitted batches, "
          f"{out['riders_per_round']!r} riders a round, riding savings "
          f"{out['riding_savings']!r}; cache hits {out['cache_hits']} "
          f"(rate {out['cache_hit_rate']!r})")
    print(f"serving [{card}]: {out['maintenance_passes']} maintenance passes "
          f"({', '.join(out['maintenance_reasons']) or 'none'}), seconds "
          + " ".join(f"{s:.3f}" for s in out["maintenance_s"]))
    print(f"serving [{card}]: WAL {out['wal_bytes']} bytes in "
          f"{out['wal_appends']} appends, {out['checkpoints']} checkpoints "
          f"({out['partitions_written']} partitions written, "
          f"{out['partitions_linked']} linked); durability "
          f"{out['durability_s']!r} s (WAL appends {out['wal_s']!r}, "
          f"checkpoints {out['checkpoint_s']!r}) = "
          f"{out['durability_overhead']!r} of the serve time; the "
          f"attach's baseline checkpoint {out['attach_s']!r} s before it")
    print(f"serving [{card}]: statuses {out['status_counts']}, scan faults "
          f"{out['scan_faults']}, host rounds {out['host_rounds']}, "
          f"kmeans_assign launches per insert burst "
          f"{out['insert_kmeans_launches']}")
    for name in ("scan_topk_indexed", "scan_topk", "kmeans_assign"):
        if out["launches"][name] <= 0:
            fail(f"kernel {name} was not launched on the serving path")
    n_sub = st_["queries_submitted"]
    if sum(st_["status_counts"].values()) != n_sub or \
            len(rt.results) != n_sub:
        fail(f"serving: {len(rt.results)} results and "
             f"{sum(st_['status_counts'].values())} terminal statuses for "
             f"{n_sub} queries")
    if st_["status_counts"]["OK"] != n_sub or st_["scan_faults"]:
        fail(f"serving: statuses {st_['status_counts']}, scan faults "
             f"{st_['scan_faults']} with no injector set")
    if rt.scheduler.scan_backend != "device" or host_rounds[0]:
        fail(f"serving: backend {rt.scheduler.scan_backend}, "
             f"{host_rounds[0]} rounds on the host")
    if out["launches"]["scan_topk_indexed"] < st_["rounds_run"] or \
            not st_["rounds_run"]:
        fail(f"serving: {out['launches']['scan_topk_indexed']} indexed-scan "
             f"launches for {st_['rounds_run']} device rounds")
    n_inserts = sum(op.kind == "insert" for op in wl.operations)
    if len(insert_kmeans) != n_inserts or min(insert_kmeans, default=0) < 1:
        fail(f"serving: kmeans_assign launches per insert burst "
             f"{insert_kmeans} for {n_inserts} bursts")

    # the assignment of the largest insert burst, against its plain version
    if "args" not in burst:
        fail("serving: no insert burst's assignment was captured")
    xs_b, c_b, aux_b = burst.pop("args")
    err, tol, _ = hold_assign(
        ka, f"kmeans_assign at the largest serving insert burst (N "
        f"{xs_b.shape[0]}, C {c_b.shape[0]})", xs_b, c_b, aux_b)
    checks["kmeans_assign"] = {"max_abs_err": err, "tol": tol, "shape": {
        "N": int(xs_b.shape[0]), "C": int(c_b.shape[0]),
        "d": int(xs_b.shape[1])}}
    print(f"kmeans_assign at the largest serving insert burst: err "
          f"{err:.3g} (tol {tol:.3g})")
    del xs_b, c_b, aux_b

    # the queries admitted after the last write, replayed single-threaded
    # from the admission log through both backends; qid i is the i-th
    # query submitted, so the workload's query ops give each qid's vector
    allq = np.concatenate([op.queries for op in wl.operations
                           if op.kind == "query"]).astype(np.float32)
    if len(allq) != n_sub:
        fail(f"serving: {len(allq)} workload queries, {n_sub} submitted")
    log = rt.admission_log()
    last = max(i for i, e in enumerate(log) if e[0] != "q") \
        if any(e[0] != "q" for e in log) else -1
    groups_q = [list(e[1]) for e in log[last + 1:] if e[0] == "q"]
    order = [qid for g in groups_q for qid in g]
    qs = allq[order]
    pos = {qid: i for i, qid in enumerate(order)}
    groups = [[pos[qid] for qid in g] for g in groups_q]
    # the device leg's rounds and centroid passes are captured and held
    # against the plain versions while its snapshot is still alive
    f32_calls, dense = [], {}
    real_dense = st.scan_topk

    def captured_dense(queries, xs, valid=None, **kw):
        size = int(queries.shape[0]) * int(xs.shape[0])
        if size > dense.get("size", 0):
            dense.update(size=size, kw=dict(kw), args=(
                queries.clone(), xs.clone(),
                None if valid is None else valid.clone()))
        return real_dense(queries, xs, valid, **kw)

    def hold_device_rounds():
        checks["scan_topk_indexed"] = hold_rounds(
            "scan_topk_indexed", f32_calls, sti.scan_topk_indexed_cuda,
            sti.scan_topk_indexed_plain, exact=False)
        f32_calls.clear()
        torch.cuda.empty_cache()
    t = time.perf_counter()
    with patched((sti, "scan_topk_indexed", capture_rounds(
            sti.scan_topk_indexed, f32_calls, 1, {1, 2},
            SERVE_CHECK_ROUNDS)), (st, "scan_topk", captured_dense)):
        agree = serving_agreement(index, qs, groups, k,
                                  after_device=hold_device_rounds)
    out["agreement_s"] = time.perf_counter() - t
    if "args" not in dense:
        fail("serving: no centroid pass was captured")
    dq, dx, dv = dense.pop("args")
    dk, ik = st.scan_topk_cuda(dq, dx, dv, **dense["kw"])
    dp, ip_ = st.scan_topk_plain(dq, dx, dv, **dense["kw"])
    err, tol = compare_topk(
        f"scan_topk at the largest serving centroid pass (Q {dq.shape[0]}, "
        f"N {dx.shape[0]}, k_pad {dense['kw']['k_pad']})", dk, ik, dp, ip_)
    checks["scan_topk"] = {"max_abs_err": err, "tol": tol, "shape": {
        "Q": int(dq.shape[0]), "N": int(dx.shape[0]), "d": int(dx.shape[1]),
        "k_pad": dense["kw"]["k_pad"]}}
    del dq, dx, dv, dk, ik, dp, ip_
    (res_d, rounds_d, launch_d), (res_h, _, launch_h) = \
        agree["device"], agree["host"]
    strict = ties = 0
    for i, (a, b) in enumerate(zip(res_d, res_h)):
        if a.status != "OK" or b.status != "OK" or a.nprobe != b.nprobe:
            fail(f"serving agreement: query {i} statuses {a.status}/"
                 f"{b.status}, nprobe {a.nprobe}/{b.nprobe}")
        sa, sb = set(a.ids.tolist()), set(b.ids.tolist())
        if sa == sb:
            continue
        strict += 1
        # the k-th distance: the worst exact distance of either list
        kth = max(float(exact_ip(index, qs[i], a.ids).max()),
                  float(exact_ip(index, qs[i], b.ids).max()))
        tol = 2 * (SERVE_TIE_REL * abs(kth) + SERVE_TIE_ABS)
        diff = sorted(sa ^ sb)
        ed = exact_ip(index, qs[i], diff)
        if (np.abs(ed - kth) > tol).any():
            fail(f"serving agreement: query {i}: ids {sorted(sa ^ sb)} "
                 f"differ away from the k-th distance {kth!r} "
                 f"(exact {ed.tolist()})")
        ties += 1
    if launch_d < rounds_d or launch_h:
        fail(f"serving agreement: device launches {launch_d} for "
             f"{rounds_d} rounds, host launches {launch_h}")
    out["agreement"] = {"queries": len(order), "groups": len(groups),
                        "differing_sets": strict, "at_near_ties": ties}
    print(f"serving [{card}]: the {len(order)} queries after the last "
          f"write, in "
          f"{len(groups)} admission groups replayed through both backends: "
          f"{strict} id sets differ, all at near-ties of the k-th "
          f"distance ({out['agreement_s']:.1f} s)")

    # one warm flush under torch.profiler: the device's idle share
    prof_rt = ServingRuntime(index, ServingConfig(
        k=k, recall_target=SERVE_TARGET, flush_size=10 ** 9, ticker=False,
        planner=SERVE_PLANNER, record_stats=False, maint_min_ops=10 ** 9,
        maint_max_ops=None))
    q256 = qs[:256]

    def one_flush():
        prof_rt.submit_batch(q256)
        prof_rt.drain()
    out["profile_flush"] = profile_call(one_flush, "serving_flush")
    prof_rt.close()

    # those queries at int8 storage: the q8 kernel serves the rounds
    start_path()
    rt8 = ServingRuntime(index, ServingConfig(
        k=k, recall_target=SERVE_TARGET, flush_size=256, ticker=False,
        storage_dtype="int8", planner=SERVE_PLANNER, record_stats=False,
        maint_min_ops=10 ** 9, maint_max_ops=None))
    q8_calls = []
    t = time.perf_counter()
    with patched((sti, "scan_topk_indexed_q8", capture_rounds(
            sti.scan_topk_indexed_q8, q8_calls, 2, {2, 3, 6},
            SERVE_CHECK_ROUNDS))):
        qids = rt8.submit_batch(qs)
        rt8.drain()
    out["int8_s"] = time.perf_counter() - t
    st8 = rt8.stats()
    res8 = [rt8.result(i) for i in qids]
    out["int8_launches"] = end_path("serving_int8", ("scan_topk_indexed_q8",))
    checks["scan_topk_indexed_q8"] = hold_rounds(
        "scan_topk_indexed_q8", q8_calls, sti.scan_topk_indexed_q8_cuda,
        sti.scan_topk_indexed_q8_plain, exact=True)
    del q8_calls
    rt8.close()
    torch.cuda.empty_cache()
    ov = overlap(np.stack([r.ids for r in res8]),
                 np.stack([r.ids for r in res_d]))
    out["int8"] = {"rounds": st8["rounds_run"], "overlap_f32": ov,
                   "statuses": st8["status_counts"]}
    print(f"serving [{card}]: int8: {len(qids)} queries, "
          f"{st8['rounds_run']} rounds, "
          f"{out['int8_launches']['scan_topk_indexed_q8']} q8 launches, ids "
          f"overlap the f32 backend's by {ov!r} ({out['int8_s']:.1f} s)")
    if out["int8_launches"]["scan_topk_indexed_q8"] < st8["rounds_run"] \
            or not st8["rounds_run"]:
        fail("serving: int8 storage did not launch the q8 kernel each "
             "round")
    if st8["status_counts"]["OK"] != len(qids):
        fail(f"serving: int8 statuses {st8['status_counts']}")
    if ov < INT8_OVERLAP:
        fail(f"serving: int8 overlaps f32 by {ov:.4f} < {INT8_OVERLAP}")

    # one more insert burst after the last checkpoint (the served run's
    # last maintenance pass checkpointed after its last insert): fresh
    # ids, rows of the data with seeded noise, through a runtime
    # re-attached to the WAL directory (its attach writes a baseline
    # checkpoint); then recovery on the card must replay that insert
    # from the WAL and land on the live fingerprint
    rng = np.random.default_rng(args.seed + 7)
    data = wl.dataset.vectors
    n_new = args.insert
    new_x = (data[rng.integers(0, len(data), n_new)]
             + 0.01 * rng.standard_normal((n_new, data.shape[1]))
             ).astype(np.float32)
    new_ids = np.arange(len(data), len(data) + n_new, dtype=np.int64)
    rt_w = ServingRuntime(index, ServingConfig(
        k=k, ticker=False, wal_dir=wal, fsync="batch", record_stats=False,
        metrics=False, maint_min_ops=10 ** 9, maint_max_ops=None))
    rt_w.submit_insert(new_x, new_ids)
    rt_w.close()
    live = index_state_fingerprint(index)
    t = time.perf_counter()
    rt2 = ServingRuntime.recover(wal, ServingConfig(k=k, ticker=False),
                                 device=dev)
    out["recovery_s"] = time.perf_counter() - t
    rep = rt2.recovery_report
    out["recovery"] = dataclasses.asdict(rep)
    got = index_state_fingerprint(rt2.index)
    n_rec = rt2.index.num_vectors
    rt2.close()
    del rt2
    print(f"serving [{card}]: recovered generation {rep.generation} + "
          f"{rep.records_replayed} WAL records ({rep.inserts_replayed} "
          f"inserts, {n_new} vectors) to {n_rec} vectors in "
          f"{out['recovery_s']!r} s (with the re-attach's baseline "
          f"checkpoint); fingerprint "
          f"{'equals' if got == live else 'DIFFERS FROM'} the live one")
    if rep.inserts_replayed < 1:
        fail("serving: the recovery replayed no insert from the WAL")
    if got != live:
        fail("serving: the recovered index's fingerprint differs from the "
             "live index's")
    shutil.rmtree(wal, ignore_errors=True)
    return out


def hold_assign(ka, name, xs, cents, aux):
    """Hold ``kmeans_assign`` against its plain version on (xs, cents,
    aux): every minimum within TOL_REL * |d| + TOL_ABS, and the same
    centroid wherever the two nearest lie more than twice that apart.
    Returns (largest |diff|, largest tolerance, the plain assignment)."""
    import torch
    ak, dk = ka.kmeans_assign_cuda(xs, cents, aux)
    ap, dp = ka.kmeans_assign_plain(xs, cents, aux)
    tol_x = TOL_REL * dp.abs() + TOL_ABS
    err, tol = float((dk - dp).abs().max()), float(tol_x.max())
    if bool(((dk - dp).abs() > tol_x).any()):
        fail(f"{name}: minima beyond their tolerance, max |diff| {err:.3g}")
    if cents.shape[0] > 1:
        dist = aux[None] - 2.0 * (xs @ cents.T)
        two = torch.topk(dist, 2, dim=1, largest=False).values
        clear = (two[:, 1] - two[:, 0]) > 2 * tol_x
        if bool(((ak != ap) & clear).any()):
            fail(f"{name}: assignments differ away from ties")
    return err, tol, ap


def check_close(name, got, ref, rel, abs_):
    """Fail unless every entry of ``got`` is within ``rel * |ref| + abs_``
    of ``ref`` (and finite); returns the largest |diff|."""
    import torch
    got, ref = got.double(), ref.double()
    if not bool(torch.isfinite(got).all()):
        fail(f"{name}: non-finite values")
    diff = (got - ref).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    over = diff > rel * ref.abs() + abs_
    if bool(over.any()):
        fail(f"{name}: {int(over.sum())} of {diff.numel()} entries beyond "
             f"{rel:g}*|x| + {abs_:g}, max |diff| {err:.3g}")
    print(f"{name}: max |diff| {err:.3g} (bound {rel:g}*|x| + {abs_:g})")
    return err


def flash_bound(b, sq, sk, h, kh, d, causal, elem):
    """(bound_ms, bound_by) of one attention call: q, k, v read and the
    output written once; 4 d operations per live (query, key) pair and
    head, at the bf16 tensor-core rate (elem 2) or the f32 rate of the
    CUDA cores (elem 4: the f32 kernel's contract rules out TF32)."""
    if causal:   # query i sees keys 0..min(i, sk - 1)
        m = min(sq, sk)
        pairs = m * (m + 1) // 2 + (sq - m) * sk
    else:
        pairs = sq * sk
    nbytes = (2 * b * sq * h * d + 2 * b * sk * kh * d) * elem
    return bound(nbytes, 4.0 * b * h * d * pairs,
                 BF16_FLOPS_PER_S if elem == 2 else F32_FLOPS_PER_S)


def run_lm(args, dev, start_path, end_path):
    """The LM serving path: exact f32 checks at full width and two layers
    (kernel against plain attention, decode against re-prefill), then the
    served model at full width and depth in bf16 (prefill of the prompts,
    greedy decode, launch gates, a re-prefill check, the flash kernel's
    share of a warm prefill), then the kernel against its plain version
    at the captured and the JAX tests' shapes, and its time at one
    LM_TIME_LEN-token request.  Returns (record, kernels-line row)."""
    import dataclasses
    import numpy as np
    import torch
    from torch.nn import functional as F
    from repro_torch.configs import lm_archs
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.models import Transformer, param_count
    torch.cuda.reset_peak_memory_stats()
    out = {}
    base = getattr(lm_archs, LM_CONFIG)()
    h, kh, dh, vocab = (base.n_heads, base.n_kv_heads, base.head_dim,
                        base.vocab_size)

    def plain_attention(q, k, v, *, causal, q_block, k_block):
        qb, kb = fa.TILES[q.dtype]
        return fa.flash_attention_plain(q, k, v, causal=causal,
                                        q_block=qb, k_block=kb)

    # -- exact f32 checks: full width, two layers -------------------------
    cfg32 = dataclasses.replace(base, n_layers=2, param_dtype=torch.float32,
                                compute_dtype=torch.float32)
    g = torch.Generator(device=dev).manual_seed(args.seed + 1)
    m32 = Transformer(cfg32, device=dev, generator=g)
    s32, steps32 = 512, 4
    toks = torch.randint(0, vocab, (2, s32 + steps32), generator=g,
                         device=dev)
    lg_k, (ck, cv) = m32.prefill(toks[:, :s32])
    before = fa.LAUNCHES.count
    lg_p, _ = m32.prefill(toks[:, :s32], attention=plain_attention)
    if fa.LAUNCHES.count != before:
        fail(f"lm f32 prefill with plain attention launched the flash "
             f"kernel {fa.LAUNCHES.count - before} times")
    errs = {"f32_prefill_kernel_vs_plain": check_close(
        "lm f32 prefill logits, kernel vs plain attention", lg_k, lg_p,
        LM_TOL, LM_TOL)}
    pad = (0, 0, 0, 0, 0, steps32)
    ck, cv = F.pad(ck, pad), F.pad(cv, pad)
    for t in range(s32, s32 + steps32):
        lg_d, (ck, cv) = m32.decode_step(
            toks[:, t], ck, cv, torch.full((2,), t, device=dev))
        lg_r, _ = m32.prefill(toks[:, :t + 1])
        errs[f"f32_decode_vs_reprefill@{t}"] = check_close(
            f"lm f32 decode at position {t} vs re-prefill", lg_d, lg_r,
            LM_TOL, LM_TOL)
    out["f32_checks"] = errs
    del m32, ck, cv, lg_k, lg_p, lg_d, lg_r
    torch.cuda.empty_cache()

    # -- serving at full width and depth, bf16 ----------------------------
    cfg = dataclasses.replace(base, param_dtype=torch.bfloat16,
                              compute_dtype=torch.bfloat16)
    n_l, b, s, n_dec = cfg.n_layers, LM_PROMPTS, LM_PROMPT_LEN, LM_DECODE
    start_path()
    g = torch.Generator(device=dev).manual_seed(args.seed)
    torch.cuda.synchronize()
    t = time.perf_counter()
    model = Transformer(cfg, device=dev, generator=g)
    torch.cuda.synchronize()
    out["build_s"] = time.perf_counter() - t
    weight_gb = sum(p.numel() * p.element_size()
                    for p in model.parameters()) / 1e9
    print(f"lm: {LM_CONFIG} at {n_l} layers, d_model {cfg.d_model}, "
          f"{h}/{kh} heads of {dh}, bf16: {param_count(cfg)} parameters, "
          f"{weight_gb:.2f} GB, built in {out['build_s']:.2f} s")
    prompts = torch.randint(0, vocab, (b, s), generator=g, device=dev)
    captured, calls = {}, [0]

    def capture(q, k, v, **kw):
        if calls[0] in (0, n_l - 1):
            captured[calls[0]] = (q.clone(), k.clone(), v.clone())
        calls[0] += 1
        return fa.flash_attention(q, k, v, **kw)

    before = fa.LAUNCHES.count
    torch.cuda.synchronize()
    t = time.perf_counter()
    logits, (ck, cv) = model.prefill(prompts, attention=capture)
    torch.cuda.synchronize()
    out["prefill_s"] = time.perf_counter() - t
    prefill_launches = fa.LAUNCHES.count - before
    if tuple(logits.shape) != (b, vocab) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"lm prefill: logits of shape {tuple(logits.shape)} or not "
             f"finite")
    shape = (n_l, b, s + n_dec, kh, dh)
    ckp = torch.zeros(shape, dtype=ck.dtype, device=dev)
    cvp = torch.zeros(shape, dtype=cv.dtype, device=dev)
    ckp[:, :, :s], cvp[:, :, :s] = ck, cv
    del ck, cv
    out["cache_gb"] = 2 * ckp.numel() * ckp.element_size() / 1e9
    tok = logits.argmax(-1)
    gen, step_ms, dec_launches = [tok], [], []
    cache_len = torch.full((b,), s, device=dev)
    for i in range(n_dec):
        before = fa.LAUNCHES.count
        torch.cuda.synchronize()
        t = time.perf_counter()
        lg, _ = model.decode_step(tok, ckp, cvp, cache_len)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t) * 1e3)
        dec_launches.append(fa.LAUNCHES.count - before)
        if not bool(torch.isfinite(lg).all()):
            fail(f"lm decode step {i + 1}: non-finite logits")
        if i == 7:
            lg8 = lg.clone()
        tok = lg.argmax(-1)
        gen.append(tok)
        cache_len += 1
    got = end_path("lm", ("flash_attention",))
    warm = step_ms[2:] or step_ms
    out.update(prefill_launches=prefill_launches,
               decode_launches=dec_launches, decode_ms=step_ms,
               decode_ms_mean=float(np.mean(warm)),
               decode_ms_worst=float(np.max(warm)))
    print(f"lm prefill of {b} x {s} tokens: {out['prefill_s']:.3f} s "
          f"(first call), {prefill_launches} flash launches; decode "
          f"{n_dec} steps: {out['decode_ms_mean']:.2f} ms a step (mean "
          f"after 2 warm-up steps), worst {out['decode_ms_worst']:.2f} ms, "
          f"flash launches per step {sorted(set(dec_launches))}")
    if prefill_launches != n_l or got["flash_attention"] != n_l:
        fail(f"lm: {prefill_launches} flash launches in the prefill, "
             f"{got['flash_attention']} on the path, not {n_l}")
    if any(dec_launches):
        fail("lm: a decode step launched the flash kernel")

    torch.cuda.synchronize()
    t = time.perf_counter()
    model.prefill(prompts)
    torch.cuda.synchronize()
    out["prefill_warm_s"] = time.perf_counter() - t
    out["prefill_tokens_per_s"] = b * s / out["prefill_warm_s"]
    print(f"lm warm prefill: {out['prefill_warm_s']:.3f} s, "
          f"{out['prefill_tokens_per_s']:.0f} tokens/s")
    prof = profile_call(lambda: model.prefill(prompts), "prefill",
                          "flash_fwd_bf16_mma_kernel")
    if prof["device_busy_ms"]:
        prof["flash_share"] = prof["match_ms"] / prof["device_busy_ms"]
        print(f"lm: the flash kernel takes {prof['match_ms']:.1f} ms of "
              f"the warm prefill's {prof['device_busy_ms']:.1f} ms of "
              f"device time ({prof['flash_share']:.1%})")
    out["profile"] = prof

    # one more step, rewriting the last position: where a step's time goes
    out["decode_profile"] = profile_call(
        lambda: model.decode_step(tok, ckp, cvp, cache_len - 1),
        "decode_step")

    if n_dec >= 8:   # decode step 8 against a prefill over prompt + g1..g8
        lg_re, _ = model.prefill(torch.cat([prompts, torch.stack(gen[:8],
                                                                 1)], 1))
        out["reprefill_check"] = {
            "cosine_min": float(F.cosine_similarity(lg_re, lg8, -1).min()),
            "max_abs_diff": float((lg_re - lg8).abs().max()),
            "top1_agree": float((lg_re.argmax(-1) == lg8.argmax(-1))
                                .float().mean())}
        print(f"lm bf16 decode step 8 vs re-prefill (ungated): "
              f"{out['reprefill_check']}")
    out["peak_gb_serving"] = torch.cuda.max_memory_allocated() / 1e9
    del model, ckp, cvp
    torch.cuda.empty_cache()

    # -- the kernel against its plain version ------------------------------
    errs = {}
    bq, bk = fa.TILES[torch.bfloat16]
    for layer, (q, k, v) in sorted(captured.items()):
        o_k = fa.flash_attention_cuda(q, k, v, causal=True)
        o_p, plain_ms = timed(lambda: fa.flash_attention_plain(
            q, k, v, causal=True, q_block=bq, k_block=bk))
        errs[f"bf16_layer{layer}"] = check_close(
            f"flash_attention bf16, layer {layer}'s operands", o_k, o_p,
            FLASH_BF16_REL, FLASH_BF16_ABS)
        if layer == 0:
            layer0_plain_ms = plain_ms
    q, k, v = captured[0]
    ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True),
                 reps=5, warmup=1)
    views = [x.transpose(1, 2) for x in (q, k, v)]
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        *views, is_causal=True, enable_gqa=True), reps=5, warmup=1)
    bound_ms, bound_by = flash_bound(b, s, s, h, kh, dh, True, 2)
    gs = torch.Generator(device=dev).manual_seed(args.seed + 2)
    fq, fk = fa.TILES[torch.float32]
    for (bb, hh, kk, sq, sk, d, causal) in [
            (2, 8, 1, 96, 96, 32, True), (1, 8, 2, 128, 128, 64, True),
            (2, 4, 4, 100, 120, 32, False), (1, 6, 2, 64, 256, 16, True)]:
        qs = torch.randn((bb, sq, hh, d), generator=gs, device=dev)
        ks = torch.randn((bb, sk, kk, d), generator=gs, device=dev)
        vs = torch.randn((bb, sk, kk, d), generator=gs, device=dev)
        errs[f"f32_{bb}x{sq}x{sk}x{hh}/{kk}x{d}_{causal}"] = check_close(
            f"flash_attention f32 {(bb, hh, kk, sq, sk, d, causal)}",
            fa.flash_attention_cuda(qs, ks, vs, causal=causal),
            fa.flash_attention_plain(qs, ks, vs, causal=causal,
                                     q_block=fq, k_block=fk),
            FLASH_F32_TOL, FLASH_F32_TOL)
    # the f32 kernel (CUDA cores) at the exact checks' served shape: one
    # layer's operands of the f32 prefill, 2 x 512 tokens at full width
    q32, k32, v32 = (torch.randn((2, 512, n, dh), generator=gs, device=dev)
                     for n in (h, kh, kh))
    f32_ms = cuda_ms(lambda: fa.flash_attention_cuda(q32, k32, v32,
                                                     causal=True))
    f32_bound, f32_by = flash_bound(2, 512, 512, h, kh, dh, True, 4)
    views32 = [x.transpose(1, 2) for x in (q32, k32, v32)]
    f32_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        *views32, is_causal=True, enable_gqa=True))
    f32_row = {"shape": {"B": 2, "S": 512, "H": h, "KH": kh, "D": dh},
               "ms": f32_ms, "bound_ms": f32_bound, "bound_by": f32_by,
               "library_ms": f32_lib_ms}
    print(f"flash_attention f32 kernel: {f32_ms:.4f} ms at "
          f"{(2, 512, h, kh, dh)} (library {f32_lib_ms:.4f} ms, bound "
          f"{f32_bound:.4f} ms)")
    del captured, q, k, v, views, q32, k32, v32, views32
    torch.cuda.empty_cache()

    # -- one request at LM_TIME_LEN tokens, one layer ----------------------
    n = LM_TIME_LEN
    q = torch.randn((1, n, h, dh), generator=gs, device=dev).bfloat16()
    k = torch.randn((1, n, kh, dh), generator=gs, device=dev).bfloat16()
    v = torch.randn((1, n, kh, dh), generator=gs, device=dev).bfloat16()
    long_ms = cuda_ms(lambda: fa.flash_attention_cuda(q, k, v, causal=True),
                      reps=3, warmup=1)
    o_k = fa.flash_attention_cuda(q, k, v, causal=True)
    o_p, long_plain_ms = timed(lambda: fa.flash_attention_plain(
        q, k, v, causal=True, q_block=bq, k_block=bk))
    long_err = check_close(f"flash_attention bf16 at 1 x {n} tokens", o_k,
                           o_p, FLASH_BF16_REL, FLASH_BF16_ABS)
    del o_k, o_p
    views = [x.transpose(1, 2) for x in (q, k, v)]
    long_lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
        *views, is_causal=True, enable_gqa=True), reps=3, warmup=1)
    long_bound, long_by = flash_bound(1, n, n, h, kh, dh, True, 2)
    long = {"shape": {"B": 1, "S": n, "H": h, "KH": kh, "D": dh},
            "ms": long_ms, "plain_ms": long_plain_ms,
            "library_ms": long_lib_ms, "bound_ms": long_bound,
            "bound_by": long_by, "max_abs_err": long_err}
    print(f"flash_attention: {ms:.3f} ms at {(b, s, h, kh, dh)} (plain "
          f"{layer0_plain_ms:.1f}, library {lib_ms:.3f}, bound "
          f"{bound_ms:.3f} ms by {bound_by}); {long_ms:.3f} ms at "
          f"{(1, n, h, kh, dh)} (plain {long_plain_ms:.1f}, library "
          f"{long_lib_ms:.3f}, bound {long_bound:.3f} ms)")
    del q, k, v, views
    torch.cuda.empty_cache()
    out.update(checks=errs, at_time_len=long,
               peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    print(f"lm path: peak device memory {out['peak_gb']:.2f} GB "
          f"(serving {out['peak_gb_serving']:.2f} GB)")
    row = {
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:99",
        "launches": got["flash_attention"],
        "max_abs_err": max(errs[f"bf16_layer{i}"] for i in (0, n_l - 1)),
        "tol": f"{FLASH_BF16_REL:g}*|o| + {FLASH_BF16_ABS:g}",
        "ms": ms, "plain_ms": layer0_plain_ms, "bound_ms": bound_ms,
        "bound_by": bound_by, "library_ms": lib_ms,
        "library": "F.scaled_dot_product_attention(is_causal, enable_gqa)",
        "shape": {"B": b, "S": s, "H": h, "KH": kh, "D": dh},
        "at_time_len": long, "f32": f32_row}
    return out, row


if __name__ == "__main__":
    sys.exit(main())

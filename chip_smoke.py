#!/usr/bin/env python3
"""Drive the PyTorch port's main path on one NVIDIA GPU and check it.

    python3 chip_smoke.py [--n 1000000] [--batch 1024] [--seed 0]

With no arguments it runs the SIFT1M-shaped cell: 1,000,000 clustered
synthetic vectors of d=128 (L2; a mixture of 8192 Gaussian clusters with
sizes proportional to i^-0.5, about eight clusters per partition),
``QuakeIndex.build`` with P = sqrt(n) = 1000 partitions, ``search_batch``
of B=1024 queries at k=100 and recall target 0.9 (the vectorized
planner, the fused planner, ``nprobe=32, rounds=1`` and bf16 storage), an
insert burst of 10,000 vectors and 5,000 deletes, and a search again.  It
then holds each CUDA kernel against its plain PyTorch version at the
shapes the main path gave it, times both and a one-library-call
yardstick, profiles one warm ``search_batch``, and prints one JSON line
of kernels, the card's name and power limit, and a last JSON line with
the device.

It exits non-zero, printing no result, when CUDA is unavailable or the
port is not beside it, and on any failed check.  Detailed records go to
``chiprun_out/chip_smoke/``.
"""
from __future__ import annotations

import argparse
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


def profile_search(fn) -> dict:
    """Device busy time of one call of ``fn`` under torch.profiler, beside
    its wall time, and the kernels that took the most device time."""
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
    prof.export_chrome_trace(str(OUT_DIR / "search_batch_trace.json"))
    out = {"wall_ms_profiled": wall_ms,
           "device_busy_ms": busy_ms if rows else None,
           "idle_share": 1.0 - busy_ms / wall_ms if rows else None,
           "top": [{"name": k[:80], "calls": c, "device_ms": ms}
                   for ms, c, k in rows[:12]]}
    print(f"profile of one warm search_batch: wall {wall_ms:.1f} ms, "
          f"device busy {busy_ms:.1f} ms" if rows else
          "profile: the profiler saw no device time (not measured)")
    for r in out["top"]:
        print(f"  {r['device_ms']:8.3f} ms {r['calls']:5d}x {r['name']}")
    return out


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
        from repro_torch.kernels import build, ops
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

    # ---- main path ------------------------------------------------------
    steps, step_launches = {}, {}
    counters = {"scan_topk_indexed": sti.LAUNCHES, "scan_topk": st.LAUNCHES,
                "kmeans_assign": ka.LAUNCHES}

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

    ds = step("data", lambda: datasets.clustered(
        args.n, args.dim, n_clusters=args.clusters, power=args.power,
        seed=args.seed))
    q = datasets.queries_near(ds, args.batch, seed=args.seed + 1)
    gt = step("ground_truth", lambda: ds.ground_truth(q, args.k,
                                                      device=dev))
    for c in counters.values():
        c.reset()
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

    # insert burst: new vectors near the members of a few partitions (new
    # content on a few topics), and deletes of older vectors there
    rng = np.random.default_rng(args.seed + 2)
    lvl0 = idx.levels[0]
    sizes = lvl0.sizes()
    hot = rng.choice(np.nonzero(sizes >= 64)[0], size=20, replace=False)
    pool = np.concatenate([lvl0.vectors[j] for j in hot])
    new_x = (pool[rng.integers(0, len(pool), args.insert)]
             + rng.normal(size=(args.insert, args.dim)).astype(np.float32)
             * 0.1).astype(np.float32)
    new_ids = np.arange(args.n, args.n + args.insert, dtype=np.int64)
    old_ids = np.concatenate([lvl0.ids[j] for j in hot])
    del_ids = rng.choice(old_ids, size=min(args.delete, len(old_ids)),
                         replace=False)
    step("insert", lambda: idx.insert(new_x, new_ids))
    removed = step("delete", lambda: idx.delete(del_ids))
    if removed != len(del_ids):
        fail(f"deleted {removed} of {len(del_ids)}")
    keep = np.ones(args.n, dtype=bool)
    keep[del_ids] = False
    live_ids = np.concatenate([np.nonzero(keep)[0], new_ids])
    ds2 = datasets.VectorDataset(
        np.concatenate([ds.vectors[keep], new_x]),
        np.zeros(len(live_ids), dtype=np.int64), ds.centers)
    q2 = np.concatenate([q[: args.batch // 2], new_x[: args.batch
                                                     - args.batch // 2]])
    gt = live_ids[ds2.ground_truth(q2, args.k, device=dev)]
    ex = get_executor(idx)
    search("search_after_update",
           lambda: idx.search_batch(q2, args.k, recall_target=0.9),
           APS_RECALL_MIN)
    launches = {n: c.count for n, c in counters.items()}
    print(f"launches on the main path: {launches}")
    print(f"f32 executor: delta_refreshes {ex.delta_refreshes}, "
          f"full_rebuilds {ex.full_rebuilds}")
    if ex.delta_refreshes != 1 or ex.full_rebuilds != 1:
        fail("the update should refresh the snapshot by one delta")
    for name, n in launches.items():
        if n <= 0:
            fail(f"kernel {name} was not launched on the main path")
    idx.check_invariants()
    record.update(steps=steps, step_launches=step_launches, runs=runs,
                  launches=launches,
                  snapshot={"P": int(ex._snap.num_partitions),
                            "S_cap": int(ex._snap.capacity)})

    # ---- kernels vs their plain versions, at the main path's shapes -----
    kernels = []
    snap = ex.snapshot()
    valid = ex._valid
    plan = plan_batch(idx, q, args.k, recall_target=0.9)
    sel = plan.sel_dev.to(torch.int32).contiguous()
    qmask = plan.qmask_dev.contiguous()
    k_pad = ops._next_pow2(args.k)
    nrows = sti.live_rows(valid)
    pairs = qmask.sum(dim=0).long()
    live = nrows[sel.long()].long()
    active_rows = int((pairs * live).sum())
    uniq = torch.unique(sel.long())
    rows_read = int(nrows[uniq].sum())
    bf16_snap = get_executor(idx, "bf16").snapshot().data
    q_dev = torch.as_tensor(q, device=dev)
    b, d = q.shape
    u = int(sel.shape[0])

    def library_scan(data_t, metric):
        """torch.topk over a torch.matmul on the gathered union rows."""
        blocks = data_t.index_select(0, sel.long()).float()
        xs_u = blocks.reshape(-1, d)
        ok = valid.index_select(0, sel.long()).reshape(-1)
        aux = torch.where(ok, 0.0, MASK_DIST)
        if metric == "l2":
            aux = aux + (xs_u * xs_u).sum(1)
        coef = -2.0 if metric == "l2" else -1.0
        out = []
        for b0 in range(0, b, 64):
            dist = aux + coef * torch.matmul(q_dev[b0:b0 + 64], xs_u.T)
            m = qmask[b0:b0 + 64].repeat_interleave(blocks.shape[1], 1)
            dist = torch.where(m, dist, MASK_DIST)
            out.append(torch.topk(dist, k_pad, dim=1, largest=False))
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
            lib_ms = timed(lambda: library_scan(data_t, metric))[1]
            nbytes = (rows_read * d * elem + b * d * elem
                      + 2 * b * k_pad * 4 + b * u + rows_read)
            flops = 2.0 * active_rows * d
            t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
            t_ops = flops / F32_FLOPS_PER_S * 1e3
            kernels.append({
                "name": ("scan_topk_indexed" if (dtype_name, metric)
                         == ("f32", "l2") else
                         f"scan_topk_indexed[{dtype_name},{metric}]"),
                "route": "cuda",
                "source": "src/repro_torch/kernels/csrc/scan_topk_indexed.cu",
                "replaces": "src/repro/kernels/scan_topk_indexed.py:85",
                "launches": launches["scan_topk_indexed"],
                "max_abs_err": err, "tol": tol, "ms": ms,
                "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations",
                "library_ms": lib_ms,
                "shape": {"B": b, "U": u, "S": int(data_t.shape[1]),
                          "d": d, "k_pad": k_pad,
                          "active_pair_rows": active_rows}})
            print(f"scan_topk_indexed {dtype_name} {metric}: err {err:.3g}"
                  f" (tol {tol:.3g}), {ms:.3f} ms vs plain {plain_ms:.1f} ms")

    # centroid pass (fused planner): Q = B queries against P centroids
    cents = torch.as_tensor(idx.levels[0].centroids, device=dev)
    m = min(max(int(np.ceil(idx.config.f_m * cents.shape[0])),
                idx.config.min_candidates), cents.shape[0])
    kp = ops._next_pow2(m)
    dk, ik = st.scan_topk_cuda(q_dev, cents, k_pad=kp)
    dp, ip_ = st.scan_topk_plain(q_dev, cents, k_pad=kp)
    err, tol = compare_topk("scan_topk", dk, ik, dp, ip_)
    ms = cuda_ms(lambda: st.scan_topk_cuda(q_dev, cents, k_pad=kp))
    plain_ms = cuda_ms(lambda: st.scan_topk_plain(q_dev, cents, k_pad=kp))
    c2 = (cents * cents).sum(1)
    lib_ms = cuda_ms(lambda: torch.topk(
        c2 - 2.0 * torch.matmul(q_dev, cents.T), kp, dim=1, largest=False))
    nc = cents.shape[0]
    t_bytes = ((b + nc) * d * 4 + 2 * b * kp * 4) / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * b * nc * d / F32_FLOPS_PER_S * 1e3
    kernels.append({
        "name": "scan_topk", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/scan_topk.cu",
        "replaces": "src/repro/kernels/scan_topk.py:168",
        "launches": launches["scan_topk"], "max_abs_err": err, "tol": tol,
        "ms": ms, "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
        "shape": {"Q": b, "N": nc, "d": d, "k_pad": kp}})
    print(f"scan_topk: err {err:.3g} (tol {tol:.3g}), {ms:.3f} ms")

    # assignment: the insert burst against the base centroids, and an
    # exact-tie case (a centroid duplicated at a smaller index)
    xs = torch.as_tensor(new_x, device=dev)
    aux = (cents * cents).sum(1)
    ak, dk = ka.kmeans_assign_cuda(xs, cents, aux)
    ap, dp = ka.kmeans_assign_plain(xs, cents, aux)
    tol_x = TOL_REL * dp.abs() + TOL_ABS
    err, tol = float((dk - dp).abs().max()), float(tol_x.max())
    if bool(((dk - dp).abs() > tol_x).any()):
        fail(f"kmeans_assign: minima beyond their tolerance, max |diff| "
             f"{err:.3g}")
    dist = aux[None] - 2.0 * (xs @ cents.T)
    two = torch.topk(dist, 2, dim=1, largest=False).values
    clear = (two[:, 1] - two[:, 0]) > 2 * tol_x
    if bool(((ak != ap) & clear).any()):
        fail("kmeans_assign: assignments differ away from ties")
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
    plain_ms = cuda_ms(lambda: ka.kmeans_assign_plain(xs, cents, aux))
    lib_ms = cuda_ms(lambda: torch.argmin(torch.cdist(xs, cents), dim=1))
    n_x = xs.shape[0]
    t_bytes = ((n_x + nc) * d * 4 + n_x * 8) / HBM_BYTES_PER_S * 1e3
    t_ops = 2.0 * n_x * nc * d / F32_FLOPS_PER_S * 1e3
    kernels.append({
        "name": "kmeans_assign", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/kmeans_assign.cu",
        "replaces": "src/repro/kernels/kmeans_assign.py:67",
        "launches": launches["kmeans_assign"], "max_abs_err": err,
        "tol": tol, "ms": ms, "plain_ms": plain_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": lib_ms,
        "shape": {"N": n_x, "C": nc, "d": d, "tied_points": int(hit.sum())}})
    print(f"kmeans_assign: err {err:.3g} (tol {tol:.3g}), {ms:.3f} ms")
    torch.cuda.synchronize()

    # ---- where the time of one warm search_batch goes ------------------
    record["profile"] = profile_search(
        lambda: idx.search_batch(q, args.k, recall_target=0.9))

    record.update(kernels=kernels, card=card)
    (OUT_DIR / "record.json").write_text(json.dumps(record, indent=1))
    print(json.dumps({"kernels": kernels}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())

"""The port's main path as a whole against the JAX package: plan -> pack ->
scan -> Algorithm-2 rounds -> BatchResult, insert/delete and the
delta-refreshed snapshot.

Both packages search the same structure (a JAX-built index loaded into
the port through ``index_from_arrays``), on the CPU: the JAX package
through its jnp oracle path, the port through its torch oracle path
("auto" on CPU tensors) and its kernel path ("cuda": the kernels' plain
versions on CPU tensors).  Host planning is numpy in both packages, so
probe sets, counts, rounds and scan statistics must be identical; ids
must be identical (no exact ties in this data).  Distances come from
||q||^2 + ||x||^2 - 2 q.x in f32, summed in another order by each
framework, with norms near 600 here: they agree to the JAX package's own
kernel tolerance, rtol 1e-4 / atol 1e-3.  Running recall estimates are
computed on the host from those k-th distances and agree to rtol 1e-4.
"""
import copy
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import multiquery as jmq
from repro.core.index import QuakeConfig as JConfig
from repro.core.index import QuakeIndex as JIndex
from repro.data import datasets as jds
from repro_torch.core import multiquery as mq
from repro_torch.core.convert import index_from_arrays, index_to_arrays
from repro_torch.core.index import QuakeIndex
from repro_torch.core.snapshot import IndexSnapshot

TRACE_KEYS = {"round_live", "round_partitions", "round_vectors",
              "round_comparisons", "round_kth", "round_wall_s",
              "budget_expired", "timed_out_rows"}


def export_jax_index(idx) -> dict:
    """A JAX ``QuakeIndex`` as the plain-numpy state dict of
    ``repro_torch.core.convert``."""
    state = {"dim": idx.dim, "max_norm_sq": float(idx._max_norm_sq),
             "num_levels": len(idx.levels),
             "beta_table": np.asarray(idx._beta_table, np.float32)}
    for f in dataclasses.fields(JConfig):
        state[f"config.{f.name}"] = getattr(idx.config, f.name)
    for l, lv in enumerate(idx.levels):
        state[f"level{l}.centroids"] = np.asarray(lv.centroids)
        if l == 0:
            state["level0.sizes"] = lv.sizes()
            state["level0.vectors"] = np.concatenate(lv.vectors)
            state["level0.ids"] = np.concatenate(lv.ids)
            state["level0.sqnorms"] = np.concatenate(lv.sqnorms)
        else:
            state[f"level{l}.child_sizes"] = lv.sizes()
            state[f"level{l}.children"] = np.concatenate(lv.children)
        if lv.parent is not None:
            state[f"level{l}.parent"] = np.asarray(lv.parent)
    return state


@pytest.fixture(scope="module", params=["l2", "ip"])
def built(request):
    metric = request.param
    ds = jds.clustered(4000, 16, n_clusters=16, seed=0, metric=metric)
    j = JIndex.build(ds.vectors, num_partitions=32, kmeans_iters=4,
                     config=JConfig(metric=metric))
    q = jds.queries_near(ds, 48, seed=3)
    return metric, j, q, export_jax_index(j)


def _port(state):
    return index_from_arrays(state, device="cpu")


def _same_result(rt, rj):
    np.testing.assert_array_equal(rt.ids, rj.ids)
    np.testing.assert_allclose(rt.dists, rj.dists, rtol=1e-4, atol=1e-3)
    np.testing.assert_array_equal(rt.nprobe, rj.nprobe)
    assert rt.rounds == rj.rounds
    assert rt.vectors_scanned == rj.vectors_scanned
    assert rt.partitions_scanned == rj.partitions_scanned
    assert rt.comparisons == rj.comparisons
    if rj.recall_estimate is None:
        assert rt.recall_estimate is None
    else:
        np.testing.assert_allclose(rt.recall_estimate, rj.recall_estimate,
                                   rtol=1e-4, equal_nan=True)


@pytest.mark.parametrize("impl", ["auto", "cuda"])
@pytest.mark.parametrize("mode", [dict(nprobe=6), dict(),
                                  dict(rounds=1), dict(union_cap=9)])
def test_search_batch_matches_reference(built, mode, impl):
    metric, j, q, state = built
    p = _port(state)
    rj = j.search_batch(q, 10, impl="jnp", **mode)
    rt = p.search_batch(q, 10, impl=impl, **mode)
    _same_result(rt, rj)
    if not mode:       # APS rounds: the early-exit path really ran
        assert rt.rounds > 1 and rt.round_trace is not None


def test_vectorized_probe_sets_byte_identical(built):
    metric, j, q, state = built
    p = _port(state)
    kth = jmq._calibrate_kth_batched(j, q, 10,
                                     jmq._aps_candidate_budget(j))
    assert mq._calibrate_kth_batched(p, q, 10,
                                     mq._aps_candidate_budget(p)) == kth
    out_t = mq._aps_probe_counts_batched(p, q, 10, 0.9, kth_med=kth)
    out_j = jmq._aps_probe_counts_batched(j, q, 10, 0.9, kth_med=kth)
    for a, b in zip(out_t, out_j):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    rp_t = mq._aps_probe_counts_batched(p, q, 10, 0.9, kth_med=kth,
                                        full=True)
    rp_j = jmq._aps_probe_counts_batched(j, q, 10, 0.9, kth_med=kth,
                                         full=True)
    for f in ("seq", "counts", "geo", "cc", "recall_est"):
        np.testing.assert_array_equal(getattr(rp_t, f), getattr(rp_j, f))
    for cap in (None, 7):
        pt = mq.plan_batch(p, q, 10, recall_target=0.9, union_cap=cap)
        pj = jmq.plan_batch(j, q, 10, recall_target=0.9, union_cap=cap)
        for f in ("sel", "qmask", "nprobe", "planned", "anchor",
                  "recall_est"):
            np.testing.assert_array_equal(getattr(pt, f), getattr(pj, f))
        assert pt.n_real == pj.n_real


def test_loop_planner_matches_reference(built):
    metric, j, q, state = built
    p = _port(state)
    for a, b in zip(mq._aps_probe_counts_loop(p, q[:12], 10, 0.9),
                    jmq._aps_probe_counts_loop(j, q[:12], 10, 0.9)):
        np.testing.assert_array_equal(a, b)
    ex_t = mq.BatchedSearchExecutor(p, planner="loop")
    ex_j = jmq.BatchedSearchExecutor(j, planner="loop", impl="jnp")
    _same_result(ex_t.search(q[:12], 10), ex_j.search(q[:12], 10))


def test_fused_planner_matches_up_to_matmul_rounding(built):
    """The fused planner's centroid pass is the scan_topk kernel path
    (f32 sums in another order than the host GEMM): its probe sets match
    the vectorized planner's and the JAX fused planner's except where a
    rounding difference reorders near-equal candidates."""
    metric, j, q, state = built
    p = _port(state)
    kth = mq._calibrate_kth_batched(p, q, 10, mq._aps_candidate_budget(p))
    sel_f, val_f, cnt_f, r_f = mq._aps_probe_counts_fused(p, q, 10, 0.9,
                                                          kth_med=kth)
    sel_v, val_v, cnt_v, r_v = mq._aps_probe_counts_batched(p, q, 10, 0.9,
                                                            kth_med=kth)
    _, _, cnt_j, _ = jmq._aps_probe_counts_fused(j, q, 10, 0.9, kth_med=kth)
    assert np.mean(cnt_f == cnt_v) >= 0.95
    assert np.mean(cnt_f == np.asarray(cnt_j)) >= 0.95
    same = cnt_f == cnt_v
    for i in np.nonzero(same)[0]:
        assert set(sel_f[i, :cnt_f[i]]) == set(sel_v[i, :cnt_v[i]])
    np.testing.assert_allclose(r_f[same], r_v[same], rtol=1e-5,
                               equal_nan=True)
    rf = mq.BatchedSearchExecutor(p, planner="fused").search(q, 10)
    rv = mq.BatchedSearchExecutor(p).search(q, 10)
    assert np.mean(rf.ids == rv.ids) >= 0.95


def test_default_planner_follows_the_index_device(built, monkeypatch):
    """An executor that names no planner plans where the index lives: the
    host planner on a CPU index, the fused one on a card index (here an
    index whose ``device`` reports the card; nothing runs).  A named
    planner is kept either way."""
    metric, j, q, state = built
    p = _port(state)
    assert mq.BatchedSearchExecutor(p).planner == "vectorized"
    assert mq.get_executor(p).planner == "vectorized"
    assert mq.get_executor(p, "int8").planner == "vectorized"
    monkeypatch.setattr(p, "device", torch.device("cuda"))
    assert mq.BatchedSearchExecutor(p).planner == "fused"
    assert mq.BatchedSearchExecutor(p, storage_dtype="bf16").planner \
        == "fused"
    for named in ("vectorized", "fused", "loop"):
        assert mq.BatchedSearchExecutor(p, planner=named).planner == named
    assert (mq.default_planner("cuda"), mq.default_planner("cuda:1"),
            mq.default_planner("cpu")) == ("fused", "fused", "vectorized")


@pytest.mark.parametrize("cap", [None, 9])
@pytest.mark.parametrize("nprobe", [6, 40], ids=["n<P", "n>=P"])
def test_fused_nprobe_plan_matches_host(built, nprobe, cap, monkeypatch):
    """A fixed-``nprobe`` plan on the device (the ``scan_topk`` centroid
    pass, its torch twin here, fed to the pack as it is) picks row by row
    the host branch's probe set and nearest partition, so the packed
    union and mask are the same."""
    metric, j, q, state = built
    p = _port(state)
    calls = []
    real = mq.ops.scan_topk

    def counted(*a, **kw):
        calls.append(a[2])
        return real(*a, **kw)
    monkeypatch.setattr(mq.ops, "scan_topk", counted)
    host = mq.plan_batch(p, q, 10, nprobe=nprobe, union_cap=cap)
    assert calls == []
    card = mq.plan_batch(p, q, 10, nprobe=nprobe, union_cap=cap,
                         planner="fused", cache=mq.PlannerCache(p))
    assert calls == [min(nprobe, 32)]        # one centroid pass, P = 32
    for i in range(q.shape[0]):
        assert set(card.sel[card.qmask[i]]) == set(host.sel[host.qmask[i]])
    np.testing.assert_array_equal(card.anchor, host.anchor)
    assert card.n_real == host.n_real
    for f in ("sel", "qmask", "nprobe", "planned"):
        np.testing.assert_array_equal(getattr(card, f), getattr(host, f))
    assert card.recall_est is None and host.recall_est is None
    np.testing.assert_array_equal(card.sel_dev.long().numpy(), card.sel)


def test_round_trace_has_the_pinned_keys(built):
    metric, j, q, state = built
    r = _port(state).search_batch(q, 10)
    assert set(r.round_trace) == TRACE_KEYS
    for key in TRACE_KEYS - {"budget_expired", "timed_out_rows"}:
        assert len(r.round_trace[key]) == r.rounds
    assert r.round_trace["budget_expired"] is False


def test_per_query_search_matches_reference(built):
    metric, j, q, state = built
    rt = mq.per_query_search(_port(state), q[:5], 10, nprobe=4)
    rj = jmq.per_query_search(j, q[:5], 10, nprobe=4, impl="jnp")
    np.testing.assert_array_equal(rt.ids, rj.ids)
    assert rt.vectors_scanned == rj.vectors_scanned


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_update_delta_refresh_matches_fresh_snapshot(built, storage):
    """An insert/delete confined to a few partitions patches the cached
    snapshot in place (one delta refresh, no rebuild), and the results
    equal those of a freshly built snapshot of the updated index."""
    metric, j, q, state = built
    p = _port(state)
    ex = mq.get_executor(p, storage)
    ex.search(q, 10)
    assert (ex.full_rebuilds, ex.delta_refreshes) == (1, 0)
    rng = np.random.default_rng(1)
    src = p.levels[0].vectors[5]
    new = (src[rng.integers(0, len(src), 20)]
           + 0.01 * rng.normal(size=(20, p.dim))).astype(np.float32)
    dels = p.levels[0].ids[5][:6].copy()
    p.insert(new, np.arange(10_000, 10_020))
    assert p.delete(dels) == 6
    r1 = ex.search(q, 10)
    assert (ex.full_rebuilds, ex.delta_refreshes) == (1, 1)
    fresh = index_from_arrays(index_to_arrays(p), device="cpu")
    r2 = mq.get_executor(fresh, storage).search(q, 10)
    np.testing.assert_array_equal(r1.ids, r2.ids)
    np.testing.assert_array_equal(r1.dists, r2.dists)
    if storage == "f32":
        # the reference, given the same update, agrees
        j2 = copy.deepcopy(j)
        j2.insert(new, np.arange(10_000, 10_020))
        j2.delete(dels)
        _same_result(r1, j2.search_batch(q, 10, impl="jnp"))


def test_executor_contract():
    idx = QuakeIndex.build(
        jds.clustered(500, 8, n_clusters=4, seed=0).vectors,
        num_partitions=6, device="cpu")
    ex8 = mq.BatchedSearchExecutor(idx, storage_dtype="int8")
    snap8 = ex8.snapshot()
    assert snap8.data.dtype == torch.int8 and snap8.scales is not None
    with pytest.raises(ValueError, match="int8"):   # never patched
        snap8.apply_delta(IndexSnapshot.build_patch(idx, [0],
                                                    snap8.capacity))
    with pytest.raises(ValueError):
        mq.BatchedSearchExecutor(idx, storage_dtype="f16")
    ex = mq.BatchedSearchExecutor(idx)
    with pytest.raises(ValueError):
        ex.search(np.zeros((2, 8), np.float32), 5, rounds=0)
    r = ex.search(np.zeros((0, 8), np.float32), 5)
    assert r.ids.shape == (0, 5)
    assert mq._round_windows(10) == jmq._round_windows(10)
    assert mq._round_windows(40, 3) == jmq._round_windows(40, 3)


# ---------------------------------------------------------------------------
# int8 storage: IVF-residual codes, the q8 scan, exact re-rank of the top-2k
# ---------------------------------------------------------------------------

def _firm(dists, tol=1e-4):
    """Result positions with no near-tie in the reference's list."""
    d = np.where(np.isfinite(dists), dists, 1e30)
    gap = np.full(d.shape, np.inf)
    step = np.abs(np.diff(d, axis=1))
    gap[:, 1:] = step
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    return np.isfinite(dists) & (gap > tol * np.maximum(np.abs(d), 1.0))


@pytest.mark.parametrize("mode", [dict(nprobe=6), dict(), dict(rounds=1)])
def test_int8_executor_matches_reference(built, mode):
    """The port's int8 executor against the JAX package's (its q8 Pallas
    kernel in interpret mode) on one structure: the same probe counts,
    rounds and scan footprint, and after the exact re-rank the same ids
    wherever the reference's list has no near-tie; where the ids agree
    the re-ranked distances are the same float64 numbers.  k = 10, so the
    scan's 2k = 20 stays within the JAX kernel's tile (no clipped
    k_pad)."""
    metric, j, q, state = built
    p = _port(state)
    q = q[:24]
    rj = j.search_batch(q, 10, storage_dtype="int8", **mode)
    rt = p.search_batch(q, 10, storage_dtype="int8", **mode)
    np.testing.assert_array_equal(rt.nprobe, rj.nprobe)
    assert rt.rounds == rj.rounds
    assert rt.vectors_scanned == rj.vectors_scanned
    assert rt.partitions_scanned == rj.partitions_scanned
    firm = _firm(rj.dists)
    assert firm.mean() > 0.9
    np.testing.assert_array_equal(rt.ids[firm], rj.ids[firm])
    same = rt.ids == rj.ids
    assert same.mean() >= 0.99
    np.testing.assert_array_equal(rt.dists[same], rj.dists[same])
    # the re-rank recovers the f32 executor's answer
    r32 = p.search_batch(q, 10, **mode)
    assert np.mean(rt.ids == r32.ids) >= 0.95


@pytest.mark.parametrize("mode", [dict(nprobe=4), dict()])
def test_int8_full_rebuild_on_every_delta(mode):
    """An int8 snapshot cannot be patched: an insert burst that a bf16
    snapshot would take as a delta makes the int8 executor requantize by
    a full rebuild, and the fresh inserts are visible either way (the
    JAX package's refresh-policy tests, for the port)."""
    ds = jds.clustered(4000, 16, n_clusters=16, seed=0)
    q = jds.queries_near(ds, 6, seed=10)
    for dtype, want_delta in (("bf16", True), ("int8", False)):
        idx = QuakeIndex.build(ds.vectors[:2000], num_partitions=16,
                               kmeans_iters=3, device="cpu")
        ex = mq.get_executor(idx, dtype)
        assert ex is mq.get_executor(idx, dtype)
        assert ex is not mq.get_executor(idx)
        ex.search(q, 5, **mode)
        assert ex.full_rebuilds == 1
        new_ids = np.arange(8000, 8006)
        idx.insert(q * 0.999, new_ids)
        r = ex.search(q, 5, **mode)
        if want_delta:
            assert (ex.delta_refreshes, ex.full_rebuilds) == (1, 1)
        else:
            assert (ex.delta_refreshes, ex.full_rebuilds) == (0, 2)
        assert set(r.ids.ravel().tolist()) & set(new_ids.tolist())
        miss = ~np.isfinite(r.dists)
        assert (r.ids[miss] == -1).all() and (r.ids[~miss] >= 0).all()


def test_int8_rerank_mirror_and_partition_padding():
    """The compact re-rank mirror returns what a gather from the padded
    f32 snapshot returns; the snapshot holds the index's partitions
    unpadded, and the padding slots past each partition's size are
    inert (not valid, and a -1 candidate re-ranks to inf)."""
    ds = jds.clustered(3000, 16, n_clusters=16, seed=4)
    q = jds.queries_near(ds, 16, seed=5)
    idx = QuakeIndex.build(ds.vectors, num_partitions=20, kmeans_iters=3,
                           device="cpu")
    ex = mq.BatchedSearchExecutor(idx, storage_dtype="int8")
    r = ex.search(q, 10, nprobe=5)
    assert ex._snap.num_partitions == idx.num_partitions == 20
    sizes = idx.levels[0].sizes()
    np.testing.assert_array_equal(ex._valid.numpy().sum(axis=1), sizes)
    assert not ex._valid[:, int(sizes.max()):].any()
    flat = np.where(ex._valid.numpy().reshape(-1))[0][::7][:40]
    flat = np.concatenate([flat, [-1]])[None, :].repeat(2, axis=0)
    full = mq.IndexSnapshot.from_index(idx, capacity=ex._snap.capacity)
    x = full.data.numpy().reshape(-1, idx.dim)
    d, f = ex._rerank_exact(q[:2], flat, 41)
    diff = x[np.maximum(f, 0)] - q[:2, None]        # the JAX formula
    de = np.einsum("bkd,bkd->bk", diff, diff, dtype=np.float64)
    np.testing.assert_array_equal(d[:, :40], de[:, :40])
    assert (f[:, 40] == -1).all() and np.isinf(d[:, 40]).all()
    r32 = mq.get_executor(idx).search(q, 10, nprobe=5)
    assert np.mean(r.ids == r32.ids) >= 0.95
    # without the re-rank the int8 distances are served as they are
    raw = mq.BatchedSearchExecutor(idx, storage_dtype="int8",
                                   int8_rerank=False)
    r_raw = raw.search(q, 10, nprobe=5)
    assert raw._mirror is None
    assert np.mean([len(set(a) & set(b)) / 10
                    for a, b in zip(r_raw.ids, r32.ids)]) >= 0.85
    assert not np.array_equal(r_raw.dists, r.dists)

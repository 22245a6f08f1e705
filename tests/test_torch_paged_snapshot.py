"""The paged device snapshot (``core/snapshot.py``) and the executor's page
expansion (``multiquery.expand_pages``) against plain references, on
skewed partitions and pages of 16 rows, so that most partitions span
several pages: exact k-NN at ``nprobe = P``, a plain IVF scan of exactly
the partitions a plan names, a patched snapshot against a fresh build,
the int8 re-rank, and a shard's block of pages against the whole.
Widths run past 1,892 f32 values, where the card's scan stages its
queries in column chunks.

Tolerance: distances within 1e-5 of ||q||^2 + ||x||^2 (the scan sums
||x||^2 - 2 q.x in f32 and adds ||q||^2; the references work in f64)."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import multiquery as mq
from repro_torch.core.index import QuakeIndex
from repro_torch.core.snapshot import IndexSnapshot, page_counts

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
from qbench import reference  # noqa: E402

PAGE = 16
K = 10
TOL = 1e-5


def _skewed(n, d, seed):
    """Rows of 24 Gaussian clusters whose sizes fall as 1 / i, so the
    partitions' sizes range over more than a decade."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3.0, (24, d))
    w = 1.0 / np.arange(1, 25)
    pick = rng.choice(24, size=n, p=w / w.sum())
    return (centers[pick] + rng.normal(0, 1.0, (n, d))).astype(np.float32)


@pytest.fixture(scope="module", params=[16, 200, 2000])
def built(request):
    d = request.param
    x = _skewed(1200, d, d)
    idx = QuakeIndex.build(x, num_partitions=12, kmeans_iters=3,
                           device="cpu")
    q = (x[np.random.default_rng(1).integers(0, len(x), 24)]
         + 0.05 * np.random.default_rng(2).normal(size=(24, d))
         ).astype(np.float32)
    return x, idx, q


def _executor(idx, page, **kw):
    """An executor whose snapshot has pages of ``page`` slots."""
    return mq.BatchedSearchExecutor(idx, page_size=page, **kw)


def _dist_tol(q, x, ids):
    """TOL times ||q||^2 + ||x||^2 of each answered row."""
    x2 = np.sum(x.astype(np.float64) ** 2, axis=1)
    q2 = np.sum(q.astype(np.float64) ** 2, axis=1)
    return TOL * (q2[:, None] + x2[np.maximum(ids, 0)])


def test_partitions_span_pages(built):
    _, idx, _ = built
    sizes = idx.levels[0].sizes()
    assert sizes.max() > 4 * PAGE and sizes.max() >= 5 * sizes.min()
    snap = IndexSnapshot.from_index(idx, page_size=PAGE, headroom=1.5)
    start = snap.page_start.numpy()
    np.testing.assert_array_equal(np.diff(start),
                                  page_counts(sizes, PAGE, 1.5))
    assert snap.num_pages == start[-1] > snap.num_partitions
    # each partition's rows from the first slot of its first page on
    ids = snap.ids.numpy().reshape(-1)
    for j, s in enumerate(sizes):
        run = ids[start[j] * PAGE:start[j + 1] * PAGE]
        np.testing.assert_array_equal(run[:s], idx.levels[0].ids[j])
        assert (run[s:] == -1).all()
    assert (snap.ids >= 0).sum() == sizes.sum()


@pytest.mark.parametrize("page", [16, 64, None])
def test_executor_snapshot_has_its_page(page):
    """The executor builds its snapshot in pages of ``page_size`` slots
    (``SNAPSHOT_PAGE`` unnamed), each partition taking ``page_counts``
    of them, and maps every live slot back to its external id."""
    x = _skewed(900, 8, 5)
    idx = QuakeIndex.build(x, num_partitions=6, kmeans_iters=3,
                           device="cpu")
    kw = {} if page is None else {"page_size": page}
    ex = mq.BatchedSearchExecutor(idx, **kw)
    snap = ex.snapshot()
    page = mq.SNAPSHOT_PAGE if page is None else page
    sizes = idx.levels[0].sizes()
    assert snap.capacity == page
    np.testing.assert_array_equal(np.diff(snap.page_start.numpy()),
                                  page_counts(sizes, page, ex.headroom))
    live = ex._flat_ids[ex._flat_ids >= 0]
    np.testing.assert_array_equal(
        np.sort(live), np.sort(np.concatenate(idx.levels[0].ids)))


def test_dense_is_the_case_of_one_page_a_partition(built):
    """A page at least headroom times the largest partition gives the
    dense layout (the JAX package's, and its flat indices)."""
    _, idx, _ = built
    dense = IndexSnapshot.from_index(idx, headroom=1.5)
    paged = IndexSnapshot.from_index(idx, page_size=dense.capacity,
                                     headroom=1.5)
    assert dense.dense and paged.dense
    for f in ("data", "ids", "centroids", "sizes", "page_start"):
        assert torch.equal(getattr(dense, f), getattr(paged, f)), f
    with pytest.raises(ValueError):
        IndexSnapshot.from_index(idx, capacity=64, page_size=PAGE)


def test_nprobe_p_is_exact_knn(built):
    """(a) Every partition probed: the paged scan is exact k-NN
    (``qbench.reference.exact_topk``), ids equal up to ties."""
    x, idx, q = built
    ex = _executor(idx, PAGE)
    r = ex.search(q, K, nprobe=idx.num_partitions, rounds=1)
    dd, ii = reference.exact_topk(torch.as_tensor(q), torch.as_tensor(x),
                                  K + 1)
    dd, ii = dd.double().numpy(), ii.numpy()
    tol = _dist_tol(q, x, ii[:, :K])
    assert np.all(np.abs(r.dists - dd[:, :K]) <= tol)
    for b in range(len(q)):
        if dd[b, K] - dd[b, K - 1] > tol[b, -1]:     # no tie at the k-th
            assert set(r.ids[b]) == set(ii[b, :K])


def _dense_page(idx):
    """A page that holds the largest partition with its slack: one page a
    partition."""
    return IndexSnapshot.align_capacity(
        int(np.ceil(1.5 * idx.levels[0].sizes().max())))


@pytest.mark.parametrize("storage", ["f32", "bf16"])
def test_aps_rounds_over_pages_answer_as_dense(built, storage):
    """The round loop's scans (``scan_probe_round``) expand each round's
    union to pages: the same rounds, probes and answers as over one page
    a partition (distances to the tolerance: the plain scan's products
    are blocked by the page's rows)."""
    x, idx, q = built
    paged = _executor(idx, PAGE, storage_dtype=storage)
    dense = _executor(idx, _dense_page(idx), storage_dtype=storage)
    rp = paged.search(q, K, recall_target=0.999)
    rd = dense.search(q, K, recall_target=0.999)
    assert not paged._snap.dense and dense._snap.dense
    assert rp.rounds == rd.rounds >= 1
    np.testing.assert_array_equal(rp.nprobe, rd.nprobe)
    assert rp.comparisons == rd.comparisons
    assert np.mean(rp.ids == rd.ids) >= 0.99
    assert np.all(np.abs(rp.dists - rd.dists)
                  <= _dist_tol(q, x, rd.ids) * (200 if storage == "bf16"
                                                else 1))


def _plain_ivf(idx, q, sel, qmask, k):
    """Plain torch IVF: each query against the rows of exactly the
    partitions its mask names, f64, stable by (distance, id)."""
    lvl0 = idx.levels[0]
    out_d, out_i = [], []
    for b in range(len(q)):
        parts = sel[qmask[b]]
        xs = torch.as_tensor(np.concatenate([lvl0.vectors[j] for j in parts]))
        ids = np.concatenate([lvl0.ids[j] for j in parts])
        d = ((xs.double() - torch.as_tensor(q[b]).double()) ** 2).sum(1)
        order = np.lexsort((ids, d.numpy()))[:k]
        out_d.append(d.numpy()[order])
        out_i.append(ids[order])
    return np.stack(out_d), np.stack(out_i)


@pytest.mark.parametrize("nprobe", [1, 3, 7])
def test_fixed_nprobe_scans_exactly_the_planned_partitions(built, nprobe):
    """(b) The plan's partitions, expanded to pages, scanned: the plain
    IVF reference over the same partitions gives the same answer."""
    x, idx, q = built
    ex = _executor(idx, PAGE)
    ex.snapshot()
    plan = mq.plan_batch(idx, q, K, nprobe=nprobe, pages=ex.pages)
    live = int(ex.pages.used_host[plan.sel[:plan.n_real]].sum())
    pmask = plan.qmask_dev.numpy()
    pages = plan.sel_dev.long().numpy()
    assert len(pages) % mq.U_BUCKET == 0 and not pmask[:, live:].any()
    pmask, pages = pmask[:, :live], pages[:live]
    # each live union partition became its used pages, mask repeated
    start = ex._page_start
    for u, j in enumerate(plan.sel[:plan.n_real]):
        hit = (pages >= start[j]) & (pages < start[j + 1])
        assert hit.sum() == max(-(-ex._sizes[j] // PAGE), 1)
        for col in np.nonzero(hit)[0]:
            np.testing.assert_array_equal(pmask[:, col], plan.qmask[:, u])
    r = ex.search(q, K, nprobe=nprobe, rounds=1)
    want_d, want_i = _plain_ivf(idx, q, plan.sel, plan.qmask, K)
    assert np.all(np.abs(r.dists - want_d) <= _dist_tol(q, x, want_i))
    assert np.mean(r.ids == want_i) >= 0.99
    assert r.comparisons == sum(int(ex._sizes[plan.sel[plan.qmask[b]]].sum())
                                for b in range(len(q)))


def _blocks_of(snap):
    """Each partition's (rows, ids) from a paged snapshot."""
    start = snap.page_start.numpy()
    s = snap.capacity
    data = snap.data.reshape(-1, snap.dim).numpy()
    ids = snap.ids.reshape(-1).numpy()
    return [(data[start[j] * s:start[j] * s + n], ids[start[j] * s:
                                                      start[j] * s + n])
            for j, n in enumerate(snap.sizes.numpy())]


@pytest.mark.parametrize("donate", [False, True])
def test_patched_paged_snapshot_equals_a_fresh_build(built, donate):
    """(c) A delta (inserts within a partition's slack, deletes) patches
    only the dirty partitions' pages, and every partition then holds
    what a fresh build of the updated index holds."""
    x, idx0, q = built
    idx = QuakeIndex.build(x, num_partitions=12, kmeans_iters=3,
                           device="cpu")
    snap = IndexSnapshot.from_index(idx, page_size=PAGE, headroom=2.0)
    start = snap.page_start.numpy().copy()
    lvl0 = idx.levels[0]
    big = int(np.argmax(lvl0.sizes()))
    idx.delete(lvl0.ids[big][:5])
    idx.insert(lvl0.vectors[big][:9] + 0.01, np.arange(90_000, 90_009))
    delta = idx.journal.delta_since(0)
    patch = IndexSnapshot.build_patch(idx, delta.dirty, PAGE, start)
    assert len(patch.pages) == sum(start[j + 1] - start[j]
                                   for j in patch.rows)
    new = snap.apply_delta(patch, donate=donate)
    fresh = IndexSnapshot.from_index(idx, page_size=PAGE, headroom=2.0)
    assert torch.equal(new.sizes, fresh.sizes)
    assert torch.equal(new.centroids, fresh.centroids)
    for (a, ai), (b, bi) in zip(_blocks_of(new), _blocks_of(fresh)):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ai, bi)
    assert (new.ids >= 0).sum() == (fresh.ids >= 0).sum()
    # a partition grown past its pages does not patch
    grow = lvl0.vectors[big][:1] + 0.01
    idx.insert(np.repeat(grow, (start[big + 1] - start[big]) * PAGE, 0),
               np.arange(100_000, 100_000 + (start[big + 1] - start[big])
                         * PAGE))
    with pytest.raises(ValueError):
        IndexSnapshot.build_patch(idx, [big], PAGE, start)


def test_executor_patches_pages_and_answers_as_fresh(built):
    """(c) The executor's delta refresh over pages answers as a fresh
    executor over the updated index."""
    x, _, q = built
    idx = QuakeIndex.build(x, num_partitions=12, kmeans_iters=3,
                           device="cpu")
    ex = _executor(idx, PAGE)
    ex.search(q, K, nprobe=4, rounds=1)
    lvl0 = idx.levels[0]
    j = int(np.argmax(lvl0.sizes()))
    new = lvl0.vectors[j][:6] + 0.01
    idx.insert(new, np.arange(80_000, 80_006))
    idx.delete(lvl0.ids[j][6:9])
    q = np.concatenate([q, new])
    r1 = ex.search(q, K, nprobe=4, rounds=1)
    assert (ex.full_rebuilds, ex.delta_refreshes) == (1, 1)
    r2 = _executor(idx, PAGE).search(
        q, K, nprobe=4, rounds=1)
    np.testing.assert_array_equal(r1.ids, r2.ids)
    np.testing.assert_array_equal(r1.dists, r2.dists)
    assert set(np.arange(80_000, 80_006)) & set(r1.ids.ravel().tolist())


def test_int8_paged_reranks_exactly(built):
    """(c) int8 pages: each page quantized against its partition's
    centroid, the top-2k re-ranked exactly from the host mirror: the same
    answer as the dense int8 layout, and distances exact in f64."""
    x, idx, q = built
    paged = _executor(idx, PAGE, storage_dtype="int8")
    dense = _executor(idx, _dense_page(idx), storage_dtype="int8")
    for kw in (dict(nprobe=5, rounds=1), dict()):
        rp, rd = paged.search(q, K, **kw), dense.search(q, K, **kw)
        assert not paged._snap.dense and dense._snap.dense
        np.testing.assert_array_equal(rp.ids, rd.ids)
        np.testing.assert_array_equal(rp.dists, rd.dists)
        ok = rp.ids >= 0
        row = {int(i): r for i, r in zip(
            np.concatenate(idx.levels[0].ids),
            np.concatenate(idx.levels[0].vectors))}
        xs = np.stack([row[int(i)] for i in rp.ids[ok]])
        de = np.einsum("nd,nd->n", xs - np.repeat(q, K, 0)[ok.ravel()],
                       xs - np.repeat(q, K, 0)[ok.ravel()],
                       dtype=np.float64)
        np.testing.assert_allclose(rp.dists[ok], de, rtol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.int8])
def test_part_blocks_join_into_the_whole(built, dtype):
    """(d) ``parts=(lo, hi)`` blocks of a paged snapshot, side by side,
    are the whole: pages, ids, sizes, centroids and the directory."""
    _, idx, _ = built
    whole = IndexSnapshot.from_index(idx, page_size=PAGE, headroom=1.5,
                                     dtype=dtype, pad_partitions_to=8)
    p = whole.num_partitions
    assert p == 16
    cuts = [(0, 4), (4, 8), (8, 13), (13, 16)]
    blocks = [IndexSnapshot.from_index(idx, page_size=PAGE, headroom=1.5,
                                       dtype=dtype, pad_partitions_to=8,
                                       parts=c) for c in cuts]
    for f in ("data", "ids", "sizes", "centroids") + (
            ("scales",) if dtype == torch.int8 else ()):
        assert torch.equal(torch.cat([getattr(b, f) for b in blocks]),
                           getattr(whole, f)), f
    starts = [b.page_start + whole.page_start[lo]
              for b, (lo, _) in zip(blocks, cuts)]
    assert torch.equal(torch.cat([starts[0]] + [s[1:] for s in starts[1:]]),
                       whole.page_start)
    assert all(b.num_pages >= hi - lo for b, (lo, hi) in zip(blocks, cuts))

"""The port's core modules (repro_torch.core, repro_torch.data) against the
JAX package: geometry and the APS estimator, the journal and cost model,
k-means and assignment, the dynamic index, the snapshot, and the state
conversion.

Index comparisons run on identical structure: a JAX-built index is
exported to plain numpy (``export_jax_index``) and loaded into the port
with ``index_from_arrays``.  Host numpy paths (per-query search with the
numpy backend, routing below the host gate, the numpy estimator) must
agree exactly; torch paths agree to the tolerances stated per test.
"""
import dataclasses
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import aps as japs
from repro.core import geometry as jgeo
from repro.core import journal as jjournal
from repro.core import kmeans as jkmeans
from repro.core.cost_model import LatencyModel as JLatency
from repro.core.distributed import IndexSnapshot as JSnapshot
from repro.core.index import QuakeConfig as JConfig
from repro.core.index import QuakeIndex as JIndex
from repro.data import datasets as jds
from repro_torch.core import aps, geometry, journal, kmeans
from repro_torch.core.convert import index_from_arrays, index_to_arrays
from repro_torch.core.cost_model import LatencyModel, PartitionStats
from repro_torch.core.index import QuakeIndex
from repro_torch.core.snapshot import IndexSnapshot
from repro_torch.data import datasets


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
        state[f"level{l}.hits"] = np.asarray(lv.stats.hits)
        state[f"level{l}.window"] = int(lv.stats.window)
    state["maintenance_log"] = list(idx.maintenance_log)
    return state


@pytest.fixture(scope="module")
def pair():
    """(dataset, JAX index, port index on the same structure)."""
    ds = jds.clustered(3000, 16, n_clusters=16, seed=0)
    j = JIndex.build(ds.vectors, num_partitions=30, kmeans_iters=4)
    return ds, j, index_from_arrays(export_jax_index(j), device="cpu")


# ---------------------------------------------------------------------------
# geometry and the estimator
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dim", [16, 17, 129])
def test_betainc_table(dim):
    """The port's table is the f64 scipy value rounded to f32; the JAX
    table is evaluated in f32, whose series carries ~1e-5 of error."""
    from scipy.special import betainc
    xs = np.linspace(0.0, 1.0, 1024)
    exact = betainc((dim + 1) / 2.0, 0.5, xs)
    t = geometry.betainc_table(dim)
    assert t.dtype == np.float32 and t.shape == (1024,)
    np.testing.assert_array_equal(t, exact.astype(np.float32))
    np.testing.assert_allclose(t, jgeo.betainc_table(dim), rtol=0,
                               atol=2e-5)


def _estimator_inputs(b=16, m=24, seed=0):
    rng = np.random.default_rng(seed)
    di = np.sort(rng.uniform(0.5, 8.0, size=(b, m)), axis=1)
    d0 = di[:, 0].copy()
    cc = rng.uniform(0.1, 4.0, size=(b, m))
    rho_sq = rng.uniform(0.2, 6.0, size=b)
    valid = np.ones((b, m), dtype=bool)
    valid[:, 0] = False
    table = np.array(jgeo.betainc_table(17), dtype=np.float32)
    return d0, di, cc, rho_sq, table, valid


@pytest.mark.parametrize("m", [5, 24, 50, 200])
def test_estimate_probs_batch_torch_bitwise_matches_reference(m):
    d0, di, cc, rho_sq, table, valid = _estimator_inputs(m=m)
    rho_sq[:2] = [np.inf, 1e-40]             # degenerate radii too
    p0_t, p_t = aps.estimate_probs_batch(
        *(torch.as_tensor(v) for v in (d0, di, cc, rho_sq)), table,
        torch.as_tensor(valid))
    p0_n, p_n = aps.estimate_probs_batch(d0, di, cc, rho_sq, table, valid)
    for i in range(len(d0)):
        p0_r, p_r = japs.estimate_probs_np(
            float(d0[i]), di[i], cc[i], float(rho_sq[i]), table, valid[i])
        assert p0_t[i].item() == p0_r, i       # byte-identical
        np.testing.assert_array_equal(p_t[i].numpy(), p_r)
        assert p0_n[i] == p0_r
        np.testing.assert_array_equal(p_n[i], p_r)


def test_estimate_probs_and_rho_match_reference():
    d0, di, cc, rho_sq, table, valid = _estimator_inputs(b=1)
    p0_j, p_j = japs.estimate_probs(
        jnp.asarray(d0[0]), jnp.asarray(di[0]), jnp.asarray(cc[0]),
        jnp.asarray(rho_sq[0]), jnp.asarray(table), jnp.asarray(valid[0]))
    p0_t, p_t = aps.estimate_probs(
        *(torch.as_tensor(v) for v in (d0[0], di[0], cc[0], rho_sq[0],
                                       table, valid[0])))
    # f32 (JAX) vs f64 (torch) evaluation of the same formula
    np.testing.assert_allclose(p0_t.item(), float(p0_j), rtol=1e-4)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-3,
                               atol=1e-6)
    kth = np.array([-3.0, 0.5, 2.0])
    qn = np.array([1.0, 2.0, 3.0])
    for metric in ("l2", "ip"):
        ref = japs.rho_sq_batch(kth, metric=metric, q_norm_sq=qn,
                                max_norm_sq=4.0)
        np.testing.assert_array_equal(
            aps.rho_sq_batch(kth, metric=metric, q_norm_sq=qn,
                             max_norm_sq=4.0), ref)
        np.testing.assert_array_equal(
            aps.rho_sq_batch(torch.as_tensor(kth), metric=metric,
                             q_norm_sq=torch.as_tensor(qn),
                             max_norm_sq=4.0).numpy(), ref)


def test_aps_scan_and_topk_match_reference():
    rng = np.random.default_rng(3)
    m = 12
    cand = rng.uniform(1.0, 9.0, m)
    cc = rng.uniform(0.5, 3.0, m)
    parts = [(rng.uniform(0.5, 20.0, 15), np.arange(15) + 100 * j)
             for j in range(m)]
    table = geometry.betainc_table(17)
    kw = dict(cand_centroid_dists_sq=cand, cand_cc_dists=cc,
              scan_partition=lambda j: parts[j],
              item_dist_to_rho_sq=lambda kth: max(kth, 0.0), k=10,
              recall_target=0.9, table=table)
    r_t, r_j = aps.aps_scan(**kw), japs.aps_scan(**kw)
    np.testing.assert_array_equal(r_t.ids, r_j.ids)
    np.testing.assert_array_equal(r_t.scanned, r_j.scanned)
    assert r_t.recall_estimate == r_j.recall_estimate
    assert r_t.recompute_count == r_j.recompute_count
    top = aps.TopK(3)
    assert not top.full
    top.update(np.array([5.0, 1.0, 3.0, 2.0]), np.array([5, 1, 3, 2]))
    assert top.full and top.kth == 3.0
    np.testing.assert_array_equal(top.ids, [1, 2, 3])


def test_cap_fraction_and_probabilities_match_reference():
    rng = np.random.default_rng(4)
    h = rng.uniform(-1.5, 1.5, 50)
    table = np.array(jgeo.betainc_table(9))
    np.testing.assert_allclose(
        geometry.cap_fraction(torch.as_tensor(h), torch.as_tensor(table))
        .numpy(),
        np.asarray(jgeo.cap_fraction(jnp.asarray(h), jnp.asarray(table))),
        rtol=1e-5, atol=1e-6)
    v = rng.uniform(0, 0.5, 20)
    valid = rng.random(20) < 0.8
    p0_t, p_t = geometry.partition_probabilities(torch.as_tensor(v),
                                                 torch.as_tensor(valid))
    p0_j, p_j = jgeo.partition_probabilities(jnp.asarray(v),
                                             jnp.asarray(valid))
    np.testing.assert_allclose(p0_t.item(), float(p0_j), rtol=1e-5)
    np.testing.assert_allclose(p_t.numpy(), np.asarray(p_j), rtol=1e-4,
                               atol=1e-7)


# ---------------------------------------------------------------------------
# journal, cost model, datasets (copies)
# ---------------------------------------------------------------------------

def test_journal_folds_like_reference():
    ops_seq = [dict(dirty=[1, 2]), dict(), dict(dirty=[5]),
               dict(structural=True), dict(dirty=[2, 7])]
    jt, jj = journal.MutationJournal(max_entries=3), \
        jjournal.MutationJournal(max_entries=3)
    for kw in ops_seq:
        assert jt.record(**kw) == jj.record(**kw)
    for v in range(0, 6):
        dt, dj = jt.delta_since(v), jj.delta_since(v)
        assert (dt is None) == (dj is None)
        if dt is not None:
            assert dt.dirty == dj.dirty and dt.structural == dj.structural
    assert jt.overflowed and jt.overflow_count == jj.overflow_count


def test_cost_model_matches_reference():
    sizes = np.array([0, 1, 64, 500, 4096])
    np.testing.assert_array_equal(LatencyModel()(sizes), JLatency()(sizes))
    assert LatencyModel().predict_scan_ns(sizes) == \
        JLatency().predict_scan_ns(sizes)
    st = PartitionStats()
    st.ensure(4)
    st.record(np.array([1, 3]))
    st.record_batch(np.array([0, 1]), np.array([2, 1]), 3)
    np.testing.assert_allclose(st.access_freq(4), [0.5, 0.5, 0.0, 0.25])


def test_datasets_are_copies_of_reference():
    a = datasets.clustered(500, 8, n_clusters=5, seed=3)
    b = jds.clustered(500, 8, n_clusters=5, seed=3)
    np.testing.assert_array_equal(a.vectors, b.vectors)
    qa = datasets.queries_near(a, 20, seed=4)
    np.testing.assert_array_equal(qa, jds.queries_near(b, 20, seed=4))
    np.testing.assert_array_equal(a.ground_truth(qa, 7),
                                  b.ground_truth(qa, 7))
    gt_t = a.ground_truth(qa, 7, device="cpu")
    assert np.mean(gt_t == b.ground_truth(qa, 7)) > 0.99


# ---------------------------------------------------------------------------
# k-means and assignment
# ---------------------------------------------------------------------------

def test_kmeans_seeds_like_reference_and_converges():
    ds = jds.clustered(600, 8, n_clusters=6, seed=1)
    c0_t, _ = kmeans.kmeans(ds.vectors, 6, iters=0, seed=5, device="cpu")
    c0_j, _ = jkmeans.kmeans(ds.vectors, 6, iters=0, seed=5)
    np.testing.assert_array_equal(c0_t, c0_j)     # same initial centroids
    c_t, a_t = kmeans.kmeans(ds.vectors, 6, iters=8, seed=5, device="cpu")
    c_j, a_j = jkmeans.kmeans(ds.vectors, 6, iters=8, seed=5)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-4, atol=1e-4)
    assert np.mean(a_t == a_j) > 0.99
    d = ((ds.vectors[:, None, :] - c_t[None]) ** 2).sum(-1)
    assert np.mean(d.argmin(1) == a_t) > 0.99


@pytest.mark.parametrize("onehot_elems", [1 << 24, 6 * 50])
def test_lloyd_fixed_order_sums_match_reference(monkeypatch, onehot_elems):
    """``_lloyd`` sums clusters by one-hot products over fixed chunks of
    points (one chunk, or 50 points a chunk): on the k-means parity data
    its centroids and assignments match the JAX package's ``_lloyd``
    (``segment_sum``) at the parity tolerance, an empty cluster (a
    duplicated initial centroid, reseeded) included, and a second run is
    bit-equal."""
    monkeypatch.setattr(kmeans, "_ONEHOT_ELEMS", onehot_elems)
    x = jds.clustered(600, 8, n_clusters=6, seed=1).vectors
    rng = np.random.default_rng(4)
    init = x[rng.choice(len(x), 6, replace=False)].copy()
    init[1] = init[0]                  # cluster 1 starts empty
    c_j, a_j, _ = jkmeans._lloyd(jnp.asarray(x),
                                 jnp.ones(len(x), dtype=bool),
                                 jnp.asarray(init), 6, 8)
    runs = [kmeans._lloyd(torch.as_tensor(x), torch.as_tensor(init), 6, 8)
            for _ in range(2)]
    c_t, a_t = (t.numpy() for t in runs[0])
    np.testing.assert_allclose(c_t, np.asarray(c_j), rtol=1e-4, atol=1e-4)
    assert np.mean(a_t == np.asarray(a_j)) > 0.99
    assert (np.bincount(a_t, minlength=6) > 0).all()
    assert torch.equal(runs[0][0], runs[1][0])
    assert torch.equal(runs[0][1], runs[1][1])


def test_assign_host_gate_and_kernel_path_match_reference():
    rng = np.random.default_rng(6)
    c = rng.normal(size=(40, 8)).astype(np.float32)
    x = rng.normal(size=(300, 8)).astype(np.float32)
    np.testing.assert_array_equal(kmeans.assign(x, c, device="cpu"),
                                  jkmeans.assign(x, c))
    # the kernel path, its plain version on the CPU
    a_k = kmeans.assign(x, c, impl="cuda", device="cpu")
    assert np.mean(a_k == jkmeans.assign(x, c, impl="pallas")) > 0.99
    big = rng.normal(size=(110_000, 8)).astype(np.float32)  # n*p > 2^22
    a_big = kmeans.assign(big, c, device="cpu")
    assert np.mean(a_big == jkmeans.assign(big, c, impl="jnp")) > 0.999


# ---------------------------------------------------------------------------
# the dynamic index
# ---------------------------------------------------------------------------

def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable")
    x = np.zeros((10, 4), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        QuakeIndex(4)
    with pytest.raises(RuntimeError):
        QuakeIndex.build(x)
    with pytest.raises(RuntimeError):
        index_from_arrays(index_to_arrays(
            QuakeIndex.build(x, num_partitions=2, device="cpu")))


def test_build_invariants_and_recall():
    ds = datasets.clustered(3000, 16, n_clusters=16, seed=2)
    idx = QuakeIndex.build(ds.vectors, num_partitions=30, kmeans_iters=6,
                           device="cpu")
    idx.check_invariants()
    assert idx.num_vectors == 3000 and idx.num_partitions == 30
    q = datasets.queries_near(ds, 40, seed=3)
    gt = ds.ground_truth(q, 10)
    r = idx.search_batch(q, 10, nprobe=8)
    rec = np.mean([len(set(a) & set(b)) / 10 for a, b in zip(r.ids, gt)])
    assert rec >= 0.95
    idx2 = QuakeIndex.build(ds.vectors, level_sizes=(30, 5),
                            kmeans_iters=4, device="cpu")
    idx2.check_invariants()
    res = idx2.search(q[0], 10)
    assert len(res.ids) == 10 and set(res.nprobe) == {0, 1}


@pytest.mark.parametrize("scan_impl", ["numpy", "cuda", "auto"])
def test_per_query_search_matches_reference(pair, scan_impl):
    ds, j, p = pair
    carried = p.config.scan_impl
    p.config.scan_impl = scan_impl
    try:
        q = jds.queries_near(ds, 6, seed=9)
        for qi in q:
            for kw in (dict(), dict(nprobe=4)):
                rj = j.search(qi, 10, record_stats=False, **kw)
                rt = p.search(qi, 10, record_stats=False, **kw)
                np.testing.assert_array_equal(np.sort(rt.ids),
                                              np.sort(rj.ids))
                assert rt.nprobe == rj.nprobe
                assert rt.vectors_scanned == rj.vectors_scanned
                if scan_impl != "cuda":      # auto is numpy on the CPU
                    np.testing.assert_equal(rt.recall_estimate,
                                            rj.recall_estimate)
    finally:
        p.config.scan_impl = carried


def test_insert_delete_match_reference():
    ds = jds.clustered(2000, 8, n_clusters=8, seed=5)
    j = JIndex.build(ds.vectors, num_partitions=20, kmeans_iters=3)
    p = index_from_arrays(export_jax_index(j), device="cpu")
    rng = np.random.default_rng(0)
    new = (ds.vectors[:150] + 0.05 * rng.normal(size=(150, 8))).astype(
        np.float32)
    ids = np.arange(5000, 5150)
    for idx in (j, p):
        idx.insert(new, ids)
        assert idx.delete(np.arange(0, 300, 3)) == 100
    p.check_invariants()
    sj, sp = export_jax_index(j), index_to_arrays(p)
    for key in ("level0.sizes", "level0.vectors", "level0.ids",
                "level0.sqnorms", "level0.centroids"):
        np.testing.assert_array_equal(sp[key], sj[key])
    assert p.version == j.version and p.id_map == j.id_map
    assert p._max_norm_sq == j._max_norm_sq
    with pytest.raises(ValueError):          # ids must match the rows
        p.insert(new, ids[:3])
    assert p.version == j.version


def test_convert_round_trip(pair):
    _, _, p = pair
    q = index_from_arrays(index_to_arrays(p), device="cpu")
    a, b = index_to_arrays(p), index_to_arrays(q)
    assert a.keys() == b.keys()
    for key in a:
        np.testing.assert_array_equal(np.asarray(a[key]),
                                      np.asarray(b[key]))
    assert q.id_map == p.id_map


# ---------------------------------------------------------------------------
# snapshot
# ---------------------------------------------------------------------------

def test_snapshot_matches_reference(pair):
    _, j, p = pair
    for cap in (None, 1000):
        sj = JSnapshot.from_index(j, capacity=cap, headroom=1.3)
        sp = IndexSnapshot.from_index(p, capacity=cap, headroom=1.3)
        for f in ("data", "ids", "centroids", "sizes"):
            np.testing.assert_array_equal(getattr(sp, f).numpy(),
                                          np.asarray(getattr(sj, f)), f)
        np.testing.assert_allclose(sp.beta_table.numpy(),
                                   np.asarray(sj.beta_table), atol=2e-5)
    for s in (1, 8, 9, 500, 513, 1500):
        assert IndexSnapshot.align_capacity(s) == \
            JSnapshot.align_capacity(s)
    with pytest.raises(ValueError):
        IndexSnapshot.from_index(p, capacity=8)


@pytest.mark.parametrize("donate", [False, True])
def test_snapshot_delta_matches_fresh_snapshot(donate):
    ds = datasets.clustered(1500, 8, n_clusters=6, seed=7)
    idx = QuakeIndex.build(ds.vectors, num_partitions=12, kmeans_iters=3,
                           device="cpu")
    snap = IndexSnapshot.from_index(idx, headroom=2.0)
    data0 = snap.data.clone()
    rows = idx.levels[0].ids[3][:5]
    idx.delete(rows)
    idx.insert(idx.levels[0].vectors[4][:7] + 0.01,
               np.arange(9000, 9007))
    delta = idx.journal.delta_since(0)
    patch = IndexSnapshot.build_patch(idx, delta.dirty, snap.capacity)
    new = snap.apply_delta(patch, donate=donate)
    fresh = IndexSnapshot.from_index(idx, capacity=snap.capacity)
    for f in ("data", "ids", "centroids", "sizes"):
        np.testing.assert_array_equal(getattr(new, f).numpy(),
                                      getattr(fresh, f).numpy())
    # copy-on-write leaves the old snapshot readable; donation updates it
    assert torch.equal(snap.data, data0) != donate


def test_port_imports_neither_jax_nor_repro():
    code = (
        "import importlib, pkgutil, sys\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, "
        "'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [n for n in sys.modules if n == 'jax' or n.startswith('jax.')"
        " or n == 'repro' or n.startswith('repro.')]\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith('repro_torch')]))"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    assert int(out.stdout.strip()) >= 18    # every module was imported

"""The port's maintenance slice against the JAX package: the cost model,
k-means split and refinement, ``Maintainer`` (split, merge, rejection,
level add/remove), checkpoint/restore, the workload generators, and a
three-month replay of the Wikipedia-style dynamic workload.

Maintenance parity runs on identical statistics: the JAX index is built
and searched (which records access statistics), then loaded into the port
with its statistics through ``index_from_arrays``, and both packages run
``Maintainer.run()`` with the same latency model.  The cost math is the
same numpy in both, so costs agree exactly before any k-means runs; the
2-means of a split and the Lloyd step of refinement sum f32 distances in
another order (torch vs XLA), which may move a point at a near-tie, so
later decisions are compared by outcome, with the tolerance stated per
test.
"""
import numpy as np
import pytest
import torch

from repro.core import LatencyModel as JLatency
from repro.core import Maintainer as JMaintainer
from repro.core import QuakeConfig as JConfig
from repro.core import QuakeIndex as JIndex
from repro.core import cost_model as jcm
from repro.core import kmeans as jkmeans
from repro.data import datasets as jds
from repro.data import wikipedia as jwiki
from repro.data import workload as jwl
from repro_torch.core import (LatencyModel, Maintainer, MaintenancePolicy,
                              QuakeConfig, QuakeIndex, checkpoint_index,
                              restore_index)
from repro_torch.core import cost_model as cm
from repro_torch.core import kmeans
from repro_torch.core.convert import index_from_arrays, index_to_arrays
from repro_torch.data import datasets, wikipedia, workload
from test_torch_core import export_jax_index


def _port(j):
    return index_from_arrays(export_jax_index(j), device="cpu")


def _decisions(rep):
    return [(a["level"], a["part"], a["kind"], a["committed"])
            for a in rep.actions]


# ---------------------------------------------------------------------------
# cost model
# ---------------------------------------------------------------------------

def test_cost_model_functions_match_reference():
    sizes = np.array([50, 250, 450, 500])
    lats = np.array([250e3, 550e3, 1050e3, 1200e3])
    fit, jfit = cm.fit_latency_model(sizes, lats, 8), \
        jcm.fit_latency_model(sizes, lats, 8)
    assert (fit.c_fixed, fit.c_lin, fit.c_sel, fit.dim) == \
        (jfit.c_fixed, jfit.c_lin, jfit.c_sel, jfit.dim)
    lam, jlam = LatencyModel(), JLatency()
    rng = np.random.default_rng(0)
    s_lv = [rng.integers(0, 900, 40), rng.integers(1, 40, 6)]
    f_lv = [rng.random(40), rng.random(6)]
    assert cm.total_cost(lam, s_lv, f_lv) == jcm.total_cost(jlam, s_lv, f_lv)
    assert cm.split_delta_estimate(lam, 40, 800.0, 0.3, 0.9) == \
        jcm.split_delta_estimate(jlam, 40, 800.0, 0.3, 0.9)
    assert cm.split_delta_verify(lam, 40, 800.0, 0.3, 390.0, 410.0, 0.9) == \
        jcm.split_delta_verify(jlam, 40, 800.0, 0.3, 390.0, 410.0, 0.9)
    recv_s, recv_f = np.array([100.0, 300.0, 50.0]), np.array([.1, .2, .3])
    assert cm.merge_delta_estimate(lam, 40, 20.0, 0.05, recv_s, recv_f) == \
        jcm.merge_delta_estimate(jlam, 40, 20.0, 0.05, recv_s, recv_f)
    after, extra = recv_s + [5, 10, 5], np.array([.01, .02, .01])
    assert cm.merge_delta_verify(lam, 40, 20.0, 0.05, recv_s, after, recv_f,
                                 extra) == \
        jcm.merge_delta_verify(jlam, 40, 20.0, 0.05, recv_s, after, recv_f,
                               extra)


def test_profile_fits_nonnegative_coefficients_on_the_cpu():
    lam = cm.profile(16, sizes=(64, 256, 1024), repeats=2, device="cpu")
    assert min(lam.c_fixed, lam.c_lin, lam.c_sel) >= 0.0 and lam.dim == 16
    assert (lam(np.array([10, 100, 1000])) > 0).all()
    if not torch.cuda.is_available():       # the default device is the card
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cm.profile(16, sizes=(64,))


# ---------------------------------------------------------------------------
# k-means: split and refinement
# ---------------------------------------------------------------------------

def test_split_two_matches_reference_including_the_degenerate_fallback():
    rng = np.random.default_rng(3)
    x = np.concatenate([rng.normal(size=(300, 12)) - 2.0,
                        rng.normal(size=(200, 12)) + 2.0]).astype(np.float32)
    c_t, a_t = kmeans.split_two(x, seed=7, device="cpu")
    c_j, a_j = jkmeans.split_two(x, seed=7)
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-4, atol=1e-4)
    same = np.ones((6, 4), np.float32)           # 2-means cannot split
    c_t, a_t = kmeans.split_two(same, device="cpu")
    c_j, a_j = jkmeans.split_two(same)
    np.testing.assert_array_equal(a_t, a_j)
    np.testing.assert_array_equal(c_t, c_j)
    assert 0 < a_t.sum() < len(a_t)
    with pytest.raises(ValueError):
        kmeans.split_two(x[:1], device="cpu")


def test_refine_matches_reference():
    """One Lloyd step seeded by perturbed centroids, one seed far from
    every point (its cluster is emptied and reseeded to the worst-fit
    point): memberships equal (no near-tie here), centroids to rtol/atol
    1e-4 (f32 cluster sums in another order)."""
    rng = np.random.default_rng(4)
    centers = rng.normal(size=(5, 10)) * 5
    parts = [((centers[i] + rng.normal(size=(80 + 20 * i, 10)))
              .astype(np.float32), np.arange(80 + 20 * i) + 1000 * i)
             for i in range(5)]
    seeds = (centers + 0.3 * rng.normal(size=centers.shape)).astype(
        np.float32)
    seeds = np.concatenate([seeds, np.full((1, 10), 50.0, np.float32)])
    parts.append((np.zeros((0, 10), np.float32), np.zeros(0, np.int64)))
    c_t, p_t = kmeans.refine(parts, seeds, iters=1, device="cpu")
    c_j, p_j = jkmeans.refine(parts, seeds, iters=1)
    np.testing.assert_allclose(c_t, c_j, rtol=1e-4, atol=1e-4)
    for (xt, it), (xj, ij) in zip(p_t, p_j):
        np.testing.assert_array_equal(it, ij)
        np.testing.assert_array_equal(xt, xj)


# ---------------------------------------------------------------------------
# Maintainer: the first pass commits and rejects what the reference does
# ---------------------------------------------------------------------------

def _skewed_pair(hot=2, cold=20, hot_size=5000, cold_size=300, dim=24,
                 seed=1, **cfg_kw):
    """tests/test_maintenance.py's skewed fixture, built and searched in
    the JAX package, and the port loaded from it with its statistics."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(size=(hot + cold, dim)) * 6
    parts = [centers[i] + rng.normal(size=(hot_size, dim))
             for i in range(hot)]
    parts += [centers[hot + i] + rng.normal(size=(cold_size, dim))
              for i in range(cold)]
    x = np.concatenate(parts).astype(np.float32)
    j = JIndex.build(x, num_partitions=hot + cold,
                     config=JConfig(**cfg_kw), kmeans_iters=4)
    queries = np.concatenate(
        [centers[i] + rng.normal(size=(100, dim)) for i in range(hot)]
    ).astype(np.float32)
    for q in queries:
        j.search(q, 10)
    return j, _port(j), x


def _same_first_pass(j, p, lam=None, policy=None):
    rj = JMaintainer(j, lam).run() if policy is None else \
        JMaintainer(j, lam, policy=policy).run()
    rp = Maintainer(p, None if lam is None else LatencyModel(
        lam.c_fixed, lam.c_lin, lam.c_sel, lam.dim), policy).run()
    assert rp.cost_before == rj.cost_before
    assert _decisions(rp) == _decisions(rj)
    for f in ("splits", "merges", "rejected_splits", "rejected_merges",
              "level_added", "level_removed"):
        assert getattr(rp, f) == getattr(rj, f), f
    assert [lv.num_partitions for lv in p.levels] == \
        [lv.num_partitions for lv in j.levels]
    # refinement's Lloyd step moves a point at an f32 near-tie in one
    # framework and not the other; the next 2-means of a round Gaussian
    # blob (many near-equal splits) then cuts it elsewhere.  The same
    # actions commit, but sizes move by up to 2% of the vectors and the
    # cost after the pass agrees to 2e-3
    moved = np.abs(p.levels[0].sizes() - j.levels[0].sizes()).sum()
    assert moved <= 0.02 * p.num_vectors
    np.testing.assert_allclose(rp.cost_after, rj.cost_after, rtol=2e-3)
    p.check_invariants()
    return rp, rj


def test_split_pass_matches_reference():
    j, p, _ = _skewed_pair()
    assert export_jax_index(j)["level0.window"] == 200
    np.testing.assert_array_equal(p.levels[0].stats.hits,
                                  j.levels[0].stats.hits)
    rp, _ = _same_first_pass(j, p)
    assert rp.splits >= 1 and rp.cost_after <= rp.cost_before + 1e-6
    assert p.maintenance_log[-1]["partitions"] == \
        j.maintenance_log[-1]["partitions"]
    assert [e["reason"] for e in p.maintenance_log[-1]["journal"]] == \
        [e["reason"] for e in j.maintenance_log[-1]["journal"]]


def test_rejection_and_merge_passes_match_reference():
    j, p, _ = _skewed_pair(tau_ns=1e12)          # tau blocks every commit
    rp, _ = _same_first_pass(j, p)
    assert rp.splits == rp.merges == 0 and rp.actions == []
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4000, 16)).astype(np.float32)
    j = JIndex.build(x, num_partitions=200,
                     config=JConfig(min_partition_size=64, tau_ns=1.0),
                     kmeans_iters=3)
    for q in x[rng.integers(0, 4000, 200)]:
        j.search(q, 10)
    rp, _ = _same_first_pass(j, _port(j))
    assert rp.merges >= 1


def test_level_add_and_remove_match_reference():
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3000, 8)).astype(np.float32)
    j = JIndex.build(x, num_partitions=64,
                     config=JConfig(level_add_threshold=32))
    p = _port(j)
    rp, _ = _same_first_pass(j, p)
    assert rp.level_added and len(p.levels) == 2
    # the new top level is k-means on the centroids: same sizes up to a
    # near-tie between the two frameworks' f32 sums
    assert abs(int(np.abs(p.levels[1].sizes()
                          - j.levels[1].sizes()).sum())) <= 2
    for idx in (j, p):
        idx.config.level_add_threshold = 10 ** 9
        idx.config.level_remove_threshold = 10 ** 6
    rp, _ = _same_first_pass(j, p)
    assert rp.level_removed and len(p.levels) == 1


def test_policies_and_noop_pass():
    """NoRej commits every tentative action; a pass where nothing commits
    leaves the clock and the cached snapshot alone."""
    from repro_torch.core.multiquery import get_executor
    j, p, x = _skewed_pair()
    rep = Maintainer(p, policy=MaintenancePolicy(use_rejection=False)).run()
    assert rep.rejected_splits == 0 and rep.rejected_merges == 0
    p.check_invariants()
    _, p, x = _skewed_pair(tau_ns=1e12)
    p.search_batch(x[:4], 5, nprobe=4)
    ex = get_executor(p)
    v0, key0 = p.version, ex._key
    rep = Maintainer(p).run()
    assert rep.splits == 0 and p.version == v0
    p.search_batch(x[:4], 5, nprobe=4)
    assert ex._key == key0 and ex.full_rebuilds == 1
    assert p.maintenance_log[-1]["journal"] == []


def test_unpriced_cost_accounts_for_refinement_and_levels():
    """The commit gate prices splits and merges exactly: net of the
    unpriced refinement and level changes, a pass moves the cost by the
    sum of its committed verify deltas; without refinement nothing is
    unpriced."""
    _, p, _ = _skewed_pair()
    rep = Maintainer(p).run()
    assert rep.splits >= 1 and rep.unpriced_cost != 0.0
    priced = sum(a["delta"] for a in rep.actions if a["committed"])
    np.testing.assert_allclose(rep.cost_after - rep.unpriced_cost,
                               rep.cost_before + priced, rtol=1e-9)
    assert priced < 0
    _, p, _ = _skewed_pair()
    rep = Maintainer(p, policy=MaintenancePolicy(use_refinement=False)).run()
    assert rep.splits >= 1 and rep.unpriced_cost == 0.0
    assert rep.cost_after <= rep.cost_before + 1e-6


def test_checkpoint_restore_round_trip():
    _, p, _ = _skewed_pair()
    before = index_to_arrays(p)
    v0, id_map = p.version, dict(p.id_map)
    ckpt = checkpoint_index(p)
    rep = Maintainer(p).run()
    assert rep.splits >= 1 and p.version > v0
    restore_index(p, ckpt)
    after = index_to_arrays(p)
    assert before.keys() == after.keys()
    for key in before:
        np.testing.assert_array_equal(np.asarray(before[key], dtype=object),
                                      np.asarray(after[key], dtype=object),
                                      key)
    assert p.version == v0 and p.id_map == id_map
    assert p.journal.delta_since(v0).empty
    p.check_invariants()


def test_split_forces_an_int8_rebuild_and_serves_the_new_layout():
    """A committed split is structural: the int8 executor requantizes by
    a full rebuild (never a delta) and its results match the f32
    executor's on the new layout."""
    from repro_torch.core.multiquery import get_executor
    _, p, x = _skewed_pair()
    q = x[::997][:16]
    ex8 = get_executor(p, "int8")
    ex8.search(q, 10, nprobe=4)
    rep = Maintainer(p).run()
    assert rep.splits >= 1
    r8 = ex8.search(q, 10, nprobe=4)
    assert (ex8.full_rebuilds, ex8.delta_refreshes) == (2, 0)
    assert ex8._snap.num_partitions == p.num_partitions
    r32 = get_executor(p).search(q, 10, nprobe=4)
    assert np.mean(r8.ids == r32.ids) >= 0.95


# ---------------------------------------------------------------------------
# workload generators (numpy copies) and the dynamic replay
# ---------------------------------------------------------------------------

def test_workload_generators_are_copies_of_reference():
    np.testing.assert_array_equal(datasets.zipf_weights(50, 1.05),
                                  jds.zipf_weights(50, 1.05))
    a = wikipedia.wikipedia_workload(n_total=3000, dim=8, months=3,
                                     queries_per_month=40, seed=2)
    b = jwiki.wikipedia_workload(n_total=3000, dim=8, months=3,
                                 queries_per_month=40, seed=2)
    np.testing.assert_array_equal(a.dataset.vectors, b.dataset.vectors)
    np.testing.assert_array_equal(a.initial_ids, b.initial_ids)
    assert a.dataset.metric == b.dataset.metric == "ip"
    assert [o.kind for o in a.operations] == [o.kind for o in b.operations]
    for oa, ob in zip(a.operations, b.operations):
        for f in ("ids", "vectors", "queries"):
            if getattr(ob, f) is not None:
                np.testing.assert_array_equal(getattr(oa, f), getattr(ob, f))
    ds = datasets.clustered(1500, 8, n_clusters=6, seed=1)
    cfg = workload.WorkloadConfig(n_operations=12, vectors_per_op=50,
                                  delete_fraction=0.3, query_skew=0.5,
                                  queries_per_op=10, seed=3)
    wa = workload.generate(ds, cfg)
    wb = jwl.generate(jds.clustered(1500, 8, n_clusters=6, seed=1),
                      jwl.WorkloadConfig(**cfg.__dict__))
    assert [o.kind for o in wa.operations] == [o.kind for o in wb.operations]
    np.testing.assert_array_equal(wa.resident_ids_after(11),
                                  wb.resident_ids_after(11))


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_incremental_ground_truth_matches_reference(metric):
    ds = datasets.clustered(2000, 8, n_clusters=6, seed=2, metric=metric)
    jd = jds.clustered(2000, 8, n_clusters=6, seed=2, metric=metric)
    q = datasets.queries_near(ds, 12, seed=3)
    gt_n = workload.IncrementalGroundTruth(ds, np.arange(1500))
    gt_t = workload.IncrementalGroundTruth(ds, np.arange(1500), device="cpu")
    gt_j = jwl.IncrementalGroundTruth(jd, np.arange(1500))
    for g in (gt_n, gt_t, gt_j):
        g.insert(np.arange(1500, 2000))
        g.delete(np.arange(0, 300, 2))
    want = gt_j.topk(q, 10)
    np.testing.assert_array_equal(gt_n.topk(q, 10), want)
    assert np.mean(gt_t.topk(q, 10) == want) >= 0.99   # f32 on the device
    np.testing.assert_array_equal(gt_n.resident_ids, gt_j.resident_ids)


def _dynamic_replay():
    import importlib
    import sys
    from pathlib import Path
    scripts = str(Path(__file__).resolve().parents[1] / "scripts")
    if scripts not in sys.path:
        sys.path.insert(0, scripts)
    return importlib.import_module("dynamic_replay")


def test_dynamic_replay_tracks_reference():
    """Three months of the Wikipedia-style workload (inner product,
    insert bursts, Zipf queries with a drifting hot set) through both
    packages from one converted index, by ``scripts/dynamic_replay.py``'s
    month loop: per month the insert burst, 120 per-query APS searches at
    target 0.9 (which record access statistics) and one maintenance pass.
    Partition counts agree within 2 each month and recall within 0.02 (a
    near-tie in refine's f32 sums can move a point and, with it, a later
    decision)."""
    wl = jwiki.wikipedia_workload(n_total=6000, dim=16, months=3,
                                  queries_per_month=120, seed=0)
    cfg = JConfig(metric="ip")
    j = JIndex.build(wl.initial_vectors, wl.initial_ids, config=cfg,
                     kmeans_iters=5)
    p = _port(j)
    assert isinstance(p.config, QuakeConfig) and p.config.metric == "ip"
    months = 0
    for row in _dynamic_replay().replay(
            wl, {"jax": j, "port": p},
            {"jax": JMaintainer(j), "port": Maintainer(p)}):
        months += 1
        rj, rp = row["jax"], row["port"]
        assert rp["cost_after"] <= rp["cost_before"] + 1e-6
        p.check_invariants()
        assert abs(rp["partitions"] - rj["partitions"]) <= 2
        assert abs(rp["recall"] - rj["recall"]) <= 0.02, row
    assert months == 3

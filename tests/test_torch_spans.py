"""The executor's ``quake.*`` spans and counters (``obs.tracing.span``):
the tree one batch emits under ``torch.profiler``, the blocking copies
counted as ``quake.wait``, the snapshot and radius counters, the
maintenance pass, and nothing at all while the profiler is off."""
import json

import numpy as np
import pytest
import torch

from repro_torch.core import multiquery as mq
from repro_torch.core.index import QuakeConfig, QuakeIndex
from repro_torch.core.maintenance import Maintainer, MaintenancePolicy
from repro_torch.core.serving import ServingConfig, ServingRuntime
from repro_torch.obs import tracing

K = 10

# each span's parent in the chrome trace ("outer": the test's own)
APS_PARENTS = {
    "quake.search_batch": {"outer"},
    "quake.snapshot": {"quake.search_batch"},
    "quake.plan": {"quake.search_batch"},
    "quake.plan.radius": {"quake.plan"},
    "quake.plan.centroids": {"quake.plan"},
    "quake.plan.estimate": {"quake.plan"},
    "quake.rounds": {"quake.search_batch"},
    "quake.round": {"quake.rounds"},
    "quake.round.select": {"quake.round"},
    "quake.scan": {"quake.round"},
    "quake.plan.pages": {"quake.scan"},
    "quake.merge": {"quake.round"},
    "quake.round.estimate": {"quake.round"},
    "quake.result": {"quake.search_batch"},
    "quake.wait": {"quake.search_batch", "quake.scan",
                   "quake.round.estimate", "quake.result"},
}
NPROBE_PARENTS = {
    "quake.search_batch": {"outer"},
    "quake.snapshot": {"quake.search_batch"},
    "quake.plan": {"quake.search_batch"},
    "quake.plan.centroids": {"quake.plan"},
    "quake.plan.pack": {"quake.plan"},
    "quake.plan.pages": {"quake.plan.pack"},
    "quake.scan": {"quake.search_batch"},
    "quake.result": {"quake.search_batch"},
    "quake.wait": {"quake.plan.pack", "quake.scan", "quake.result"},
}


def _rows(n, d, seed):
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 4.0, (64, d))
    pick = rng.integers(64, size=n)
    return (centers[pick] + rng.normal(0, 1.0, (n, d))).astype(np.float32)


@pytest.fixture()
def index():
    x = _rows(4000, 16, 0)
    return QuakeIndex.build(x, num_partitions=40, kmeans_iters=3,
                            config=QuakeConfig(recall_target=0.95),
                            device="cpu")


QUERIES = _rows(32, 16, 1)


def _aps(idx):
    return idx.search_batch(QUERIES, K)


def _nprobe(idx):
    return idx.search_batch(QUERIES, K, nprobe=6, rounds=1)


def _delta(before, after):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _profiled(fn, tmp_path=None):
    """``fn()`` under the profiler inside an outer record function: its
    result, the program totals it added and, with ``tmp_path``, the
    chrome trace's user annotations."""
    before = tracing.program_totals()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU],
            record_shapes=tmp_path is not None) as prof:
        with torch.profiler.record_function("outer"):
            out = fn()
    added = _delta(before, tracing.program_totals())
    if tmp_path is None:
        return out, added, None
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())["traceEvents"]
              if e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    return out, added, events


def _parents(events):
    """(name, parent name, batch number) of every ``quake.`` event, the
    parent being the innermost event that contains it."""
    evs = sorted(events, key=lambda e: (float(e["ts"]), -float(e["dur"])))
    stack, out = [], []
    for e in evs:
        a, b = float(e["ts"]), float(e["ts"]) + float(e["dur"])
        while stack and stack[-1][1] < b:
            stack.pop()
        if e["name"].startswith("quake."):
            assert stack, f"{e['name']} outside the outer span"
            seq = e["args"]["Concrete Inputs"][0]
            out.append((e["name"], stack[-1][2], seq))
        stack.append((a, b, e["name"]))
    return out


@pytest.mark.parametrize("run,parents", [(_aps, APS_PARENTS),
                                         (_nprobe, NPROBE_PARENTS)],
                         ids=["aps", "nprobe"])
def test_one_batch_emits_the_span_tree(index, tmp_path, run, parents):
    run(index)                            # the snapshot, the radius
    r, added, events = _profiled(lambda: run(index), tmp_path)
    tree = _parents(events)
    names = {n for n, _, _ in tree}
    assert names == set(parents)
    for name, parent, _ in tree:
        assert parent in parents[name], (name, parent)
    # every span of the batch carries the batch's one number
    assert len({seq for _, _, seq in tree}) == 1
    assert added["quake.search_batch.count"] == 1
    assert added["quake.plan.count"] == 1
    if run is _aps:
        assert r.rounds >= 2
        assert added["quake.round.count"] == r.rounds
        assert added["quake.scan.count"] == r.rounds
        assert added["quake.plan.radius.hits"] == 1
    # a parent's time holds its children's
    assert added["quake.search_batch.ns"] >= added["quake.plan.ns"] \
        + added["quake.result.ns"]
    assert 0 < added["quake.wait.ns"] <= added["quake.search_batch.ns"]
    assert added["quake.search_batch.wait_ns"] == added["quake.wait.ns"]


def test_two_batches_carry_two_numbers(index, tmp_path):
    _aps(index)
    _, _, events = _profiled(lambda: (_aps(index), _nprobe(index)),
                             tmp_path)
    seqs = {seq for name, _, seq in _parents(events)
            if name == "quake.search_batch"}
    assert len(seqs) == 2


def test_wait_count_is_the_copy_sites(index):
    """APS: the queries' and the sequences' uploads, a take-mask upload
    and a k-th distance pull a round, two result pulls.  ``nprobe``: the
    pack's three uploads and two mirror pulls, the queries' upload, two
    result pulls."""
    _aps(index)
    r, added, _ = _profiled(lambda: _aps(index))
    assert added["quake.wait.count"] == 2 * r.rounds + 4
    _, added, _ = _profiled(lambda: _nprobe(index))
    assert added["quake.wait.count"] == 8


@pytest.mark.parametrize("planner,on_card", [("fused", 1),
                                             ("vectorized", 0)])
@pytest.mark.parametrize("mode", [{}, {"nprobe": 6, "rounds": 1}],
                         ids=["aps", "nprobe"])
def test_plans_on_the_card_are_counted(index, planner, on_card, mode):
    """``quake.plan.on_card`` counts once a batch whose plan ran on the
    index's device (the fused planner), and never for the host planner."""
    ex = mq.BatchedSearchExecutor(index, planner=planner)
    ex.search(QUERIES, K, **mode)             # the snapshot, the radius
    _, added, _ = _profiled(lambda: [ex.search(QUERIES, K, **mode)
                                     for _ in range(3)])
    assert added["quake.search_batch.count"] == 3
    assert added.get("quake.plan.on_card.count", 0) == 3 * on_card
    assert added["quake.plan.count"] == 3


def test_fused_plans_upload_the_queries_once(index, monkeypatch):
    """The fused planner plans on the queries the scan reads: one upload
    of the batch.  APS: that upload, one pull of the plan's five arrays,
    a take-mask upload and a k-th pull a round, two result pulls.
    ``nprobe``: that upload, one pull of the union width and the anchors,
    the two mirror pulls, two result pulls."""
    ex = mq.BatchedSearchExecutor(index, planner="fused")
    for mode in ({}, {"nprobe": 6, "rounds": 1}):
        ex.search(QUERIES, K, **mode)
    uploads = []
    real = mq.to_device

    def recorded(a, device):
        uploads.append(np.shape(a))
        return real(a, device)
    monkeypatch.setattr(mq, "to_device", recorded)
    r, added, _ = _profiled(lambda: ex.search(QUERIES, K))
    assert r.rounds >= 2
    assert uploads.count(QUERIES.shape) == 1
    assert added["quake.wait.count"] == 2 * r.rounds + 4
    uploads.clear()
    _, added, _ = _profiled(lambda: ex.search(QUERIES, K, nprobe=6,
                                              rounds=1))
    assert uploads == [QUERIES.shape]
    assert added["quake.wait.count"] == 6


def test_profiler_off_records_nothing_and_answers_agree(index,
                                                        monkeypatch):
    _aps(index)
    _nprobe(index)
    on = [_profiled(lambda: run(index))[0] for run in (_aps, _nprobe)]

    def refuse(*a, **kw):
        raise AssertionError("a span recorded with the profiler off")
    for owner, attr in ((torch.autograd, "_record_function_with_args_enter"),
                        (torch.profiler, "record_function"),
                        (torch.autograd.profiler, "record_function"),
                        (tracing._PROGRAM, "update"),
                        (tracing._PROGRAM, "inc"),
                        (tracing._PROGRAM, "observe")):
        monkeypatch.setattr(owner, attr, refuse)
    before = tracing.program_totals()
    off = [run(index) for run in (_aps, _nprobe)]
    assert tracing.program_totals() == before
    for a, b in zip(on, off):
        np.testing.assert_array_equal(a.ids, b.ids)
        np.testing.assert_array_equal(a.dists, b.dists)
        np.testing.assert_array_equal(a.nprobe, b.nprobe)
        np.testing.assert_array_equal(a.recall_estimate, b.recall_estimate)
        assert a.rounds == b.rounds and a.comparisons == b.comparisons


def test_radius_calibrations_then_hits(index):
    _, added, _ = _profiled(lambda: [_aps(index) for _ in range(3)])
    assert added["quake.plan.radius.calibrations"] == 1
    assert added["quake.plan.radius.hits"] == 2
    assert added["quake.plan.radius.count"] == 3


def test_snapshot_counters_follow_an_insert_and_a_split(index):
    ex = mq.get_executor(index)
    _aps(index)
    rebuilds, deltas = ex.full_rebuilds, ex.delta_refreshes
    rng = np.random.default_rng(5)
    new = QUERIES[:4] + rng.normal(0, 0.01, (4, 16)).astype(np.float32)
    index.insert(new, np.arange(90_000, 90_004))
    _, added, _ = _profiled(lambda: _aps(index))
    assert added["quake.snapshot.delta_refreshes"] == 1
    assert "quake.snapshot.full_rebuilds" not in added
    assert added["quake.snapshot.delta.count"] == 1
    assert (ex.full_rebuilds, ex.delta_refreshes) == (rebuilds, deltas + 1)

    # one partition four times the mean: the size policy splits it
    big = np.repeat(QUERIES[:1], 400, axis=0) \
        + rng.normal(0, 0.5, (400, 16)).astype(np.float32)
    index.insert(big, np.arange(100_000, 100_400))
    policy = MaintenancePolicy(use_cost_model=False, use_rejection=False,
                               use_refinement=False)
    rep, added, _ = _profiled(Maintainer(index, policy=policy).run)
    assert rep.splits >= 1
    assert added["quake.maintenance.count"] == 1
    assert added["quake.maintenance.splits"] == rep.splits
    assert added.get("quake.maintenance.merges", 0) == rep.merges
    _, added, _ = _profiled(lambda: _aps(index))
    assert added["quake.snapshot.full_rebuilds"] == 1
    assert added["quake.snapshot.rebuild.count"] == 1
    assert "quake.snapshot.delta_refreshes" not in added
    assert ex.full_rebuilds == rebuilds + 1


def test_serving_rounds_emit_scan_spans(index):
    rt = ServingRuntime(index, ServingConfig(
        k=K, ticker=False, scan_backend="device", cache_entries=0,
        maint_min_ops=10 ** 9))
    try:
        def serve():
            qids = rt.submit_batch(QUERIES)
            rt.drain()
            return qids
        _, added, _ = _profiled(serve)
        rounds = rt.stats()["rounds_run"]
    finally:
        rt.close()
    assert rounds >= 1
    assert added["quake.scan.count"] == rounds
    # each round uploads its queries and plan and pulls its top-k
    assert added["quake.wait.count"] >= 4 * rounds


def test_maintenance_seconds_on_the_runtime_clock(index):
    now = [100.0]
    rt = ServingRuntime(index, ServingConfig(k=K, ticker=False,
                                             maint_min_ops=10 ** 9),
                        clock=lambda: now[0])
    real = rt.maintenance.run_if_due

    def slow_pass(force=False):
        now[0] += 2.5
        return real(force=force)
    rt.maintenance.run_if_due = slow_pass
    try:
        assert rt.maybe_maintain(force=True) is not None
        now[0] += 1.0
        assert rt.maybe_maintain(force=True) is not None
        flat = rt.metrics_snapshot()
    finally:
        rt.close()
    assert flat["maintenance.seconds.count"] == 2
    assert flat["maintenance.seconds.sum"] == pytest.approx(5.0)
    assert flat["maintenance.seconds.max"] == pytest.approx(2.5)
    assert flat["maintenance.runs"] == 2


def test_threads_keep_their_own_spans_and_lose_no_update():
    """Each thread nests its own spans and flushes its own totals; the
    registry's update is locked, so concurrent flushes lose nothing."""
    import sys
    import threading
    n_threads, n_spans = 12, 150
    switch = sys.getswitchinterval()
    errors = []

    def work():
        try:
            for _ in range(n_spans):
                with tracing.span("stress"):
                    with tracing.span(tracing.WAIT):
                        pass
                    tracing.count("stress.events", 2)
        except Exception as e:      # reported below, after the join
            errors.append(e)

    def run():
        threads = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        return threads
    sys.setswitchinterval(1e-6)
    try:
        threads, added, _ = _profiled(run)
    finally:
        sys.setswitchinterval(switch)
    assert not any(t.is_alive() for t in threads) and not errors
    total = n_threads * n_spans
    assert added["quake.stress.count"] == total
    assert added["quake.stress.events"] == 2 * total
    assert added["quake.wait.count"] == total
    assert added["quake.stress.wait_ns"] == added["quake.wait.ns"]

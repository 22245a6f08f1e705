"""The port's online serving runtime against the JAX package's.

Both runtimes serve one index structure (the JAX index is built and the
port's loaded from its arrays with ``index_from_arrays``) and replay one
op stream — query batches, repeated queries that hit the result cache,
inserts and deletes that invalidate it, and drift-triggered maintenance
— with ``ticker=False`` and a fixed clock.  They must agree on terminal
statuses and result ids exactly, on f32 distances within
``1e-5·|d| + 1e-5``, and on the scheduler's and cache's counters and the
maintenance history, at both scan backends.  On the CPU the port's
``"device"`` backend runs the plain versions of its kernels.  ``|d|`` in
the bound is the scan's own distance, which leaves ``||q||^2`` out (the
kernels' contract, and the bound ``chip_smoke.py`` holds them to): L2
distances near a query are a difference of terms near ``||q||^2``, so
two f32 scans that sum in another order differ by a few ulps of that,
not of the small difference.

The port's own contracts are pinned as the JAX tests pin the
reference's: ``metrics=False`` results byte-identical to metrics on, the
coalescing determinism under any flush timing, ``"auto"`` picking the
host backend off CUDA, and a ticker death that the next admission
restarts without a polling race.
"""
import copy
import threading
import time

import numpy as np
import pytest

from repro.core import QuakeConfig as JConfig
from repro.core import QuakeIndex as JIndex
from repro.core import ServingConfig as JServingConfig
from repro.core import ServingRuntime as JRuntime
from repro.data import datasets as jds
from repro_torch.core import (STATUS_OK, TERMINAL_STATUSES, ServingConfig,
                              ServingRuntime)
from repro_torch.core import serving as srv
from repro_torch.core.convert import index_from_arrays
from repro_torch.faults import FaultInjector
from test_torch_core import export_jax_index

REL, ABS = 1e-5, 1e-5


@pytest.fixture(scope="module")
def ds():
    return jds.clustered(3000, 16, n_clusters=16, seed=0)


@pytest.fixture(scope="module")
def jbase(ds):
    return JIndex.build(ds.vectors, num_partitions=24, kmeans_iters=4,
                        config=JConfig(recall_target=0.9))


def port_of(j):
    return index_from_arrays(export_jax_index(j), device="cpu")


def fixed_clock():
    """A clock that advances 1 ms per read: both runtimes make the same
    reads in the same order, so their latencies agree too."""
    t = [0.0]

    def clock():
        t[0] += 1e-3
        return t[0]
    return clock


def op_stream(ds, seed=0):
    rng = np.random.default_rng(seed)
    q = [jds.queries_near(ds, n, seed=seed + 10 + i).astype(np.float32)
         for i, n in enumerate((21, 13, 9, 17))]
    ins = [(ds.vectors[rng.integers(3000, size=12)]
            + rng.normal(0, 0.01, (12, 16))).astype(np.float32)
           for _ in range(2)]
    return [("q", q[0]), ("q", q[0][:6]),             # exact repeats: hits
            ("insert", ins[0], np.arange(70_000, 70_012)),
            ("q", q[1]), ("q", q[0][6:12]),
            ("delete", np.arange(100, 140)),
            ("q", q[2]), ("insert", ins[1], np.arange(70_012, 70_024)),
            ("q", q[3]), ("q", q[3][:5])]


def replay(rt, ops):
    """Results of the stream's queries, each beside its query."""
    qids, rows = [], []
    for op in ops:
        if op[0] == "q":
            qids += rt.submit_batch(op[1])
            rows += list(op[1])
        elif op[0] == "insert":
            rt.submit_insert(op[1], op[2])
        else:
            rt.submit_delete(op[1])
    rt.drain()
    return [(row, rt.result(i)) for row, i in zip(rows, qids)]


SERVE = dict(k=10, flush_size=8, ticker=False, cache_entries=256,
             maint_min_ops=4, maint_max_ops=6)


def _pair(jbase, ds, backend, **kw):
    cfg = dict(SERVE, scan_backend=backend, **kw)
    j = copy.deepcopy(jbase)
    p = port_of(jbase)
    jrt = JRuntime(j, JServingConfig(**cfg), clock=fixed_clock())
    prt = ServingRuntime(p, ServingConfig(**cfg), clock=fixed_clock())
    ops = op_stream(ds)
    return (jrt, replay(jrt, ops)), (prt, replay(prt, ops))


def _assert_results_match(jres, pres):
    assert len(jres) == len(pres)
    for (q, a), (_, b) in zip(jres, pres):
        assert b.status == a.status and b.status in TERMINAL_STATUSES
        assert np.array_equal(b.ids, a.ids)
        fin = np.isfinite(a.dists)
        assert np.array_equal(fin, np.isfinite(b.dists))
        scan_d = a.dists[fin] - np.sum(q.astype(np.float64) ** 2)
        assert (np.abs(b.dists[fin] - a.dists[fin])
                <= REL * np.abs(scan_d) + ABS).all()
        assert (b.nprobe, b.rounds, b.from_cache, b.batch) == \
            (a.nprobe, a.rounds, a.from_cache, a.batch)
        assert b.latency_s == pytest.approx(a.latency_s)
        # estimates read f32 distances (the planner's centroid pass, the
        # running k-th): rtol 1e-4, as test_torch_slice.py holds them
        np.testing.assert_allclose(b.recall_estimate, a.recall_estimate,
                                   rtol=1e-4, equal_nan=True)


STAT_KEYS = ("queries_submitted", "queries_completed", "cache_hits",
             "write_ops", "status_counts", "rounds_run",
             "admitted_batches", "partitions_streamed",
             "partitions_planned", "vectors_streamed", "comparisons",
             "cache_entries", "cache_invalidated", "cache_stale_puts",
             "maintenance_runs", "maintenance_reasons")


@pytest.mark.parametrize("backend,planner", [
    ("host", "vectorized"), ("device", "vectorized"), ("device", "fused")])
def test_serving_matches_reference(jbase, ds, backend, planner):
    (jrt, jres), (prt, pres) = _pair(jbase, ds, backend, planner=planner)
    _assert_results_match(jres, pres)
    js, ps = jrt.stats(), prt.stats()
    for key in STAT_KEYS:
        assert ps[key] == js[key], key
    assert ps["cache_hits"] > 0 and ps["cache_invalidated"] > 0
    assert ps["maintenance_runs"] >= 1
    assert prt.maintenance.snapshot()["history"] == \
        jrt.maintenance.snapshot()["history"]
    assert prt.scheduler.scan_backend == backend
    for a, b in zip(jrt.scheduler.round_streams,
                    prt.scheduler.round_streams):
        assert np.array_equal(a, b)
    # the unified exposition carries the same names
    jm, pm = jrt.metrics_snapshot(), prt.metrics_snapshot()
    assert set(pm) == set(jm)
    for key in ("serving.rounds_run", "scheduler.rounds",
                "serving.cache_hits", "serving.flushes",
                "maintenance.runs", "trace.completed"):
        assert pm[key] == jm[key], key
    jrt.close()
    prt.close()


def test_early_exit_and_deadlines_match_reference(jbase, ds):
    """Early exit retires on the refined estimate and a budget retires
    PARTIAL at the end of its round: both follow the reference."""
    (jrt, jres), (prt, pres) = _pair(jbase, ds, "device", early_exit=True,
                                     deadline_s=0.004, cache_entries=0)
    _assert_results_match(jres, pres)
    assert prt.stats()["partials"] == jrt.stats()["partials"] > 0
    assert prt.stats()["status_counts"] == jrt.stats()["status_counts"]


def test_round_loop_deadline_matches_reference(jbase, ds):
    """``run_round_loop``'s budget: the trace's deadline fields, and the
    running top-k the expired rows keep."""
    from repro.core import multiquery as jmq
    from repro_torch.core import multiquery as mq
    j, p = copy.deepcopy(jbase), port_of(jbase)
    q = jds.queries_near(ds, 12, seed=5).astype(np.float32)
    out = []
    for m, idx in ((jmq, j), (mq, p)):
        ex = m.BatchedSearchExecutor(idx)
        rplan = m.plan_rounds(idx, q, 10, 0.99, cache=ex.planner_cache,
                              cent_norms=ex._cent_norms)
        snap = ex.snapshot()
        seq_dev = rplan.seq_dev if rplan.seq_dev is not None else \
            rplan.seq.astype(np.int32)
        clock = fixed_clock()
        q_dev = q

        def scan_round(take, kept, ex=ex, snap=snap, m=m, seq=seq_dev):
            if m is mq:
                import torch
                return ex.scan_probe_round(
                    torch.as_tensor(q), torch.as_tensor(seq), take, kept,
                    10, snap=snap, seq_host=rplan.seq)
            import jax.numpy as jnp
            return ex.scan_probe_round(jnp.asarray(q_dev), jnp.asarray(seq),
                                       take, kept, 10, snap=snap,
                                       seq_host=rplan.seq)
        td, ti, nprobe, r_est, n_rounds, trace, stats = m.run_round_loop(
            rplan, 10, 0.99, idx._beta_table, m._batch_rho_fn(idx, q),
            scan_round, deadline_s=0.0025, clock=clock)
        out.append((np.asarray(ti), nprobe, n_rounds,
                    trace["budget_expired"], trace["timed_out_rows"],
                    stats))
    (ji, jn, jr, je, jt, jst), (pi, pn, pr, pe, pt, pst) = out
    assert je and pe and jt == pt > 0 and jr == pr
    assert np.array_equal(jn, pn) and jst == pst
    assert np.array_equal(pi, ji)


def test_host_and_device_backends_agree(jbase, ds):
    """As the reference requires of its own backends: the same ids."""
    p = port_of(jbase)
    q = jds.queries_near(ds, 16, seed=3).astype(np.float32)
    res = {}
    for backend in ("host", "device"):
        rt = ServingRuntime(p, ServingConfig(
            k=10, scan_backend=backend, maint_min_ops=10 ** 9))
        res[backend] = [rt.result(i) for i in _drained(rt, q)]
        rt.close()
    for rh, rd in zip(res["host"], res["device"]):
        assert set(rh.ids.tolist()) == set(rd.ids.tolist())


def _drained(rt, q):
    qids = rt.submit_batch(q)
    rt.drain()
    return qids


def test_auto_backend_is_host_off_cuda(jbase):
    rt = ServingRuntime(port_of(jbase), ServingConfig(k=5))
    assert rt.scheduler.scan_backend == "host"
    assert rt.executor.part_bucket == 1
    rt.close()


def test_metrics_off_byte_identical(jbase, ds):
    q = jds.queries_near(ds, 24, seed=32).astype(np.float32)
    out = []
    for metrics in (True, False):
        rt = ServingRuntime(port_of(jbase), ServingConfig(
            k=10, flush_size=8, scan_backend="device",
            maint_min_ops=10 ** 9, metrics=metrics))
        qa = rt.submit_batch(q[:14])
        rt.submit_insert(ds.vectors[:8] + 0.01, np.arange(91_000, 91_008))
        qb = rt.submit_batch(q[14:])
        rt.drain()
        out.append((rt.obs, [rt.result(i) for i in qa + qb]))
        rt.close()
    (obs_on, on), (obs_off, off) = out
    assert obs_on is not None and obs_off is None
    for a, b in zip(on, off):
        assert a.ids.tobytes() == b.ids.tobytes()
        assert a.dists.tobytes() == b.dists.tobytes()
        assert a.status == b.status and a.nprobe == b.nprobe


@pytest.mark.parametrize("backend", ["host", "device"])
def test_coalescing_determinism(jbase, ds, backend):
    """Same ops, any flush timing: the same ids and the same distances to
    f32 rounding, across a write barrier."""
    q1 = jds.queries_near(ds, 20, seed=1).astype(np.float32)
    q2 = jds.queries_near(ds, 11, seed=2).astype(np.float32)
    ins = ds.vectors[:20] + 0.01

    def run(flush_size, interleave):
        rt = ServingRuntime(port_of(jbase), ServingConfig(
            k=10, flush_size=flush_size, interleave_rounds=interleave,
            scan_backend=backend, maint_min_ops=10 ** 9))
        qa = rt.submit_batch(q1)
        rt.submit_insert(ins, np.arange(90_000, 90_020))
        qb = rt.submit_batch(q2)
        rt.drain()
        res = [rt.result(i) for i in qa + qb]
        rt.close()
        return res

    ref = run(64, 1)
    for flush_size, interleave in ((5, 0), (8, 3), (1, 1)):
        for a, b in zip(ref, run(flush_size, interleave)):
            assert np.array_equal(a.ids, b.ids)
            np.testing.assert_allclose(a.dists, b.dists, rtol=1e-4,
                                       atol=1e-3)
            assert a.nprobe == b.nprobe


def test_admission_log_replay_is_exact(jbase, ds):
    """A concurrent run's admission log, replayed single-threaded on a
    twin, reproduces every result (the replay the card's smoke uses to
    compare the two backends)."""
    q = jds.queries_near(ds, 40, seed=21).astype(np.float32)
    rt = ServingRuntime(port_of(jbase), ServingConfig(
        k=10, flush_size=6, scan_backend="device", record_admissions=True,
        maint_min_ops=10 ** 9))
    qvec = {}

    def client(rows):
        for row in rows:
            qvec[rt.submit_query(row)] = row

    threads = [threading.Thread(target=client, args=(q[i::3],))
               for i in range(3)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    rt.drain()
    log = rt.admission_log()
    rt2 = ServingRuntime(port_of(jbase), ServingConfig(
        k=10, flush_size=10 ** 9, scan_backend="device",
        maint_min_ops=10 ** 9))
    pairs = []
    for entry in log:
        assert entry[0] == "q"
        pairs += [(qid, rt2.submit_query(qvec[qid])) for qid in entry[1]]
        rt2.flush()
    rt2.drain()
    assert len(pairs) == len(q)
    for orig, rep in pairs:
        a, b = rt.result(orig), rt2.result(rep)
        assert a.ids.tobytes() == b.ids.tobytes()
        np.testing.assert_allclose(a.dists, b.dists, rtol=1e-4, atol=1e-3)
    rt.close()
    rt2.close()


def test_ticker_death_restarts_on_admission(jbase, ds):
    """A tick that raises kills the ticker; the very next admission
    restarts it — even while the dying thread is still unwinding, which
    the reference can miss (its ``_ensure_ticker`` sees the dying thread
    alive).  The dying thread is held inside its error handling here
    until the admission has run, so the restart is not left to timing."""
    fi = FaultInjector(seed=0, rates={"ticker": 1.0})
    cfg = ServingConfig(k=5, flush_size=10 ** 6, flush_deadline_ms=4.0,
                        ticker=True, maint_min_ops=10 ** 9)
    release, died = threading.Event(), threading.Event()
    real_warning = srv.logger.warning

    def held_warning(msg, *args):
        real_warning(msg, *args)
        if "ticker died" in msg and not died.is_set():
            died.set()
            release.wait(5.0)        # the dying thread is alive here

    srv.logger.warning = held_warning
    try:
        with ServingRuntime(port_of(jbase), cfg, faults=fi) as rt:
            assert died.wait(5.0)
            dying = rt._ticker_thread
            assert dying.is_alive() and rt.stats()["ticker_errors"] == 1
            rt.submit_query(jds.queries_near(ds, 1, seed=9)
                            .astype(np.float32)[0])
            assert rt.stats()["ticker_restarts"] == 1
            assert rt._ticker_thread is not dying
            release.set()
            rt.drain()
            st = rt.stats()
            assert sum(st["status_counts"].values()) == \
                st["queries_submitted"] == 1
    finally:
        release.set()
        srv.logger.warning = real_warning


def test_recover_serves_on_the_named_device(tmp_path, jbase, ds):
    p = port_of(jbase)
    cfg = ServingConfig(k=5, wal_dir=str(tmp_path), maint_min_ops=10 ** 9)
    rt = ServingRuntime(p, cfg)
    rt.submit_insert(ds.vectors[:6] + 0.03, np.arange(80_000, 80_006))
    rt.submit_delete(np.arange(0, 4))
    q = jds.queries_near(ds, 4, seed=8).astype(np.float32)
    live = [rt.result(i) for i in _drained(rt, q)]
    rt.close()
    rt2 = ServingRuntime.recover(str(tmp_path), ServingConfig(k=5),
                                 device="cpu")
    assert rt2.index.device.type == "cpu"
    rep = rt2.recovery_report
    assert (rep.inserts_replayed, rep.deletes_replayed) == (1, 1)
    got = [rt2.result(i) for i in _drained(rt2, q)]
    for a, b in zip(live, got):
        assert a.status == b.status == STATUS_OK
        assert np.array_equal(a.ids, b.ids)
    rt2.close()


def test_serving_config_validation_matches_reference():
    for kw in ({"flush_deadline": 0.0}, {"flush_deadline_ms": -1.0},
               {"queue_policy": "drop"}, {"fsync": "never"},
               {"trace_capacity": 0}):
        with pytest.raises(ValueError):
            ServingConfig(**kw)
        with pytest.raises(ValueError):
            JServingConfig(**kw)
    assert ServingConfig(flush_deadline=1.0,
                         flush_deadline_ms=5.0).flush_deadline == 0.005
    import dataclasses
    assert [f.name for f in dataclasses.fields(ServingConfig)] == \
        [f.name for f in dataclasses.fields(JServingConfig)]
    assert time.perf_counter() > 0


def test_serve_entry_point_on_the_cpu_and_without_cuda(tmp_path, capsys):
    """``launch/serve.main``: without ``--device cpu`` it raises where
    CUDA is absent; with it, it serves with a WAL and then recovers."""
    import torch
    from repro_torch.launch import serve
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            serve.main(["--n", "600", "--months", "1"])
    wal = str(tmp_path / "wal")
    serve.main(["--device", "cpu", "--n", "1500", "--dim", "8",
                "--months", "2", "--queries-per-month", "16",
                "--wal-dir", wal])
    out = capsys.readouterr().out
    assert "statuses={'OK': 32" in out
    serve.main(["--device", "cpu", "--recover", "--wal-dir", wal])
    out = capsys.readouterr().out
    assert "recovered" in out and "fingerprint:" in out


def test_replay_summary_times_maintenance_and_durability(tmp_path):
    """``replay_runtime`` returns the closed runtime and its index, the
    seconds of each maintenance pass, and the WAL-append and checkpoint
    seconds; the maintenance and checkpoints that ran inside query ops
    are a part of the query-op seconds."""
    from repro_torch.core import QuakeConfig
    from repro_torch.data.wikipedia import wikipedia_workload
    from repro_torch.faults import index_state_fingerprint
    from repro_torch.launch import serve
    wl = wikipedia_workload(n_total=1500, dim=8, months=2,
                            queries_per_month=16, seed=0)
    summary = serve.replay_runtime(
        wl, QuakeConfig(metric="ip", recall_target=0.9),
        ServingConfig(k=5, ticker=False, wal_dir=str(tmp_path)),
        verbose=False, device="cpu", gt_device="cpu")
    rt, index = summary["runtime"], summary["index"]
    assert rt.index is index and rt._closed
    maint = rt.maintenance.snapshot()
    assert len(maint["pass_s"]) == maint["runs"] == \
        summary["maintenance_runs"]
    assert all(s >= 0.0 for s in maint["pass_s"])
    dur = summary["stats"]["durability"]
    assert dur["wal_append_s"] > 0.0 and dur["attach_s"] > 0.0
    assert dur["checkpoint_s"] >= 0.0
    assert 0.0 <= summary["query_maintenance_s"] <= summary["query_s"]
    assert summary["query_maintenance_s"] <= \
        sum(maint["pass_s"]) + dur["checkpoint_s"] + 1e-9
    rec = ServingRuntime.recover(str(tmp_path), ServingConfig(
        k=5, ticker=False), device="cpu")
    assert index_state_fingerprint(rec.index) == \
        index_state_fingerprint(index)
    rec.close()

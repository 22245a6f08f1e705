"""The port's runtime support against the JAX package's: ``obs`` (equal
registry snapshots and Prometheus text, tracer spans, calibration),
``faults`` (the same draws for one seed) and ``sanitize`` (``LOCK_ORDER``
equal to quakecheck's, the lock watchdog, the build budget, the scoped
sync allowance and the NaN check).  Last, the lint rules that reach only
paths with a ``repro`` component (QK301 swallowed exceptions, QK401 wall
clock) are run on copies of the port's serving code placed under such a
path.
"""
import shutil
import threading
from pathlib import Path

import numpy as np
import pytest

from repro import faults as jfaults
from repro import obs as jobs
from repro import sanitize as jsanitize
from repro.core.cost_model import LatencyModel as JLatency
from repro_torch import faults, obs, sanitize
from repro_torch.core.cost_model import LatencyModel
from tools.quakecheck import config as qc
from tools.quakecheck.core import lint_paths

REPO = Path(__file__).resolve().parents[1]


def _feed(reg, rng):
    """One seeded stream of registry calls: counters, gauges, single and
    batched observations past the histogram's fold threshold."""
    for i in range(60):
        reg.inc("serving.flushes")
        reg.inc("scheduler.rounds", int(rng.integers(1, 4)))
        reg.set_gauge("calibration.recall.abs_err", float(rng.random()))
        reg.observe("serving.latency_s", float(rng.lognormal(-7, 1)))
        if i % 7 == 0:
            reg.update(
                counters={"scheduler.partitions_streamed": 3},
                gauges={"calibration.latency.rel_err": float(i)},
                observations={"serving.queue_wait_s":
                              rng.lognormal(-9, 2, 700).tolist()})


def test_registry_snapshot_and_prometheus_equal():
    regs = []
    for mod in (jobs, obs):
        reg = mod.MetricsRegistry()
        _feed(reg, np.random.default_rng(0))
        regs.append(reg)
    snap_j, snap_p = regs[0].snapshot(), regs[1].snapshot()
    assert snap_p == snap_j
    assert obs.to_prometheus(snap_p) == jobs.to_prometheus(snap_j)
    assert regs[1].histogram("serving.queue_wait_s") == \
        regs[0].histogram("serving.queue_wait_s")
    vals = np.random.default_rng(1).lognormal(0, 1, 999).tolist()
    assert obs.summarize(vals) == jobs.summarize(vals)
    assert obs.summarize([]) == jobs.summarize([])


def test_tracer_spans_equal():
    spans = []
    for mod in (jobs, obs):
        tr = mod.QueryTracer(capacity=6)
        tr.note_flushes([{"batch": 0, "t": 0.5, "n": 3},
                         {"batch": 1, "t": 0.9, "n": 5}])
        tr.note_rounds([{"t": 1.0, "round": 1, "partitions": 4,
                         "vectors": 90, "wall_s": 0.01,
                         "takers": [0, 1, 5]},
                        {"t": 1.2, "round": 2, "partitions": 2,
                         "vectors": 40, "wall_s": 0.004, "takers": [5]}])
        tr.close_many([(qid, 1.3, "OK", 1 + qid % 2, 4, 0.93, 0.8,
                        0.4 + 0.01 * qid, qid // 5) for qid in range(9)])
        tr.audit("maintenance", {"t": 1.4, "reason": "forced",
                                 "splits": 1, "merges": 0})
        spans.append((tr.spans(), tr.counters()))
    assert spans[1] == spans[0]


def test_calibration_tracker_equal():
    out = []
    for mod, lam in ((jobs, JLatency(dim=16)), (obs, LatencyModel(dim=16))):
        reg = mod.MetricsRegistry()
        cal = mod.CalibrationTracker(reg, lam=lam, window=4)
        rng = np.random.default_rng(2)
        for _ in range(9):
            cal.record_scan(rng.integers(10, 500, 6), float(rng.random()))
            cal.record_recall(float(rng.random()), float(rng.random()))
        out.append((reg.snapshot(), cal.latency_error(),
                    cal.recall_error()))
    assert out[1] == out[0]


def test_observability_bundle_shape():
    o = obs.Observability(lam=None, trace_capacity=8, calibration_window=3)
    assert isinstance(o.metrics, obs.MetricsRegistry)
    assert o.tracer.capacity == 8
    assert o.calibration.lam is None


# ---------------------------------------------------------------------------
# faults
# ---------------------------------------------------------------------------

def test_fault_draws_equal_for_one_seed():
    rates = {"scan": 0.3, "slow_round": 0.5, "maintenance": 0.2,
             "cache": 0.7, "wal_torn_write": 0.1, "fsync_dropped": 0.4}
    assert faults.FaultInjector.SITES == jfaults.FaultInjector.SITES
    for seed in (0, 7):
        a = faults.FaultInjector(seed=seed, rates=rates)
        b = jfaults.FaultInjector(seed=seed, rates=rates)
        rng = np.random.default_rng(seed)
        sites = rng.choice(list(faults.FaultInjector.SITES), 400)
        assert [a.fire(s) for s in sites] == [b.fire(s) for s in sites]
        assert a.counters() == b.counters()


def test_fault_check_and_stall():
    slept = []
    fi = faults.FaultInjector(seed=0, rates={"scan": 1.0,
                                             "slow_round": 1.0},
                              delay_s=0.25, sleep_fn=slept.append)
    with pytest.raises(faults.InjectedFault) as e:
        fi.check("scan")
    assert e.value.site == "scan" and e.value.n == 1
    assert fi.stall() == 0.25 and slept == [0.25]
    with pytest.raises(ValueError):
        faults.FaultInjector(rates={"no_such_site": 1.0})


# ---------------------------------------------------------------------------
# sanitize
# ---------------------------------------------------------------------------

def test_lock_order_matches_quakecheck_and_reference():
    assert sanitize.LOCK_ORDER == tuple(qc.LOCK_ORDER)
    assert sanitize.LOCK_ORDER == jsanitize.LOCK_ORDER


def test_watchdog_raises_on_inverted_order():
    outer = sanitize.TrackedLock("ServingRuntime._lock")
    inner = sanitize.TrackedLock("MetricsRegistry._lock")
    with sanitize.LockOrderWatchdog() as wd:
        with outer:
            with inner:
                pass
        assert wd.events.order_violations == 0
        assert wd.events.acquisitions == 2
        with inner:
            with pytest.raises(RuntimeError, match="inverts LOCK_ORDER"):
                outer.acquire()
    assert [n for _, n in wd.trace()][:2] == ["ServingRuntime._lock",
                                              "MetricsRegistry._lock"]


def test_eraser_flags_unguarded_field():
    class Box:
        pass

    box = Box()
    lk = sanitize.TrackedLock("ResultCache._lock")
    errors = []

    def touch():
        try:
            sanitize.note_guarded(box, "store")
        except RuntimeError as e:
            errors.append(e)

    with sanitize.LockOrderWatchdog() as wd:
        with lk:
            sanitize.note_guarded(box, "store")
        t = threading.Thread(target=touch)
        t.start()
        t.join()
        assert wd.events.guarded_violations == 1
    assert errors and "no common lock" in str(errors[0])


def test_build_budget_and_counter():
    budgets = sanitize.load_compile_budget()
    assert budgets["scan_probe_round.steady"] == 0
    assert sanitize.BUDGET_PATH.parent == \
        REPO / "src" / "repro_torch"
    sanitize.assert_compile_budget("scan_probe_round.steady", 0)
    with pytest.raises(AssertionError):
        sanitize.assert_compile_budget("scan_probe_round.steady", 1)
    with pytest.raises(AssertionError, match="no build budget"):
        sanitize.assert_compile_budget("no.such.entry_point", 0)
    with sanitize.compile_events() as ev:
        np.zeros(3).sum()
        assert ev.new() == 0          # nothing builds on the CPU
    assert sanitize.warm_until_stable(lambda: None) == 1
    flat = sanitize.observability_counters()
    assert {"compile_count", "acquisitions", "order_violations"} <= set(flat)


def test_nan_check_and_sync_allowance():
    sanitize.check_finite("x", np.array([np.nan]))     # not armed: silent
    with sanitize.sanitized(locks=True) as ev:
        sanitize.check_finite("x", np.array([1.0, np.inf]))
        with pytest.raises(FloatingPointError, match="NaN in dists"):
            sanitize.check_finite("dists", np.array([0.0, np.nan]))
        with sanitize.allow_sync("explicit pull"):
            pass
        assert ev.new() == 0
    with pytest.raises(ValueError):
        with sanitize.allow_sync(" "):
            pass


def test_serving_round_raises_on_nan_under_sanitizer():
    """A NaN in what a round pulls back fails loudly under the NaN check
    (the round scan is then a scan fault, and its queries end FAILED),
    and passes silently without it."""
    from repro_torch.core import QuakeIndex, ServingConfig, ServingRuntime
    from repro_torch.core import multiquery as mq
    from repro_torch.data import datasets
    ds = datasets.clustered(600, 8, n_clusters=6, seed=0)
    idx = QuakeIndex.build(ds.vectors, num_partitions=8, kmeans_iters=2,
                           device="cpu")
    q = datasets.queries_near(ds, 3, seed=1)
    real = mq.BatchedSearchExecutor.scan_probe_round

    def poisoned(self, *a, **kw):
        d, flat, st = real(self, *a, **kw)
        d = d.clone()
        d[0, 0] = float("nan")
        return d, flat, st

    mq.BatchedSearchExecutor.scan_probe_round = poisoned
    try:
        for armed in (False, True):
            rt = ServingRuntime(idx, ServingConfig(
                k=3, scan_backend="device", scan_retries=0,
                maint_min_ops=10 ** 9, metrics=False))
            if armed:
                with sanitize.sanitized():
                    qids = rt.submit_batch(q)
                    rt.drain()
            else:
                qids = rt.submit_batch(q)
                rt.drain()
            st = rt.stats()
            assert st["scan_faults"] == (1 if armed else 0)
            assert {rt.result(i).status for i in qids} == \
                ({"FAILED"} if armed else {"OK"})
            rt.close()
    finally:
        mq.BatchedSearchExecutor.scan_probe_round = real


# ---------------------------------------------------------------------------
# the rules that reach only ``repro`` paths, on the port's serving code
# ---------------------------------------------------------------------------

def _copy_under_repro_core(tmp_path):
    core = tmp_path / "repro" / "core"
    core.mkdir(parents=True)
    src = REPO / "src" / "repro_torch"
    for name in ("serving.py", "durability.py"):
        shutil.copy(src / "core" / name, core / name)
    shutil.copytree(src / "obs", core / "obs")
    return core


def test_port_serving_code_lints_clean_under_repro_rules(tmp_path):
    core = _copy_under_repro_core(tmp_path)
    findings = lint_paths([str(tmp_path)])
    assert findings == [], "\n".join(f.render() for f in findings)
    # the copies are in the rules' scope: a wall-clock read and a
    # swallowed exception in them are found
    srv = core / "serving.py"
    srv.write_text(srv.read_text() + (
        "\n\ndef _probe():\n"
        "    try:\n"
        "        return time.time()\n"
        "    except Exception:\n"
        "        pass\n"))
    rules = {f.rule for f in lint_paths([str(tmp_path)])}
    assert {"QK301", "QK401"} <= rules

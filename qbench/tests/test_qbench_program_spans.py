"""The readers of the program's own spans and counters
(``repro_torch.obs.tracing``): reported by a traced CPU rehearsal of each
cell, absent from an untraced one, and absent without an error where the
program has no spans."""
import copy

import numpy as np
import pytest

from qbench import harness, spec
from repro_torch.obs import registry, tracing

TINY = {"config": {"rows": 3000, "dim": 16, "k": 10,
                   "index": {"num_partitions": 30},
                   "data": {"clusters": 32, "query_jitter": 0.1}},
        "traffic": {"batch": 32, "pool_batches": 3, "warm_batches": 1}}
SEED = 2**31 + 77
APS, NPROBE = "sift1m-l2.aps-b1024", "sift1m-l2.nprobe32-b1024"
SPAN_METRICS = {APS: {"plan_ms.qps", "round_host_ms.qps", "host_waits.qps"},
                NPROBE: {"plan_ms.qps", "host_waits.qps"}}


def _run(name, trace):
    cell = spec.load_cell(name, overrides=copy.deepcopy(TINY))
    return harness.run_cell(cell, SEED, 0.4, trace, device="cpu")


@pytest.fixture()
def fresh_totals(monkeypatch):
    """Program totals of this test's runs alone (they are process-wide)."""
    monkeypatch.setattr(tracing, "_PROGRAM", registry.MetricsRegistry())


@pytest.mark.parametrize("name", [APS, NPROBE])
def test_cells_name_the_span_metrics(name):
    names = {m["name"] for m in spec.load_cell(name).per_layer}
    assert SPAN_METRICS[name] <= names
    assert "round_host_ms.qps" not in names or name == APS


@pytest.mark.parametrize("name", [APS, NPROBE])
def test_traced_run_reads_the_spans(name, fresh_totals):
    m = _run(name, trace=True)["metrics"]
    assert SPAN_METRICS[name] <= set(m)
    for key in SPAN_METRICS[name]:
        assert np.isfinite(m[key]["value"]) and m[key]["value"] > 0
    waits = m["host_waits.qps"]["value"]
    if name == APS:
        # a take-mask upload and a k-th pull a round; the queries' and
        # the sequences' uploads; two result pulls
        rounds = m["rounds_per_batch.qps"]["value"]
        assert waits == pytest.approx(2 * rounds + 4)
    else:
        assert waits == 8
    totals = tracing.program_totals()
    batches = totals["quake.search_batch.count"]
    assert m["plan_ms.qps"]["value"] * batches * 1e6 \
        <= totals["quake.search_batch.ns"]


@pytest.mark.parametrize("name", [APS, NPROBE])
def test_untraced_run_reads_no_spans(name, fresh_totals):
    m = _run(name, trace=False)["metrics"]
    assert not SPAN_METRICS[name] & set(m)
    assert tracing.program_totals() == {}


def test_a_program_without_spans_reports_none(monkeypatch):
    """The parent of this benchmark's span metrics has no
    ``program_totals``: the readers leave the metrics out."""
    monkeypatch.delattr(tracing, "program_totals")
    r = _run(APS, trace=True)
    assert r["correct"] is True
    assert not SPAN_METRICS[APS] & set(r["metrics"])
    assert "rounds_per_batch.qps" in r["metrics"]

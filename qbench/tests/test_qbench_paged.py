"""The wide cell, ``dbpedia3072-1m-l2.nprobe32-b1024-p512``, and the readers
of the paged snapshot's counters: ``snapshot_fill.qps``
(``quake.snapshot.live_rows`` over ``.slots``) and ``union_pages.qps``
(``quake.plan.union_pages`` over ``quake.search_batch.count``), from a
synthetic context and from traced CPU rehearsals of every cell."""
import copy

import numpy as np
import pytest

from qbench import harness, spec
from repro_torch.obs import tracing
from test_qbench_program_spans import (  # noqa: F401
    APS, NPROBE, SEED, TINY, fresh_totals)

WIDE = "dbpedia3072-1m-l2.nprobe32-b1024-p512"
PAGED = ("snapshot_fill.qps", "union_pages.qps")


def test_wide_cell_states_the_published_shape():
    cell = spec.load_cell(WIDE)
    cfg = cell.config
    assert (cfg["rows"], cfg["dim"], cfg["dtype"], cfg["k"]) == \
        (1_000_000, 3072, "float32", 100)
    assert cfg["index"] == {"num_partitions": 1000, "recall_target": 0.9,
                            "storage_dtype": "f32"}
    assert cfg["reduced"] == {} and cfg["metric"] == "l2"
    sift = spec.load_cell(NPROBE).config
    assert cfg["data"] == sift["data"]
    assert cell.traffic["search"] == {"nprobe": 32, "rounds": 1}
    assert (cell.traffic["batch"], cell.traffic["pool_batches"],
            cell.traffic["judge_batches"]) == (1024, 512, 64)
    names = {m["name"] for m in cell.per_layer}
    assert set(PAGED) | {"scan_indexed_roofline.qps", "idle_share.qps",
                         "vectors_per_query.qps", "plan_ms.qps",
                         "host_waits.qps"} <= names
    assert {m["name"] for m in cell.end_to_end} == \
        {"qps", "recall_at_k", "setup_s"}


@pytest.mark.parametrize("name", [APS, NPROBE, WIDE])
def test_every_cell_names_the_paged_metrics(name):
    names = {m["name"] for m in spec.load_cell(name).per_layer}
    assert set(PAGED) <= names


def _ctx(totals, monkeypatch, trace=True):
    monkeypatch.setattr(tracing, "program_totals", lambda: dict(totals))
    return harness.Ctx(k=10, peaks={}, trace={"busy_s": 1.0,
                                              "window_s": 2.0}
                       if trace else None)


def test_readers_read_their_counters(monkeypatch):
    ctx = _ctx({"quake.snapshot.slots": 8192, "quake.snapshot.live_rows":
                5120, "quake.plan.union_pages": 900,
                "quake.search_batch.count": 3}, monkeypatch)
    assert spec.metric_reader("snapshot_fill.qps").read(ctx) == 62.5
    assert spec.metric_reader("union_pages.qps").read(ctx) == 300.0


@pytest.mark.parametrize("totals", [{}, {"quake.search_batch.count": 4}])
def test_readers_without_counters_report_none(totals, monkeypatch):
    """The parent program counts batches but not pages: no reading."""
    ctx = _ctx(totals, monkeypatch)
    for name in PAGED:
        assert spec.metric_reader(name).read(ctx) is None
    untraced = _ctx({"quake.snapshot.slots": 1}, monkeypatch, trace=False)
    for name in PAGED:
        assert spec.metric_reader(name).read(untraced) is None


def _tiny(dim):
    over = copy.deepcopy(TINY)
    over["config"]["dim"] = dim
    return over


@pytest.mark.parametrize("name,dim", [(APS, 16), (NPROBE, 16), (WIDE, 48)])
def test_traced_rehearsal_reports_the_paged_metrics(name, dim,
                                                    fresh_totals):
    cell = spec.load_cell(name, overrides=_tiny(dim))
    r = harness.run_cell(cell, SEED, 0.4, True, device="cpu")
    assert r["correct"] is True
    m = r["metrics"]
    assert set(PAGED) <= set(m)
    assert 0 < m["snapshot_fill.qps"]["value"] <= 100
    # each batch scans at least one page a union partition
    assert m["union_pages.qps"]["value"] >= 1
    assert np.isfinite(m["host_waits.qps"]["value"])


def test_wide_cell_rehearsal_reports_its_end_to_end_metrics(fresh_totals):
    cell = spec.load_cell(WIDE, overrides=_tiny(48))
    r = harness.run_cell(cell, SEED, 0.4, False, device="cpu")
    assert r["correct"] is True
    assert {"qps", "recall_at_k", "setup_s"} <= set(r["metrics"])
    assert r["metrics"]["recall_at_k"]["value"] > 0.5
    assert not set(PAGED) & set(r["metrics"])

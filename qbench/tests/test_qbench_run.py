"""Whole runs rehearsed on the CPU at a tiny size: the result line's
schema, ``correct`` false under faults planted in the timed path, the
TF32 control, and no ``jax`` or ``repro`` module loaded."""
import copy
import json
import os
import subprocess
import sys

import pytest

from qbench import harness, spec

TINY = {"config": {"rows": 3000, "dim": 16, "k": 10,
                   "index": {"num_partitions": 30},
                   "data": {"clusters": 32, "query_jitter": 0.1}},
        "traffic": {"batch": 32, "pool_batches": 3, "warm_batches": 1}}
SEED = 2**31 + 99


def _cell(name, **traffic):
    over = copy.deepcopy(TINY)
    over["traffic"].update(traffic)
    return spec.load_cell(name, overrides=over)


def _run(name, trace=False, control=False, seconds=0.4, **traffic):
    return harness.run_cell(_cell(name, **traffic), SEED, seconds, trace,
                            device="cpu", control=control)


CELLS = ["sift1m-l2.aps-b1024", "sift1m-l2.nprobe32-b1024"]


@pytest.mark.parametrize("name", CELLS)
def test_result_line_schema(name):
    r = _run(name)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "checks"
    assert r["correct"] is True and r["failed"] == 0 and r["attempted"] > 0
    cell = _cell(name)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in r["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0
    assert set(r["device"]) == {"platform", "kind", "count",
                                "memory_peak_bytes"}
    for c in r["checks"].values():
        assert c["value"] <= c["limit"]
    json.dumps(r)


@pytest.mark.parametrize("name", CELLS)
def test_traced_line_has_layers_and_breakdown(name):
    host_read = {"rounds_per_batch.qps", "vectors_per_query.qps"}
    r = _run(name, trace=True)
    assert {"busy_s", "window_s"} <= set(r["device"])
    assert set(r["breakdown"]) == {"device_ops", "idle_gaps"}
    names = {m["name"] for m in _cell(name).per_layer}
    assert host_read <= set(r["metrics"]) <= names


def test_control_is_not_correct():
    r = _run("sift1m-l2.aps-b1024", control=True)
    assert r["correct"] is False
    assert r["checks"]["dist_gap"]["value"] > r["checks"]["dist_gap"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_half_the_batch_left_out_is_caught(monkeypatch, name):
    from repro_torch.core import index as ix
    real = ix.QuakeIndex.search_batch

    def half(self, q, k, **kw):
        return real(self, q[: len(q) // 2], k, **kw)
    monkeypatch.setattr(ix.QuakeIndex, "search_batch", half)
    r = _run(name)
    assert r["correct"] is False and r["checks"]["unanswered"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_answer_altered_where_produced_is_caught(monkeypatch, name):
    from repro_torch.core import index as ix
    real = ix.QuakeIndex.search_batch

    def altered(self, q, k, **kw):
        res = real(self, q, k, **kw)
        res.ids[0, 0] = (res.ids[0, 0] + 1) % 3000
        return res
    monkeypatch.setattr(ix.QuakeIndex, "search_batch", altered)
    r = _run(name)
    assert r["correct"] is False


class _Clock:
    """A host clock that moves 0.05 s a reading, so that a 0.4 s window
    sends the same number of batches under any load."""

    def __init__(self):
        self.t = 0.0

    def perf_counter(self):
        self.t += 0.05
        return self.t


@pytest.mark.parametrize("pool", [2, 400])
def test_every_batch_sent_is_judged(monkeypatch, pool):
    """A window that wraps a small pool, and one that sends only a prefix
    of a large one, are judged over exactly the batches sent."""
    monkeypatch.setattr(harness, "time", _Clock())
    r = _run("sift1m-l2.aps-b1024", pool_batches=pool, judge_batches=10**6)
    assert r["correct"] is True
    assert r["attempted"] == 32 * r["notes"]["batches"]
    assert r["notes"]["judged_batches"] == r["notes"]["batches"]
    if pool == 2:
        assert r["notes"]["batches"] > 2
    else:
        assert r["notes"]["batches"] < 400


def test_a_sample_drawn_from_the_seed_is_judged():
    cell = _cell("sift1m-l2.nprobe32-b1024", judge_batches=3)
    drv = harness.BatchLoop(cell, SEED, None)
    drv.answers = [None] * 40
    a = drv.judged()
    assert len(a) == 3 and len(set(a)) == 3 and a.max() < 40
    assert list(a) == list(drv.judged())
    drv.seed = SEED + 1
    assert list(a) != list(drv.judged())


def test_a_short_batch_outside_the_sample_is_unanswered(monkeypatch):
    """Rows left out of any batch sent count, judged or not."""
    from repro_torch.core import index as ix
    real = ix.QuakeIndex.search_batch
    calls = []

    def short_once(self, q, k, **kw):
        calls.append(1)
        res = real(self, q, k, **kw)
        if len(calls) == 4:            # the window's third batch
            res.ids[-1] = -1
        return res
    monkeypatch.setattr(ix.QuakeIndex, "search_batch", short_once)
    monkeypatch.setattr(harness, "time", _Clock())
    r = _run("sift1m-l2.nprobe32-b1024", judge_batches=1)
    assert r["notes"]["judged_batches"] == 1
    assert r["correct"] is False
    assert r["checks"]["unanswered"]["value"] >= 1


def test_rehearsal_loads_neither_jax_nor_repro():
    """A whole run in a fresh process: no module whose top-level name is
    jax, jaxlib, flax or repro is loaded (repro_torch is not repro)."""
    root = spec.ROOT
    code = (
        "import sys, json\n"
        f"sys.path[:0] = [{str(root)!r}, {str(root / 'src')!r}]\n"
        "from qbench import harness, spec\n"
        "from qbench.run import forbidden_modules\n"
        f"cell = spec.load_cell('sift1m-l2.aps-b1024', overrides={TINY!r})\n"
        f"r = harness.run_cell(cell, {SEED}, 0.3, True, device='cpu')\n"
        "print(json.dumps([r['correct'], forbidden_modules(),\n"
        "    sorted(m for m in sys.modules if m.split('.')[0] == 'repro_torch')[:1]]))\n")
    env = dict(os.environ, PYTHONPATH="")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300, cwd=root)
    assert out.returncode == 0, out.stderr[-2000:]
    correct, bad, port = json.loads(out.stdout.strip().splitlines()[-1])
    assert correct is True and bad == [] and port == ["repro_torch"]


def test_entry_point_needs_a_card():
    """Without a CUDA device the entry point exits 2 and prints nothing
    on standard output (skipped where a CUDA device is present)."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, str(spec.QBENCH / "run.py"), "--workload",
         "sift1m-l2.aps-b1024", "--seed", "1", "--seconds", "1",
         "--trace", "0"], capture_output=True, text=True, timeout=300,
        cwd=spec.ROOT)
    assert out.returncode == 2 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_forbidden_modules_compares_whole_top_level_names():
    from qbench import run
    assert run.forbidden_modules(["repro_torch.core", "numpy",
                                  "jaxtyping", "reprolib"]) == []
    assert run.forbidden_modules(["repro.core.index", "jax.numpy", "flax",
                                  "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                 "repro"]

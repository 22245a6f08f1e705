"""The harness finds every configuration, mix, metric reader and roofline
count by name, and BENCHMARK.json keeps the contract's shape."""
import json
import re

import pytest

from qbench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
PER_LAYER = [m["name"] for m in BENCH["per_layer"]]
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(cell):
    c = spec.load_cell(cell)
    assert c.config["name"] == c.config_name
    assert c.traffic["loop"] == "batch"
    e2e = {m["name"] for m in c.end_to_end}
    assert "setup_s" in e2e and len(e2e) >= 2
    assert c.per_layer, "every cell reports a per-layer metric"
    for m in c.per_layer:
        assert m["moves"] in e2e
    assert set(c.limits) >= {"dist_gap", "bad_ids", "unanswered"}


READERS = sorted(p.name[:-3] for p in (spec.QBENCH / "metrics").glob("*.py"))


@pytest.mark.parametrize("metric", PER_LAYER)
def test_metric_reader_found(metric):
    assert metric in READERS
    assert callable(spec.metric_reader(metric).read)


@pytest.mark.parametrize("metric", READERS)
def test_every_reader_reads_nothing_from_nothing(metric):
    from qbench.harness import Ctx
    assert spec.metric_reader(metric).read(Ctx(k=10, peaks={})) is None


ROOFLINES = spec.roofline_kernels(BENCH["per_layer"])


@pytest.mark.parametrize("kernel", ROOFLINES)
def test_roofline_module_found(kernel):
    mod = spec.roofline_module(kernel)
    for attr in ("TARGET", "KERNELS", "matches", "record", "work"):
        assert hasattr(mod, attr), attr
    assert all(mod.matches(k) for k in mod.KERNELS)


def test_cells_name_their_roofline_kernels():
    """A cell records the kernels whose ``<kernel>_roofline`` share it
    reports, and only those."""
    assert ROOFLINES == ["scan_indexed"]
    assert spec.roofline_kernels([{"name": "idle_share.qps"}]) == []
    assert spec.roofline_kernels([{"name": "a_roofline.x"},
                                  {"name": "b_roofline"},
                                  {"name": "a_roofline.y"}]) == ["a", "b"]
    for cell in CELLS:
        assert spec.roofline_kernels(spec.load_cell(cell).per_layer) \
            == ROOFLINES


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        spec.load_cell("no-such.cell")


def test_benchmark_json_shape():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert len(json.dumps(BENCH)) < 64 * 1024
    assert 1 <= BENCH["run_seconds"] <= 51
    for p in BENCH["paths"]:
        assert (spec.ROOT / p).is_dir() and not p.startswith("/")
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for entry in BENCH["configs"] + BENCH["workloads"]:
        assert NAME.match(entry["name"])
        assert 1 <= len(entry["why"]) <= 200
    for c in BENCH["configs"]:
        assert (spec.ROOT / c["file"]).is_file()
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert (spec.QBENCH / "traffic" / f"{w['traffic']}.json").is_file()
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(CELLS) // 4)
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    assert {m["name"]: m for m in BENCH["end_to_end"]}["setup_s"]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    for m in BENCH["per_layer"]:
        assert m["layer"] and "\n" not in m["layer"]


def test_every_config_is_used():
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}

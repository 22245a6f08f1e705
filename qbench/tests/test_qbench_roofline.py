"""The roofline counts against shapes worked out by hand, the yardstick's
arithmetic, and the trace reduction on a trace written by hand."""
import pytest
import torch

from qbench import devtrace, spec, yardstick

SCAN = spec.roofline_module("scan_indexed")
PEAKS = yardstick.DEFAULT_PEAKS


def test_scan_indexed_counts_what_the_inputs_need():
    # 3 partitions of 4 slots; live rows 3, 4, 1; d = 8, f32
    valid = torch.zeros(3, 4, dtype=torch.bool)
    valid[0, :3] = True
    valid[1, :] = True
    valid[2, 0] = True
    data = torch.zeros(3, 4, 8)
    sel = torch.tensor([2, 0, 2], dtype=torch.int32)   # tail repeats sel[0]
    qmask = torch.tensor([[1, 1, 0], [0, 1, 0]], dtype=torch.bool)
    rec = SCAN.record(torch.zeros(2, 8), data, valid, sel, qmask, k_pad=16)
    # union rows read once: partition 2 (1 row) + partition 0 (3 rows)
    assert int(rec["rows"]) == 4
    # pairs: query 0 -> 1 + 3 rows, query 1 -> 3 rows
    assert int(rec["active"]) == 7
    flops, nbytes = SCAN.work(rec, k=10)
    assert flops == 2 * 8 * 7
    assert nbytes == 4 * 8 * 4 + 2 * 8 * 4 + 2 * 10 * 8


def test_kernel_names_match():
    assert SCAN.matches("void quake::grouped_scan_kernel<quake::FloatTiles"
                        "<float> >(quake::GroupedArgs)")
    assert SCAN.matches("quake::merge_lists_kernel(float const*, int)")
    assert not SCAN.matches("void quake::grouped_scan_kernel<quake::Q8Tiles>")
    assert not SCAN.matches("void at::native::reduce_kernel<512, 1>")
    assert not SCAN.matches("quake::kmeans_assign_kernel(float const*)")


def test_roofline_share():
    # 3.35e9 bytes bound 1 ms; 67e9 flops bound 1 ms; 2 ms of device time
    share = yardstick.roofline_share([(0.0, 3.35e9), (67e9, 0.0)], 4e-3,
                                     PEAKS)
    assert share == pytest.approx(50.0)
    assert yardstick.roofline_share([], 1.0, PEAKS) is None
    assert yardstick.roofline_share([(1.0, 1.0)], 0.0, PEAKS) is None


def _ev(name, cat, ts, dur):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}


def test_trace_reduction_by_hand():
    events = [
        _ev(devtrace.WINDOW, "user_annotation", 0, 1000),
        _ev("qbench.search_batch", "user_annotation", 0, 900),
        _ev("qbench.plan_rounds", "user_annotation", 100, 300),
        _ev("kern_a", "kernel", 50, 50),          # busy 50-100
        _ev("kern_a", "kernel", 450, 100),        # busy 450-550
        _ev("Memcpy DtoH", "gpu_memcpy", 500, 100),   # overlaps: to 600
        _ev("kern_b", "kernel", 990, 50),         # clipped at 1000
    ]
    t = devtrace.reduce_events(events)
    assert t["window_s"] == pytest.approx(1e-3)
    assert t["busy_s"] == pytest.approx((50 + 150 + 10) * 1e-6)
    assert t["by_name"]["kern_a"] == pytest.approx(150e-6)
    assert t["by_name"]["kern_b"] == pytest.approx(10e-6)
    # gaps: 0-50 (search_batch), 100-450 (mid 275: plan_rounds),
    # 600-990 (mid 795: search_batch)
    assert t["idle"]["qbench.plan_rounds"] == pytest.approx(350e-6)
    assert t["idle"]["qbench.search_batch"] == pytest.approx(440e-6)
    assert devtrace.top({"a": 1.0, "b": 3.0}, 1) == [["b", 3.0]]


def test_trace_without_window_reads_nothing():
    assert devtrace.reduce_events([_ev("k", "kernel", 0, 1)]) is None

"""The indexed scan's choice of design, on the CPU.

The card runs two designs of the f32/bf16 indexed scan
(``csrc/scan_topk_indexed.cu``): the row-per-thread design in tiles of
``QT`` queries, and the register-tiled design in tiles of ``QW``.  One
function, ``design``, picks the tiled design for a call from what the
host sees (f32 rows of ``TILED_MIN_D`` and wider, a multiple of 4 and
16-byte aligned, ``TILED_MIN_B`` queries or more), and the library lays
out the design it is given.  On ``meta`` tensors (inside
``build.card_route_on_meta``) the wrapper makes the card call's
allocations from ``meta_placement``, the mirror of the library's
layout, so these tests hold the choice, the workspace and top-K scratch
that follow each design's tile width, the grouping step at the tiled
width, and the ``quake.scan.tiled`` counter, without a card.  The card
tests (``tests/test_torch_cuda.py``) hold the library against the
mirror.
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build
from repro_torch.kernels import scan_topk_indexed as sti
from repro_torch.obs import tracing


def _width(width):
    return {"min-4": sti.TILED_MIN_D - 4, "min": sti.TILED_MIN_D,
            "min+2": sti.TILED_MIN_D + 2}.get(width, width)


@pytest.mark.parametrize("b", [1, "minb-1", "minb", 1024])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("width", [128, "min-4", "min", "min+2", 3070,
                                   3072, 8192])
def test_design_takes_the_tiled_design_for_wide_f32_calls(width, dtype, b):
    """The tiled design scans f32 rows of ``TILED_MIN_D`` and wider whose
    width is a multiple of 4, in calls of ``TILED_MIN_B`` queries or
    more; narrower or odd-width rows, smaller calls and bf16 rows keep
    the row-per-thread design."""
    d = _width(width)
    b = {"minb-1": sti.TILED_MIN_B - 1, "minb": sti.TILED_MIN_B}.get(b, b)
    q = torch.zeros((b, d), dtype=dtype)
    data = torch.zeros((3, 4, d), dtype=dtype)
    want = (dtype == torch.float32 and d >= sti.TILED_MIN_D and d % 4 == 0
            and b >= sti.TILED_MIN_B)
    assert sti.design(q, data) == (sti.TILED if want else 0)
    assert sti.design(q.to("meta"), data.to("meta")) == (
        sti.TILED if want else 0)


@pytest.mark.parametrize("which", ["queries", "rows"])
def test_design_keeps_unaligned_operands_on_the_row_design(which):
    """The tiled design copies 16 bytes at a time: a call whose queries or
    rows start off a 16-byte boundary (a view 4 bytes in) takes the
    row-per-thread design, which copies what it cannot align unit by
    unit."""
    d, b = 3072, 64
    q = torch.zeros((b, d))
    data = torch.zeros((3, 4, d))
    assert sti.design(q, data) == sti.TILED
    if which == "queries":
        q = torch.zeros(b * d + 1)[1:].view(b, d)
    else:
        data = torch.zeros(3 * 4 * d + 1)[1:].view(3, 4, d)
    assert q.is_contiguous() and data.is_contiguous()
    assert sti.design(q, data) == 0


@pytest.mark.parametrize("k_pad", [16, 128, 256, 1024])
@pytest.mark.parametrize("kind", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("width", [128, "min-4", "min", 3070, 3072, 8192])
def test_meta_placement_takes_the_tiled_design_from_the_crossover(
        width, kind, k_pad):
    """For a call of 64 queries: f32 rows of ``TILED_MIN_D`` and wider
    (a multiple of 4) take the tiled design, its 64 queries' top-K
    buffers in shared memory up to k_pad 128 (128 KB); narrower or
    odd-width rows, bf16 rows and int8 codes (which never ask
    ``design``) keep the row-per-thread design, its 16 queries' buffers
    in shared memory up to k_pad 256."""
    d = _width(width)
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    tiled = 0 if kind == "q8" else sti.design(
        torch.zeros((64, d), dtype=dtype), torch.zeros((1, 1, d),
                                                       dtype=dtype))
    got = sti.meta_placement(k_pad, tiled)
    if kind == "f32" and d >= sti.TILED_MIN_D and d % 4 == 0:
        assert got == sti.TILED | (sti.GLOBAL_BUFS if k_pad > 128 else 0)
        assert sti.tile_width(got) == sti.QW
    else:
        assert got == (sti.GLOBAL_BUFS if k_pad > 256 else 0)
        assert sti.tile_width(got) == sti.QT


@pytest.mark.parametrize("k_pad", [128, 1024])
@pytest.mark.parametrize("d,kind", [(128, "f32"), (3072, "f32"),
                                    (3072, "bf16"), (3072, "q8")])
@pytest.mark.parametrize("b,u,uc", [(1, 7, 7), (1024, 985, 985),
                                    (130, 40, 16)])
def test_scratch_follows_the_tile_width(b, u, uc, d, kind, k_pad):
    """The workspace holds ``work_u`` for ceil(B / qt) tiles a slot and
    the global top-K scratch qt buffers a block, qt the chosen design's
    tile width (``GroupedWs`` and the kernels' ``gbuf`` layout)."""
    meta = torch.device("meta")
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    tiled = 0 if kind == "q8" else sti.design(
        torch.zeros((b, d), dtype=dtype, device=meta),
        torch.zeros((1, 1, d), dtype=dtype, device=meta))
    ws, gbuf, blocks, where = sti._grouped_scratch(
        kind, d, b, u, uc, k_pad, meta, tiled)
    qt = sti.QW if (kind == "f32" and d >= sti.TILED_MIN_D
                    and b >= sti.TILED_MIN_B) else sti.QT
    assert sti.tile_width(where) == qt
    nch = -(-u // uc)
    assert ws.numel() == u * b + 3 * u + nch + 1 + u * -(-b // qt) + nch
    if gbuf is None:
        assert not where & sti.GLOBAL_BUFS
        return
    per_block = qt * sti.buffer_size(k_pad) * 8
    assert blocks == sti.TOPK_SCRATCH_BYTES // per_block
    assert gbuf.numel() * 4 == blocks * per_block


@pytest.mark.parametrize("uc", [None, 4])
@pytest.mark.parametrize("b,u", [(1, 5), (100, 12), (300, 9)])
def test_group_queries_plain_in_tiles_of_the_tiled_width(b, u, uc):
    """The grouping step at the tiled design's width: each slot's
    queries in tiles of ``QW`` (63, 64, 65, 127, 128 and 129 probes a
    slot, or all of b), each probe in exactly one tile, the tiles listed
    slot by slot in the kernels' order."""
    qt = sti.QW
    rng = np.random.default_rng(b + u)
    qmask = rng.random((b, u)) < 0.3
    qmask[:, 0] = False
    qmask[:, 1] = True
    for col, n in zip(range(2, u), (qt - 1, qt, qt + 1, 2 * qt - 1,
                                    2 * qt, 2 * qt + 1)):
        qmask[:, col] = False
        qmask[rng.permutation(b)[:n], col] = True
    sel = torch.as_tensor(rng.permutation(u).astype(np.int32))
    nrows = torch.as_tensor(rng.integers(0, 50, size=u).astype(np.int32))
    step = u if uc is None else uc
    order = sti.slot_order(sel, nrows, step)
    g = sti.group_queries_plain(torch.as_tensor(qmask), order, uc, qt)
    counts = qmask.sum(axis=0)
    ntiles = -(-counts // qt)
    np.testing.assert_array_equal(g["ntiles"].numpy(), ntiles)
    o = order.numpy()
    np.testing.assert_array_equal(g["work_u"].numpy(),
                                  np.repeat(o, ntiles[o]))
    seen = np.zeros((b, u), dtype=int)
    off = g["tile_off"].numpy()
    for t, col in enumerate(g["work_u"].numpy()):
        q0 = (t - off[col]) * qt
        assert q0 < counts[col]
        for bb in g["qlist"][col].numpy()[q0:min(q0 + qt, counts[col])]:
            seen[bb, col] += 1
    np.testing.assert_array_equal(seen, qmask.astype(int))
    # the same mask in tiles of QT: the same lists, more tiles
    g16 = sti.group_queries_plain(torch.as_tensor(qmask), order, uc)
    assert torch.equal(g16["qlist"], g["qlist"])
    assert int(g16["chunk_off"][-1]) >= int(g["chunk_off"][-1])


def _meta_scan(d, dtype, b=48, u=6, k_pad=128):
    g = torch.Generator().manual_seed(d)
    data = torch.randn(10, 64, d, generator=g).to(dtype).to("meta")
    q = torch.randn(b, d, generator=g).to(dtype).to("meta")
    valid = torch.ones(10, 64, dtype=torch.bool, device="meta")
    sel = torch.arange(u, dtype=torch.int32, device="meta")
    qmask = torch.ones(b, u, dtype=torch.bool, device="meta")
    with build.card_route_on_meta():
        return sti.scan_topk_indexed(q, data, valid, sel, qmask,
                                     k_pad=k_pad)


@pytest.mark.parametrize("d,dtype,b,tiled", [
    (128, torch.float32, 48, False), (3072, torch.float32, 48, True),
    (3072, torch.bfloat16, 48, False), ("min", torch.float32, 48, True),
    ("min-4", torch.float32, 48, False), (3070, torch.float32, 48, False),
    (3072, torch.float32, 4, False)])
def test_traced_meta_scan_counts_the_tiled_design(d, dtype, b, tiled):
    """Each traced scan call that takes the tiled design adds one to
    ``quake.scan.tiled`` (calls, not pairs: no device value is read);
    calls on the row-per-thread design (d = 128, the SIFT cells; odd
    widths; calls of few queries) add nothing.  A meta call launches
    nothing, so the launch counters stay put."""
    d = _width(d)
    before = tracing.program_totals().get("quake.scan.tiled", 0)
    launches = (sti.LAUNCHES.count, sti.LAUNCHES_TILED.count)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        for _ in range(3):
            out_d, out_i = _meta_scan(d, dtype, b=b)
    after = tracing.program_totals().get("quake.scan.tiled", 0)
    assert after - before == (3 if tiled else 0)
    assert (sti.LAUNCHES.count, sti.LAUNCHES_TILED.count) == launches
    assert tuple(out_d.shape) == (b, 128) and out_i.dtype == torch.int32


def test_untraced_meta_scan_counts_nothing():
    """Outside the profiler the counter is off (one flag read)."""
    before = tracing.program_totals().get("quake.scan.tiled", 0)
    _meta_scan(3072, torch.float32)
    assert tracing.program_totals().get("quake.scan.tiled", 0) == before


@pytest.mark.parametrize("d", [128, 3072])
def test_meta_work_is_the_same_for_both_designs(d):
    """The work a meta call counts (``work``: every selected pair and
    row) does not depend on the design that would scan it."""
    build.META_WORK.reset()
    _meta_scan(d, torch.float32)
    w = build.META_WORK.by_kernel["scan_topk_indexed"]
    ops, nbytes = sti.work(48, 6, 64, d, 128, 4)
    assert w["calls"] == 1 and w["ops"] == ops and w["bytes"] == nbytes
    build.META_WORK.reset()

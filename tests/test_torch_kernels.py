"""The port's kernel layer (repro_torch.kernels) against the JAX package.

Every plain kernel version and oracle gets the same numpy inputs as its
JAX counterpart: the Pallas kernel path (``impl="pallas"``, interpret
mode on a CPU) and the jnp oracle.  The port's ``impl="cuda"`` path runs
the kernels' plain versions here (CPU tensors) and the CUDA kernels on a
card; tests/test_torch_cuda.py holds the CUDA kernels against the plain
versions there.

Tolerances: f32 distances agree to rtol 1e-4 / atol 1e-3 (the JAX
package's own kernel-test tolerance: the two frameworks sum the dot
products in different orders); top-k ids are compared as sets (recall),
since near-ties may swap.  Integer and boolean outputs (packing, merge
positions) must be identical.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import kmeans_assign as ka
from repro_torch.kernels import scan_topk as st
from repro_torch.kernels import scan_topk_indexed as sti

RTOL, ATOL = 1e-4, 1e-3


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _n(x):
    return np.asarray(x.detach().cpu()) if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def _recall(a, b) -> float:
    a, b = _n(a), _n(b)
    hits = [len(set(x[x >= 0].tolist()) & set(y[y >= 0].tolist()))
            / max((y >= 0).sum(), 1) for x, y in zip(a, b)]
    return float(np.mean(hits))


def _close_finite(d_port, d_ref):
    d_port, d_ref = _n(d_port).astype(np.float64), _n(d_ref).astype(
        np.float64)
    fin = d_ref < 1e37
    np.testing.assert_array_equal(d_port < 1e37, fin)
    np.testing.assert_allclose(d_port[fin], d_ref[fin], rtol=RTOL,
                               atol=ATOL)


# ---------------------------------------------------------------------------
# ref.py twins
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ref_scan_distances_and_topk(metric):
    rng = np.random.default_rng(0)
    q = rng.normal(size=(5, 17)).astype(np.float32)
    x = rng.normal(size=(333, 17)).astype(np.float32)
    valid = rng.random(333) < 0.8
    dj = jref.scan_distances(jnp.asarray(q), jnp.asarray(x), metric,
                             jnp.asarray(valid))
    dt = ref.scan_distances(_t(q), _t(x), metric, _t(valid))
    np.testing.assert_allclose(_n(dt), np.asarray(dj), rtol=1e-5, atol=1e-4)
    dj, ij = jref.scan_topk_ref(jnp.asarray(q), jnp.asarray(x), 9, metric,
                                jnp.asarray(valid))
    dt, it = ref.scan_topk_ref(_t(q), _t(x), 9, metric, _t(valid))
    np.testing.assert_array_equal(_n(it), np.asarray(ij))
    assert it.dtype == torch.int32
    np.testing.assert_allclose(_n(dt), np.asarray(dj), rtol=RTOL, atol=ATOL)


def test_ref_pairwise_and_kmeans_assign():
    rng = np.random.default_rng(1)
    x = rng.normal(size=(200, 24)).astype(np.float32)
    c = rng.normal(size=(13, 24)).astype(np.float32)
    valid = rng.random(200) < 0.9
    np.testing.assert_allclose(
        _n(ref.pairwise_l2_sq(_t(x), _t(c))),
        np.asarray(jref.pairwise_l2_sq(jnp.asarray(x), jnp.asarray(c))),
        rtol=1e-5, atol=1e-4)
    aj, mj = jref.kmeans_assign_ref(jnp.asarray(x), jnp.asarray(c),
                                    jnp.asarray(valid))
    at, mt = ref.kmeans_assign_ref(_t(x), _t(c), _t(valid))
    np.testing.assert_array_equal(_n(at), np.asarray(aj))
    np.testing.assert_allclose(_n(mt), np.asarray(mj), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_ref_scan_selected_and_merge(metric):
    rng = np.random.default_rng(2)
    data = rng.normal(size=(10, 32, 12)).astype(np.float32)
    valid = rng.random((10, 32)) < 0.85
    sel = rng.choice(10, 4, replace=False).astype(np.int32)
    qmask = rng.random((6, 4)) < 0.6
    q = rng.normal(size=(6, 12)).astype(np.float32)
    dj, ij = jref.scan_selected_ref(jnp.asarray(q), jnp.asarray(data),
                                    jnp.asarray(valid), jnp.asarray(sel),
                                    jnp.asarray(qmask), 20, metric)
    dt, it = ref.scan_selected_ref(_t(q), _t(data), _t(valid), _t(sel),
                                   _t(qmask), 20, metric)
    np.testing.assert_array_equal(_n(it), np.asarray(ij))
    _close_finite(dt, dj)
    a_d = np.sort(rng.normal(size=(3, 8)), 1).astype(np.float32)
    b_d = np.sort(rng.normal(size=(3, 8)), 1).astype(np.float32)
    a_i = np.arange(24, dtype=np.int32).reshape(3, 8)
    b_i = a_i + 100
    mj = jref.merge_topk(*(jnp.asarray(v) for v in (a_d, a_i, b_d, b_i)), 8)
    mt = ref.merge_topk(_t(a_d), _t(a_i), _t(b_d), _t(b_i), 8)
    np.testing.assert_array_equal(_n(mt[0]), np.asarray(mj[0]))
    np.testing.assert_array_equal(_n(mt[1]), np.asarray(mj[1]))


# ---------------------------------------------------------------------------
# ops: the kernel path (plain versions on a CPU) vs Pallas and jnp
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("q,n,d,k", [(1, 100, 8, 5), (5, 333, 17, 7),
                                     (2, 57, 32, 64)])
def test_scan_topk_vs_reference(metric, q, n, d, k):
    rng = np.random.default_rng(q * 1000 + n + d)
    qs = rng.normal(size=(q, d)).astype(np.float32)
    xs = rng.normal(size=(n, d)).astype(np.float32)
    dj, ij = jops.scan_topk(jnp.asarray(qs), jnp.asarray(xs), k,
                            metric=metric, impl="jnp")
    dp, ip_ = jops.scan_topk(jnp.asarray(qs), jnp.asarray(xs), k,
                             metric=metric, impl="pallas")
    for impl in ("cuda", "torch"):
        dt, it = ops.scan_topk(_t(qs), _t(xs), k, metric=metric, impl=impl)
        assert tuple(dt.shape) == (q, k) and it.dtype == torch.int32
        kk = min(k, n)
        assert _recall(it[:, :kk], np.asarray(ij)[:, :kk]) >= 0.999
        assert _recall(it[:, :kk], np.asarray(ip_)[:, :kk]) >= 0.999
        _close_finite(dt, dj)
        np.testing.assert_allclose(_n(dt)[:, :kk], np.asarray(dp)[:, :kk],
                                   rtol=RTOL, atol=ATOL)
        assert (_n(it)[:, kk:] == -1).all()


def test_scan_topk_masked_and_bf16():
    rng = np.random.default_rng(1)
    qs = rng.normal(size=(2, 16)).astype(np.float32)
    xs = rng.normal(size=(64, 16)).astype(np.float32)
    valid = np.arange(64) % 3 != 0
    _, it = ops.scan_topk(_t(qs), _t(xs), 8, valid=_t(valid), impl="cuda")
    assert not np.isin(_n(it), np.where(~valid)[0]).any()
    # bf16 storage: the JAX test's bar (near-ties shift under rounding)
    q16 = rng.normal(size=(4, 32)).astype(np.float32)
    x16 = rng.normal(size=(512, 32)).astype(np.float32)
    dr, ir = jref.scan_topk_ref(jnp.asarray(q16), jnp.asarray(x16), 10)
    dt, it = ops.scan_topk(_t(q16).bfloat16(), _t(x16).bfloat16(), 10,
                           impl="cuda")
    assert _recall(it, np.asarray(ir)) >= 0.8


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("p,s,d,b,u,k", [
    (12, 64, 32, 16, 5, 8),      # typical
    (8, 16, 8, 4, 8, 4),         # union = all partitions
])
def test_scan_selected_vs_reference(metric, p, s, d, b, u, k):
    """k <= S_cap: the JAX kernel path clips its tile's k_pad to S_cap."""
    rng = np.random.default_rng(p + s + b)
    data = rng.normal(size=(p, s, d)).astype(np.float32)
    valid = rng.random((p, s)) < 0.9
    sel = rng.choice(p, u, replace=False).astype(np.int32)
    qmask = rng.random((b, u)) < 0.7
    qs = rng.normal(size=(b, d)).astype(np.float32)
    args_j = [jnp.asarray(v) for v in (qs, data, valid, sel, qmask)]
    dj, ij = jops.scan_selected_topk(*args_j, k, metric=metric, impl="jnp")
    dp, ip_ = jops.scan_selected_topk(*args_j, k, metric=metric,
                                      impl="pallas")
    args_t = [_t(v) for v in (qs, data, valid, sel, qmask)]
    for impl in ("cuda", "torch"):
        dt, it = ops.scan_selected_topk(*args_t, k, metric=metric,
                                        impl=impl)
        assert _recall(it, np.asarray(ij)) >= 0.999
        assert _recall(it, np.asarray(ip_)) >= 0.999
        _close_finite(dt, dj)
        _close_finite(dt, dp)


def test_scan_selected_returns_k_columns_past_capacity():
    """P=4, S=64, k=100: the port returns k columns on every path (the JAX
    kernel path returns 64 here)."""
    rng = np.random.default_rng(5)
    data = rng.normal(size=(4, 64, 8)).astype(np.float32)
    valid = np.ones((4, 64), bool)
    sel = np.arange(4, dtype=np.int32)
    qmask = np.ones((8, 4), bool)
    qs = rng.normal(size=(8, 8)).astype(np.float32)
    dj, ij = jops.scan_selected_topk(
        *(jnp.asarray(v) for v in (qs, data, valid, sel, qmask)), 100,
        impl="jnp")
    for impl in ("cuda", "torch"):
        dt, it = ops.scan_selected_topk(
            *(_t(v) for v in (qs, data, valid, sel, qmask)), 100, impl=impl)
        assert tuple(it.shape) == (8, 100)
        assert _recall(it, np.asarray(ij)) >= 0.999
        _close_finite(dt, dj)


@pytest.mark.parametrize("k", [513, 600])
def test_scan_topk_returns_k_columns_past_512(k):
    """Q=8, N=1024, d=8, k > 512: the port returns k columns on every
    path, equal to the JAX package's ``impl="jnp"`` result.  The JAX
    package's Pallas path returns only 512 here: its tile caps ``k_pad``
    at ``block_s <= 512`` and slices ``[:, :k]`` (a fault of the
    reference, ROADMAP Queue 3 item 3)."""
    rng = np.random.default_rng(0)
    qs = rng.normal(size=(8, 8)).astype(np.float32)
    xs = rng.normal(size=(1024, 8)).astype(np.float32)
    dj, ij = jops.scan_topk(jnp.asarray(qs), jnp.asarray(xs), k, impl="jnp")
    _, ip_ = jops.scan_topk(jnp.asarray(qs), jnp.asarray(xs), k,
                            impl="pallas")
    assert np.asarray(ij).shape == (8, k)
    assert np.asarray(ip_).shape == (8, 512)
    for impl in ("cuda", "torch"):
        dt, it = ops.scan_topk(_t(qs), _t(xs), k, impl=impl)
        assert tuple(it.shape) == (8, k)
        assert _recall(it, np.asarray(ij)) >= 0.999
        _close_finite(dt, dj)


def test_scan_topk_design_picks_rows_below_the_crossover():
    """The dense kernel's dispatch: the row scan below CROSSOVER_Q
    queries, the tiled GEMM from it on, whatever N."""
    c = st.CROSSOVER_Q
    assert c >= 2
    assert [st.design(q) for q in (1, c - 1, c, c + 1, 1024)] == \
        ["rows", "rows", "tiles", "tiles", "tiles"]


@pytest.mark.parametrize("q,n,k_pad", [
    (1024, 1000, 64), (1024, 16384, 128), (1024, 100_003, 16),
    (5, 16384, 16), (1024, 1000, 16384), (1, 1000, 2048)])
def test_scan_topk_tiles_plan_sizes_the_scratch(q, n, k_pad):
    """The "tiles" plan at 132 SMs: the splits cover the row tiles, fill
    about BLOCKS_PER_SM blocks an SM in one wave, fold within
    TILE_MERGE_ENTRIES and SCRATCH_BYTES; top-K buffers past
    TILE_BUF_SMEM go to a global scratch within TOPK_SCRATCH_BYTES."""
    sms = 132
    p = st.tiles_plan(q, n, k_pad, sms)
    qtiles, rtiles = -(-q // st.QT), -(-n // st.RT)
    assert p["splits"] * p["tiles_per_split"] >= rtiles
    assert (p["splits"] - 1) * p["tiles_per_split"] < rtiles
    assert qtiles * p["splits"] <= max(qtiles, st.BLOCKS_PER_SM * sms)
    assert p["splits"] * k_pad <= max(k_pad, st.TILE_MERGE_ENTRIES)
    per_block = st.QT * sti.buffer_size(k_pad) * 8
    assert p["part"] == (2 * q * p["splits"] * k_pad if p["splits"] > 1
                         else 0)
    assert 4 * p["part"] <= max(2 * st.SCRATCH_BYTES, 8 * q * k_pad)
    if per_block > st.TILE_BUF_SMEM:
        assert p["gbuf"] * 4 == p["grid"] * per_block
        assert p["gbuf"] * 4 <= max(per_block, sti.TOPK_SCRATCH_BYTES)
        assert 1 <= p["grid"] <= qtiles * p["splits"]
    else:
        assert p["gbuf"] == 0 and p["grid"] == qtiles * p["splits"]
    if (q, n, k_pad) == (1024, 1000, 64):      # the centroid pass
        assert (p["splits"], p["tiles_per_split"], p["grid"]) == (8, 1, 256)


@pytest.mark.parametrize("n,k_pad", [(1, 16), (63, 1), (1000, 16),
                                     (16384, 128), (100_003, 64),
                                     (16384, 2048), (1000, 16384)])
def test_scan_topk_rows_plan_sizes_the_scratch(n, k_pad):
    """The "rows" plan at 132 SMs: whole 32-row batches a warp covering
    N with no empty block, no more blocks than SMs or than the last
    block's merge holds, and top-K buffers in global scratch past
    ROW_BUF_SMEM."""
    q, sms = 2, 132
    p = st.rows_plan(q, n, k_pad, sms)
    rows, blocks = p["rows_per_warp"], p["blocks"]
    assert rows % 32 == 0 and rows >= 32
    assert blocks * st.WARPS * rows >= n > (blocks - 1) * st.WARPS * rows
    assert blocks <= max(1, min(sms, st.MERGE_BYTES // (8 * k_pad)))
    assert p["part"] == (2 * q * blocks * k_pad if blocks > 1 else 0)
    per_block = st.WARPS * sti.buffer_size(k_pad) * 8
    assert p["gbuf"] * 4 == (blocks * per_block
                             if per_block > st.ROW_BUF_SMEM else 0)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("q_n", ["1", "C+1"])
def test_scan_topk_designs_on_cpu_match_pallas(metric, q_n):
    """ops.scan_topk's kernel path (the plain version on a CPU) against
    the JAX package's Pallas kernel in interpret mode, at one query (the
    "rows" design on the card) and just past the crossover ("tiles")."""
    q = 1 if q_n == "1" else st.CROSSOVER_Q + 1
    rng = np.random.default_rng(31 + q)
    qs = rng.normal(size=(q, 24)).astype(np.float32)
    xs = rng.normal(size=(300, 24)).astype(np.float32)
    dp, ip_ = jops.scan_topk(jnp.asarray(qs), jnp.asarray(xs), 16,
                             metric=metric, impl="pallas")
    dt, it = ops.scan_topk(_t(qs), _t(xs), 16, metric=metric, impl="cuda")
    assert tuple(dt.shape) == (q, 16) and it.dtype == torch.int32
    assert _recall(it, np.asarray(ip_)) >= 0.999
    np.testing.assert_allclose(_n(dt), np.asarray(dp), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("uc", [None, 4])
@pytest.mark.parametrize("b,u", [(1, 5), (37, 9), (100, 12)])
def test_group_queries_plain_lists_each_probe_once(b, u, uc):
    """The indexed kernels' grouping step in plain PyTorch: every (b, u)
    with qmask[b, u] appears exactly once in u's list, in increasing b,
    and exactly once among the tiles of QT queries, which are listed
    slot by slot in the kernels' order (longest partitions first within
    each chunk of ``uc`` slots).  Columns include one no query probes,
    one every query probes, and counts just below, at and just above
    multiples of QT."""
    rng = np.random.default_rng(b + u)
    qmask = rng.random((b, u)) < 0.3
    qmask[:, 0] = False                              # probed by none
    qmask[:, 1] = True                               # probed by all
    for col, n in zip(range(2, u), (15, 16, 17, 31, 32, 33)):
        qmask[:, col] = False
        qmask[rng.permutation(b)[:n], col] = True    # n, or all of b
    sel = rng.permutation(u).astype(np.int32)
    nrows = rng.integers(0, 50, size=u).astype(np.int32)
    step = u if uc is None else uc
    order = sti.slot_order(_t(sel), _t(nrows), step)
    o = _n(order)
    for u0 in range(0, u, step):                     # a permutation per
        chunk = o[u0:u0 + step]                      # chunk, longest first
        assert sorted(chunk) == list(range(u0, min(u0 + step, u)))
        lens = nrows[sel[chunk]]
        assert (np.diff(lens) <= 0).all()
    g = sti.group_queries_plain(_t(qmask), order, uc)
    qt = sti.QT
    counts = qmask.sum(axis=0)
    np.testing.assert_array_equal(_n(g["qcount"]), counts)
    for col in range(u):
        lst = _n(g["qlist"][col])
        np.testing.assert_array_equal(lst[:counts[col]],
                                      np.nonzero(qmask[:, col])[0])
        assert (lst[counts[col]:] == -1).all()
    ntiles = -(-counts // qt)
    np.testing.assert_array_equal(_n(g["ntiles"]), ntiles)
    starts = np.r_[0, np.cumsum(ntiles[o])]
    np.testing.assert_array_equal(_n(g["tile_off"])[o], starts[:-1])
    np.testing.assert_array_equal(_n(g["chunk_off"]),
                                  np.r_[starts[0:u:step], starts[-1]])
    np.testing.assert_array_equal(_n(g["work_u"]), np.repeat(o, ntiles[o]))
    # the tiles cover each probe exactly once
    seen = np.zeros((b, u), dtype=int)
    off = _n(g["tile_off"])
    for t, col in enumerate(_n(g["work_u"])):
        q0 = (t - off[col]) * qt
        for bb in _n(g["qlist"][col])[q0:min(q0 + qt, counts[col])]:
            seen[bb, col] += 1
    np.testing.assert_array_equal(seen, qmask.astype(int))


def test_scan_selected_bf16_storage():
    rng = np.random.default_rng(7)
    data32 = rng.normal(size=(8, 64, 16)).astype(np.float32)
    valid = np.ones((8, 64), bool)
    sel = np.arange(8, dtype=np.int32)
    qs = rng.normal(size=(4, 16)).astype(np.float32)
    qmask = np.ones((4, 8), bool)
    d_ref, i_ref = jref.scan_selected_ref(
        *(jnp.asarray(v) for v in (qs, data32, valid, sel, qmask)), 10, "l2")
    dp, ip_ = jops.scan_selected_topk(
        jnp.asarray(qs), jnp.asarray(data32, jnp.bfloat16),
        *(jnp.asarray(v) for v in (valid, sel, qmask)), 10, impl="pallas")
    dt, it = ops.scan_selected_topk(
        _t(qs), _t(data32).bfloat16(),
        *(_t(v) for v in (valid, sel, qmask)), 10, impl="cuda")
    assert _recall(it, np.asarray(i_ref)) >= 0.8
    # same bf16 operands, products exact in f32: the two kernel paths agree
    assert _recall(it, np.asarray(ip_)) >= 0.999
    _close_finite(dt, dp)


@pytest.mark.parametrize("n,c,d", [(100, 7, 8), (513, 37, 24),
                                   (65, 200, 16)])
def test_kmeans_assign_vs_reference(n, c, d):
    rng = np.random.default_rng(n + c)
    xs = rng.normal(size=(n, d)).astype(np.float32)
    cs = rng.normal(size=(c, d)).astype(np.float32)
    a_j, d_j = jops.kmeans_assign(jnp.asarray(xs), jnp.asarray(cs),
                                  impl="jnp")
    a_p, d_p = jops.kmeans_assign(jnp.asarray(xs), jnp.asarray(cs),
                                  impl="pallas")
    for impl in ("cuda", "torch"):
        a_t, d_t = ops.kmeans_assign(_t(xs), _t(cs), impl=impl)
        assert a_t.dtype == torch.int32
        np.testing.assert_allclose(_n(d_t), np.asarray(d_j), rtol=RTOL,
                                   atol=ATOL)
        np.testing.assert_allclose(_n(d_t), np.asarray(d_p), rtol=RTOL,
                                   atol=ATOL)
        assert np.mean(_n(a_t) == np.asarray(a_j)) > 0.99
        assert np.mean(_n(a_t) == np.asarray(a_p)) > 0.99


def test_kmeans_assign_exact_ties_go_to_smallest_index():
    rng = np.random.default_rng(3)
    cs = rng.normal(size=(40, 16)).astype(np.float32)
    cs[3] = cs[31]                       # exact duplicate, smaller index
    xs = cs[31] + 0.01 * rng.normal(size=(50, 16)).astype(np.float32)
    valid = np.ones(40, bool)
    valid[0] = False                     # masked centroids never win
    a_p, _ = jops.kmeans_assign(jnp.asarray(xs), jnp.asarray(cs),
                                impl="pallas")
    for impl in ("cuda", "torch"):
        a_t, _ = ops.kmeans_assign(_t(xs), _t(cs), impl=impl)
        assert (_n(a_t) == 3).all()
        np.testing.assert_array_equal(_n(a_t), np.asarray(a_p))
        a_v, _ = ops.kmeans_assign(_t(xs), _t(cs),
                                   valid_centroids=_t(valid), impl=impl)
        assert (_n(a_v) == 3).all()


# ---------------------------------------------------------------------------
# packing and merge (plain torch in both packages' sense)
# ---------------------------------------------------------------------------

def test_pack_union_matches_reference_ranking():
    rng = np.random.default_rng(4)
    selected = rng.random((9, 30)) < 0.2
    selected[:, 5] = selected[:, 17] = True     # equal counts: tie order
    prio = np.zeros(30, np.int32)
    prio[[2, 29]] = 10
    for pr in (None, prio):
        sj, qj = jops.pack_union(jnp.asarray(selected), 12,
                                 None if pr is None else jnp.asarray(pr))
        s_t, q_t = ops.pack_union(_t(selected), 12,
                                  None if pr is None else _t(pr))
        np.testing.assert_array_equal(_n(s_t), np.asarray(sj))
        np.testing.assert_array_equal(_n(q_t), np.asarray(qj))
        assert s_t.dtype == torch.int32


@pytest.mark.parametrize("u_pad", [8, 24, 40])
def test_pack_round_masked_matches_reference(u_pad):
    rng = np.random.default_rng(u_pad)
    p, b, w = 30, 7, 5
    sel_q = rng.integers(0, p, size=(b, w)).astype(np.int32)
    qvalid = rng.random((b, w)) < 0.7
    prio = np.zeros(p, np.int32)
    n_real = 6
    sj, qj = jops.pack_round_masked(jnp.asarray(sel_q), jnp.asarray(qvalid),
                                    jnp.asarray(prio), n_real, p=p,
                                    u_pad=u_pad)
    s_t, q_t = ops.pack_round_masked(_t(sel_q), _t(qvalid), _t(prio),
                                     n_real, p=p, u_pad=u_pad)
    np.testing.assert_array_equal(_n(s_t), np.asarray(sj))
    np.testing.assert_array_equal(_n(q_t), np.asarray(qj))
    sj, qj = jops.pack_round(jnp.asarray(sel_q), jnp.asarray(qvalid),
                             jnp.asarray(prio), p=p, n_union=min(u_pad, p))
    s_t, q_t = ops.pack_round(_t(sel_q), _t(qvalid), _t(prio), p=p,
                              n_union=min(u_pad, p))
    np.testing.assert_array_equal(_n(s_t), np.asarray(sj))
    np.testing.assert_array_equal(_n(q_t), np.asarray(qj))


def test_topk_merge_matches_reference_with_misses():
    rng = np.random.default_rng(6)
    a_d = np.sort(rng.normal(size=(4, 6)), 1).astype(np.float32)
    b_d = np.sort(rng.normal(size=(4, 6)), 1).astype(np.float32)
    a_d[:, 4:] = ref.MASK_DIST
    b_d[1, :] = ref.MASK_DIST
    b_d[2, 0] = a_d[2, 0]                     # exact tie across lists
    a_i = np.where(a_d < 1e37, np.arange(24).reshape(4, 6), -1)
    b_i = np.where(b_d < 1e37, 100 + np.arange(24).reshape(4, 6), -1)
    a_i, b_i = a_i.astype(np.int32), b_i.astype(np.int32)
    mj = jops.topk_merge(*(jnp.asarray(v) for v in (a_d, a_i, b_d, b_i)), 6)
    mt = ops.topk_merge(_t(a_d), _t(a_i), _t(b_d), _t(b_i), 6)
    np.testing.assert_array_equal(_n(mt[0]), np.asarray(mj[0]))
    np.testing.assert_array_equal(_n(mt[1]), np.asarray(mj[1]))


# ---------------------------------------------------------------------------
# int8 (IVF-residual SQ8) scan
# ---------------------------------------------------------------------------

def test_quantize_int8_matches_reference():
    """Codes equal (round half to even and the same division in both);
    scales to rtol 1e-6 (they are bit-equal here).  The rows include exact
    .5 multiples of their scale, where a rounding rule would show."""
    from repro.kernels.scan_topk_indexed import quantize_int8 as jq
    from repro.kernels.scan_topk_indexed import quantize_int8_residual as jqr
    rng = np.random.default_rng(11)
    x = rng.normal(size=(6, 40, 24)).astype(np.float32) * 3.0
    x[0, 0, :4] = [127.0, 0.5, 1.5, -2.5]     # scale 1: ties at .5
    cents = rng.normal(size=(6, 24)).astype(np.float32) * 4.0
    for got, want in ((sti.quantize_int8(_t(x)), jq(jnp.asarray(x))),
                      (sti.quantize_int8_residual(_t(x), _t(cents)),
                       jqr(jnp.asarray(x), jnp.asarray(cents)))):
        assert got[0].dtype == torch.int8
        np.testing.assert_array_equal(_n(got[0]), np.asarray(want[0]))
        np.testing.assert_allclose(_n(got[1]), np.asarray(want[1]),
                                   rtol=1e-6)
    assert _n(sti.quantize_int8(_t(x))[0])[0, 0, :4].tolist() == \
        [127, 0, 2, -2]


def _q8_inputs(residual, p=16, s=64, d=24, b=8, u=10, seed=5):
    """The JAX package's int8 test shape: tight clusters around scaled
    centroids, queries near the selected ones."""
    rng = np.random.default_rng(seed)
    cents = rng.normal(size=(p, d)).astype(np.float32) * 4.0
    data = cents[:, None, :] + rng.normal(size=(p, s, d)).astype(np.float32)
    valid = rng.random((p, s)) < 0.9
    sel = rng.choice(p, u, replace=False).astype(np.int32)
    qmask = rng.random((b, u)) < 0.7
    qs = (cents[sel[np.arange(b) % u]]
          + rng.normal(size=(b, d))).astype(np.float32)
    codes, scales = sti.quantize_int8_residual(_t(data), _t(cents)) \
        if residual else sti.quantize_int8(_t(data))
    return qs, codes, scales, valid, sel, qmask, cents


def _firm(d_ref, tol):
    """Positions whose reference distance is farther than ``tol`` from
    both neighbours in its list (no near-tie that rounding may swap)."""
    d = np.asarray(d_ref, np.float64)
    gap = np.full(d.shape, np.inf)
    step = np.abs(np.diff(d, axis=1))
    gap[:, 1:] = step
    gap[:, :-1] = np.minimum(gap[:, :-1], step)
    return (d < 1e37) & (gap > tol)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("residual", [True, False])
def test_scan_selected_q8_vs_reference(metric, residual):
    """The port's int8 oracle (impl="torch") and its kernel path (the
    kernel's plain version on CPU tensors) against the JAX package's
    Pallas kernel in interpret mode.  Same codes, scales and query codes;
    ``aux`` and ``qc`` are f32 sums taken in another order, so distances
    agree to rtol 1e-4 / atol 1e-3 and ids are equal wherever the
    reference has no near-tie (2k <= the tile: k = 10, S = 64)."""
    qs, codes, scales, valid, sel, qmask, cents = _q8_inputs(residual)
    k = 10
    dj, ij = jops.scan_selected_topk_q8(
        jnp.asarray(qs), jnp.asarray(_n(codes)), jnp.asarray(_n(scales)),
        jnp.asarray(valid), jnp.asarray(sel), jnp.asarray(qmask), k,
        metric=metric, centroids=jnp.asarray(cents) if residual else None)
    dj, ij = np.asarray(dj), np.asarray(ij)
    firm = _firm(dj, 1e-3)
    assert firm.mean() > 0.9
    for impl in ("torch", "cuda"):
        dt, it = ops.scan_selected_topk_q8(
            _t(qs), codes, scales, _t(valid), _t(sel), _t(qmask), k,
            metric=metric, centroids=_t(cents) if residual else None,
            impl=impl)
        assert tuple(it.shape) == (8, k) and it.dtype == torch.int32
        np.testing.assert_array_equal(_n(it)[firm], ij[firm])
        assert _recall(it, ij) >= 0.999
        _close_finite(dt, dj)


def test_scan_selected_q8_returns_k_columns_past_capacity():
    """P=4, S=8, k=20: the JAX int8 wrapper clips its tile's k_pad to
    S=8 and returns 8 columns (ROADMAP Queue 3 item 2); the port returns
    all 20, and its first 8 are the reference's."""
    qs, codes, scales, valid, sel, qmask, cents = _q8_inputs(
        True, p=4, s=8, d=8, b=3, u=4, seed=6)
    qmask[:] = True
    dj, ij = jops.scan_selected_topk_q8(
        jnp.asarray(qs), jnp.asarray(_n(codes)), jnp.asarray(_n(scales)),
        jnp.asarray(valid), jnp.asarray(sel), jnp.asarray(qmask), 20,
        centroids=jnp.asarray(cents))
    assert np.asarray(ij).shape == (3, 8)
    live = int(valid[sel].sum())
    for impl in ("torch", "cuda"):
        dt, it = ops.scan_selected_topk_q8(
            _t(qs), codes, scales, _t(valid), _t(sel), _t(qmask), 20,
            centroids=_t(cents), impl=impl)
        assert tuple(it.shape) == (3, 20)
        assert ((_n(it) >= 0).sum(axis=1) == min(20, live)).all()
        np.testing.assert_array_equal(_n(it)[:, :8], np.asarray(ij))
        _close_finite(dt[:, :8], dj)


def test_q8_plain_version_is_the_oracle_in_partition_order():
    """The kernel's plain version orders the union by partition, so equal
    distances keep the smaller flat index whatever the union order, and
    an inert tail (duplicated slots under all-False masks) changes
    nothing."""
    qs, codes, scales, valid, sel, qmask, cents = _q8_inputs(True, seed=9)
    codes[sel[1]] = codes[sel[0]]              # two identical partitions
    scales[sel[1]] = scales[sel[0]]
    valid[sel[1]] = valid[sel[0]]
    qmask[:] = True
    sel_t = _t(sel)
    q_codes, q_scales, aux, qc = ref.q8_scan_operands(
        _t(qs), codes, scales, _t(valid), sel_t, "ip")   # plain codes: qc 0
    args = (q_codes, q_scales, codes, scales, aux)
    d1, i1 = sti.scan_topk_indexed_q8_plain(*args, qc, _t(valid), sel_t,
                                            _t(qmask), k_pad=64,
                                            metric="ip")
    tail = torch.cat([sel_t, sel_t[:1].expand(6)])
    qm = torch.cat([_t(qmask), torch.zeros(8, 6, dtype=torch.bool)], 1)
    qc2 = torch.cat([qc, torch.zeros(8, 6)], 1)
    d2, i2 = sti.scan_topk_indexed_q8_plain(*args, qc2, _t(valid),
                                            tail.flip(0), qm.flip(1),
                                            k_pad=64, metric="ip")
    assert torch.equal(d1, d2) and torch.equal(i1, i2)
    lo, hi = sorted(sel[:2].tolist())
    i1 = _n(i1)
    for b in range(8):                     # the copy at the smaller id wins
        ids = i1[b][np.isin(i1[b] // 64, [lo, hi]) & (i1[b] >= 0)]
        assert (ids[::2] // 64 == lo).all() and (ids[1::2] // 64 == hi).all()


@pytest.mark.parametrize("d", [1036, 1044, 8192, 65536])
def test_q8_oracle_sums_exactly_at_any_width(d):
    """Past d = 1,040 an int8 product's partial sums leave f32's exact
    integers; the oracle then sums in f64 and rounds once, as the
    kernel's int32 sum is converted: its distances equal those formed
    from exact int64 products in the oracle's order."""
    rng = np.random.default_rng(d)
    p, s, b = 3, 5, 4
    codes = torch.as_tensor(rng.integers(-127, 128, (p, s, d)),
                            dtype=torch.int8)
    q_codes = codes[2, :b].clone()      # rows' own codes: sums past 2^24
    scales = torch.as_tensor(rng.random((p, s)) * 0.02 + 0.01,
                             dtype=torch.float32)
    q_scales = torch.as_tensor(rng.random(b) * 0.02 + 0.01,
                               dtype=torch.float32)
    aux = torch.as_tensor(rng.random((p, s)) * 10, dtype=torch.float32)
    sel = torch.tensor([2, 0], dtype=torch.int32)
    qc = torch.as_tensor(rng.normal(size=(b, 2)), dtype=torch.float32)
    valid = torch.ones((p, s), dtype=torch.bool)
    qmask = torch.ones((b, 2), dtype=torch.bool)
    dist, idx = ref.scan_indexed_q8_ref(q_codes, q_scales, codes, scales,
                                        aux, qc, valid, sel, qmask, 10)
    dots = torch.einsum("usd,bd->bus",
                        codes[sel.long()].long(), q_codes.long()).float()
    want = (aux[sel.long()][None]
            - 2.0 * (qc[:, :, None] + dots * q_scales[:, None, None]
                     * scales[sel.long()][None])).reshape(b, -1)
    flat = (sel.long()[:, None] * s + torch.arange(s)).reshape(-1)
    pos = (flat[None, None, :] == idx.long()[..., None]).int().argmax(-1)
    assert torch.equal(flat[pos], idx.long())
    assert torch.equal(dist, want.gather(1, pos))


# ---------------------------------------------------------------------------
# kernel modules: dispatch, checks, launch counts, build
# ---------------------------------------------------------------------------

def test_cpu_tensors_take_the_plain_versions_without_launching():
    rng = np.random.default_rng(8)
    counters = (sti.LAUNCHES, st.LAUNCHES, ka.LAUNCHES)
    before = [c.count for c in counters]
    data = _t(rng.normal(size=(5, 16, 8)).astype(np.float32))
    valid = torch.ones(5, 16, dtype=torch.bool)
    q = _t(rng.normal(size=(3, 8)).astype(np.float32))
    d1, i1 = sti.scan_topk_indexed(q, data, valid,
                                   torch.arange(5, dtype=torch.int32),
                                   torch.ones(3, 5, dtype=torch.bool),
                                   k_pad=16)
    d2, i2 = st.scan_topk(q, data.reshape(-1, 8), k_pad=16)
    a, m = ka.kmeans_assign(q, data[0], (data[0] ** 2).sum(1))
    assert [c.count for c in counters] == before
    # all five partitions, all rows: both scans see the same rows
    np.testing.assert_array_equal(_n(i1), _n(i2))
    np.testing.assert_allclose(_n(d1), _n(d2), rtol=1e-5, atol=1e-5)
    assert tuple(a.shape) == (3,) and a.dtype == torch.int32


def test_cuda_wrappers_refuse_cpu_tensors_and_bad_operands():
    q = torch.zeros(2, 8)
    data = torch.zeros(3, 16, 8)
    valid = torch.ones(3, 16, dtype=torch.bool)
    sel = torch.arange(3, dtype=torch.int32)
    qmask = torch.ones(2, 3, dtype=torch.bool)
    with pytest.raises(ValueError):
        sti.scan_topk_indexed_cuda(q, data, valid, sel, qmask, k_pad=8)
    with pytest.raises(ValueError):
        sti.scan_topk_indexed_cuda(q, data, valid, sel, qmask, k_pad=12)
    with pytest.raises(ValueError):
        st.scan_topk_cuda(q, data[0], k_pad=8)
    with pytest.raises(ValueError):
        ka.kmeans_assign_cuda(q, data[0], torch.zeros(16))
    with pytest.raises(ValueError):
        ops.scan_topk(q, data[0], 4, impl="pallas")


def test_q8_wrapper_takes_the_plain_version_on_cpu_and_refuses_operands():
    qs, codes, scales, valid, sel, qmask, cents = _q8_inputs(True, d=16)
    operands = ref.q8_scan_operands(_t(qs), codes, scales, _t(valid),
                                    _t(sel), "l2", _t(cents))
    args = (*operands[:2], codes, scales, *operands[2:], _t(valid),
            _t(sel), _t(qmask))
    before = sti.LAUNCHES_Q8.count
    d1, i1 = sti.scan_topk_indexed_q8(*args, k_pad=16)
    assert sti.LAUNCHES_Q8.count == before
    d2, i2 = sti.scan_topk_indexed_q8_plain(*args, k_pad=16)
    assert torch.equal(d1, d2) and torch.equal(i1, i2)
    with pytest.raises(ValueError, match="CUDA"):
        sti.scan_topk_indexed_q8_cuda(*args, k_pad=16)
    with pytest.raises(ValueError, match="int8"):          # f32 "codes"
        sti.scan_topk_indexed_q8_cuda(args[0], args[1], codes.float(),
                                      *args[3:], k_pad=16)
    with pytest.raises(ValueError, match="power of two"):
        sti.scan_topk_indexed_q8_cuda(*args, k_pad=12)
    with pytest.raises(ValueError, match="exceeds"):
        sti.scan_topk_indexed_q8_cuda(*args, k_pad=2 * sti.K_MAX)


def test_build_raises_without_nvcc(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path / "kernels")
    with pytest.raises(build.KernelBuildError):
        build.build_all()
    # library names carry a hash of their sources and flags
    assert build._lib_path("scan_topk").name.startswith("libscan_topk_")
    assert build._lib_path("scan_topk") != build._lib_path("kmeans_assign")


def test_launch_counter_counts_and_resets():
    c = build.LaunchCounter("x")
    c.add()
    c.add()
    assert c.count == 2
    c.reset()
    assert c.count == 0


def _chip_smoke():
    import importlib
    import sys
    from pathlib import Path
    root = str(Path(__file__).resolve().parents[1])
    if root not in sys.path:
        sys.path.insert(0, root)
    return importlib.import_module("chip_smoke")


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_smoke_check_rejects_a_scan_that_drops_rows(metric):
    """chip_smoke.py's kernel-vs-plain check, on one dense cluster far from
    the origin: distances carry a large norm offset and neighbouring
    entries lie close, as at the main path's shapes.  f32-level noise
    passes; a scan that skips the last row of every 32-row tile fails
    (in L2, a bound of 1e-3 times the largest |distance| let that
    through)."""
    smoke = _chip_smoke()
    rng = np.random.default_rng(21)
    p, s, d, b = 16, 512, 16, 16
    data = (rng.normal(size=d) * 6.0
            + rng.normal(size=(p, s, d))).astype(np.float32)
    q = (data.reshape(-1, d)[rng.integers(0, p * s, b)]
         + 0.1 * rng.normal(size=(b, d))).astype(np.float32)
    valid = torch.ones(p, s, dtype=torch.bool)
    sel = torch.arange(p, dtype=torch.int32)
    qmask = torch.ones(b, p, dtype=torch.bool)
    dp, ip_ = sti.scan_topk_indexed_plain(_t(q), _t(data), valid, sel,
                                          qmask, k_pad=32, metric=metric)
    noisy = dp * (1.0 + 2e-7 * torch.as_tensor(rng.standard_normal(
        dp.shape), dtype=torch.float32))
    err, tol = smoke.compare_topk("noise", noisy, ip_, dp, ip_)
    assert 0.0 < err <= tol
    dropped = valid.clone()
    dropped[:, 31::32] = False
    dm, im = sti.scan_topk_indexed_plain(_t(q), _t(data), dropped, sel,
                                         qmask, k_pad=32, metric=metric)
    assert not torch.equal(im, ip_)
    with pytest.raises(SystemExit):
        smoke.compare_topk("dropped rows", dm, im, dp, ip_)

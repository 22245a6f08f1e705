"""The port's CUDA kernels on the card, against their plain versions.

Every test here needs an NVIDIA GPU and skips without one.  The int8
tests hold the q8 kernel against its plain version and check that the
int8 executor and a maintenance pass on a CUDA index launch their
kernels; the flash-attention tests at the end hold that kernel against
its plain version and check that ``Transformer.prefill`` on the card
launches it once per layer; the training tests hold one train step of
each smoke config against the CPU's, an asynchronous checkpoint of card
tensors, and the compressed step on a one-rank NCCL group; the last
tests hold each kernel wrapper's allocations on ``meta`` tensors (the
dry-run's count) against the same call's on the card.  The file
imports neither JAX nor the JAX package, so it also runs on a machine
that has only PyTorch: from the repository root,

    PYTHONPATH=src python -m pytest -q --noconftest tests/test_torch_cuda.py

(``--noconftest``: the shared conftest imports the JAX package).

Shapes probe the kernels' edges: widths that are not multiples of a warp,
batches that are not multiples of a query tile, k_pad from 1 to the
kernel's limit, unions processed in several chunks, invalid rows and
whole empty partitions, duplicated union slots under all-False masks,
and exact ties.  Tolerance: distances agree to rtol 1e-4 / atol 1e-3 (the
kernel and the plain version sum the dot products in different orders);
top-k ids agree as sets to 0.999 (near-ties may swap).
"""
import numpy as np
import pytest
import torch

from repro_torch.core import multiquery as mq
from repro_torch.core.convert import index_from_arrays, index_to_arrays
from repro_torch.core.index import QuakeIndex
from repro_torch.data import datasets
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import kmeans_assign as ka
from repro_torch.kernels import ops, ref
from repro_torch.kernels import scan_topk as st
from repro_torch.kernels import scan_topk_indexed as sti

pytestmark = pytest.mark.cuda

RTOL, ATOL = 1e-4, 1e-3


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda")


def _recall(a, b) -> float:
    a, b = a.cpu().numpy(), b.cpu().numpy()
    hits = [len(set(x[x >= 0].tolist()) & set(y[y >= 0].tolist()))
            / max((y >= 0).sum(), 1) for x, y in zip(a, b)]
    return float(np.mean(hits))


def _same_topk(dk, ik, dp, ip_):
    torch.cuda.synchronize()
    dk, dp = dk.double().cpu().numpy(), dp.double().cpu().numpy()
    fin = dp < 1e37
    np.testing.assert_array_equal(dk < 1e37, fin)
    np.testing.assert_allclose(dk[fin], dp[fin], rtol=RTOL, atol=ATOL)
    assert (ik.cpu().numpy()[~fin] == -1).all()
    assert _recall(ik, ip_) >= 0.999


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("p,s,d,b,u,k_pad", [
    (40, 96, 32, 37, 17, 64),     # typical, B not a tile multiple
    (9, 40, 7, 1, 9, 1),          # d < a warp, one query, k_pad 1
    (20, 300, 130, 13, 11, 1024),  # wide rows, the largest k_pad
    (64, 64, 16, 64, 64, 128),    # union = all partitions
])
def test_scan_topk_indexed_matches_plain(dev, dtype, metric, p, s, d, b, u,
                                         k_pad):
    rng = np.random.default_rng(p + s + d)
    data = torch.as_tensor(rng.normal(size=(p, s, d)).astype(np.float32),
                           device=dev).to(dtype)
    valid = torch.as_tensor(rng.random((p, s)) < 0.8, device=dev)
    valid[1] = False                           # an empty partition
    valid[2, s // 2:] = False                  # a short one
    sel = torch.as_tensor(rng.choice(p, u, replace=False).astype(np.int32),
                          device=dev)
    qmask = torch.as_tensor(rng.random((b, u)) < 0.5, device=dev)
    q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32),
                        device=dev).to(dtype)
    before = sti.LAUNCHES.count
    dk, ik = sti.scan_topk_indexed(q, data, valid, sel, qmask, k_pad=k_pad,
                                   metric=metric)
    assert sti.LAUNCHES.count == before + 1
    dp, ip_ = sti.scan_topk_indexed_plain(q, data, valid, sel, qmask,
                                          k_pad=k_pad, metric=metric)
    _same_topk(dk, ik, dp, ip_)


def test_scan_topk_indexed_chunked_union_and_inert_tail(dev, monkeypatch):
    """A union in many chunks gives the result of one; duplicated slots
    under all-False masks (the packer's inert tail) change nothing."""
    rng = np.random.default_rng(3)
    data = torch.as_tensor(rng.normal(size=(30, 50, 24)).astype(np.float32),
                           device=dev)
    valid = torch.ones(30, 50, dtype=torch.bool, device=dev)
    sel = torch.as_tensor(np.r_[rng.choice(30, 20, replace=False),
                                [0, 0, 0, 0]].astype(np.int32), device=dev)
    sel[20:] = sel[0]
    qmask = torch.as_tensor(rng.random((21, 24)) < 0.4, device=dev)
    qmask[:, 20:] = False
    q = torch.as_tensor(rng.normal(size=(21, 24)).astype(np.float32),
                        device=dev)
    whole = sti.scan_topk_indexed(q, data, valid, sel, qmask, k_pad=32)
    monkeypatch.setattr(sti, "SCRATCH_BYTES", 21 * 32 * 8 * 3)  # 3 slots
    chunked = sti.scan_topk_indexed(q, data, valid, sel, qmask, k_pad=32)
    torch.cuda.synchronize()
    assert torch.equal(whole[0], chunked[0])
    assert torch.equal(whole[1], chunked[1])
    _same_topk(*chunked, *sti.scan_topk_indexed_plain(
        q, data, valid, sel, qmask, k_pad=32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("q_n,n,d,k_pad,masked", [
    (50, 700, 24, 32, False), (1024, 1000, 128, 64, False),
    (3, 33, 5, 64, True)])
def test_scan_topk_matches_plain(dev, dtype, q_n, n, d, k_pad, masked,
                                 monkeypatch):
    rng = np.random.default_rng(n + d)
    q = torch.as_tensor(rng.normal(size=(q_n, d)).astype(np.float32),
                        device=dev).to(dtype)
    xs = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                         device=dev).to(dtype)
    valid = torch.as_tensor(rng.random(n) < 0.7, device=dev) \
        if masked else None
    dp, ip_ = st.scan_topk_plain(q, xs, valid, k_pad=k_pad)
    _same_topk(*st.scan_topk(q, xs, valid, k_pad=k_pad), dp, ip_)
    monkeypatch.setattr(st, "BLOCKS_PER_SM", 64)   # a split a row tile
    monkeypatch.setattr(st, "ROWS_PER_WARP", 32)   # and many row blocks
    _same_topk(*st.scan_topk(q, xs, valid, k_pad=k_pad), dp, ip_)


def _resolve_q(q):
    """A query count of the design tests: an int, or "C-1", "C", "C+1"
    around the crossover between the two designs."""
    if isinstance(q, int):
        return q
    return st.CROSSOVER_Q + {"C-1": -1, "C": 0, "C+1": 1}[q]


# (Q, N, d, k_pad, dtype, metric, masked): Q in {1, 2, around the
# crossover, 1024}, N in {1, 63, 1000, 16384, 100003}, d in {5, 128,
# 960}, k_pad in {1, 16, 64, 128, 2048, 16384}, f32/bf16, L2/IP, masks
F32, BF16 = torch.float32, torch.bfloat16
DESIGN_CASES = [
    (1, 1000, 128, 16, F32, "l2", False),
    (1, 1000, 128, 128, F32, "ip", True),
    (1, 16384, 128, 16, BF16, "l2", False),
    (1, 16384, 128, 128, F32, "l2", False),
    (1, 100003, 128, 64, F32, "l2", True),
    (1, 1, 5, 1, F32, "l2", False),
    (1, 63, 5, 64, F32, "ip", False),
    (1, 1000, 960, 2048, F32, "l2", False),
    (1, 16384, 960, 16384, BF16, "ip", False),
    (2, 63, 128, 16, BF16, "ip", True),
    (2, 16384, 5, 128, F32, "l2", False),
    ("C-1", 1000, 128, 64, F32, "l2", True),
    ("C-1", 100003, 960, 16, BF16, "l2", False),
    ("C", 1000, 128, 64, F32, "l2", True),
    ("C", 63, 960, 128, BF16, "ip", False),
    ("C+1", 16384, 128, 2048, F32, "l2", False),
    ("C+1", 1, 5, 16, F32, "ip", True),
    (1024, 1000, 128, 64, F32, "l2", False),
    (1024, 16384, 128, 128, F32, "ip", True),
    (1024, 100003, 128, 16, BF16, "l2", False),
    (1024, 63, 5, 1, F32, "l2", False),
    (1024, 1000, 960, 16384, F32, "l2", False),
    (1024, 16384, 960, 2048, BF16, "ip", True),
]


@pytest.mark.parametrize("q_n,n,d,k_pad,dtype,metric,masked", DESIGN_CASES)
def test_scan_topk_designs_match_plain(dev, q_n, n, d, k_pad, dtype, metric,
                                       masked):
    """Both designs of the dense kernel ("rows" below the crossover,
    "tiles" from it on) against the plain version, at the shapes of every
    caller and past them."""
    q_n = _resolve_q(q_n)
    rng = np.random.default_rng(q_n + n + d + k_pad)
    q = torch.as_tensor(rng.normal(size=(q_n, d)).astype(np.float32),
                        device=dev).to(dtype)
    xs = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                         device=dev).to(dtype)
    valid = torch.as_tensor(rng.random(n) < 0.7, device=dev) \
        if masked else None
    before = st.LAUNCHES.count
    dk, ik = st.scan_topk(q, xs, valid, k_pad=k_pad, metric=metric)
    assert st.LAUNCHES.count == before + 1
    _same_topk(dk, ik, *st.scan_topk_plain(q, xs, valid, k_pad=k_pad,
                                           metric=metric))


@pytest.mark.parametrize("q_n", [1, "C-1", "C", 1024])
@pytest.mark.parametrize("split", [False, True])
def test_scan_topk_duplicated_rows_keep_the_smaller_index(dev, monkeypatch,
                                                          q_n, split):
    """Rows repeated many times over, with small integer values, so every
    distance is exact in f32 in any order: the kernel's ids and distances
    equal the plain version's exactly (equal distances keep the smaller
    index), with the rows in one block or split over many (tiles split
    one a split, rows 32 a warp), twice in a row (the "rows" design's
    ticket is reset by its last block)."""
    q_n = _resolve_q(q_n)
    if split:
        monkeypatch.setattr(st, "BLOCKS_PER_SM", 64)
        monkeypatch.setattr(st, "ROWS_PER_WARP", 32)
    rng = np.random.default_rng(5)
    base = rng.integers(-3, 4, size=(40, 16)).astype(np.float32)
    xs = torch.as_tensor(base[rng.integers(0, 40, 5000)], device=dev)
    q = torch.as_tensor(rng.integers(-3, 4, size=(q_n, 16)),
                        dtype=torch.float32, device=dev)
    valid = torch.as_tensor(rng.random(5000) < 0.9, device=dev)
    for metric in ("l2", "ip"):
        dp, ip_ = st.scan_topk_plain(q, xs, valid, k_pad=256, metric=metric)
        for _ in range(2):
            dk, ik = st.scan_topk(q, xs, valid, k_pad=256, metric=metric)
            torch.cuda.synchronize()
            assert torch.equal(ik, ip_) and torch.equal(dk, dp)


@pytest.mark.parametrize("n,c,d", [(100, 7, 8), (1000, 333, 64),
                                   (65, 40, 200)])
def test_kmeans_assign_matches_plain_with_ties_and_masks(dev, n, c, d):
    rng = np.random.default_rng(n + c)
    cs = torch.as_tensor(rng.normal(size=(c, d)).astype(np.float32),
                         device=dev)
    cs[1] = cs[c - 1]                          # exact tie, smaller index
    jitter = rng.normal(size=(5, d)).astype(np.float32) * 0.01
    xs = torch.cat([cs[c - 1] + torch.as_tensor(jitter, device=dev),
                    torch.as_tensor(rng.normal(size=(n, d))
                                    .astype(np.float32), device=dev)])
    aux = (cs * cs).sum(1)
    aux[0] += 3.0e38                           # an invalid centroid
    ak, mk = ka.kmeans_assign(xs, cs, aux)
    ap, mp = ka.kmeans_assign_plain(xs, cs, aux)
    torch.cuda.synchronize()
    assert (ak[:5] == 1).all() and (ak != 0).all()
    np.testing.assert_allclose(mk.cpu().numpy(), mp.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    assert (ak == ap).float().mean().item() > 0.99


@pytest.mark.parametrize("n,c,d", [(10_000, 1000, 128), (333, 1001, 200),
                                   (129, 257, 7)])
def test_kmeans_assign_ties_across_tiles_and_splits(dev, monkeypatch, n, c,
                                                    d):
    """N and C off the 128 tiles; an exact tie between centroid 3 and
    centroid c - 2 (another centroid tile, and another split whenever the
    tiles are split) goes to 3, with one split and with one split a tile;
    with every centroid masked every point gets -1 and MASK_DIST."""
    rng = np.random.default_rng(n + c + d)
    cs = torch.as_tensor(rng.normal(size=(c, d)).astype(np.float32),
                         device=dev)
    cs[3] = cs[c - 2]
    xs = torch.as_tensor(rng.normal(size=(n, d)).astype(np.float32),
                         device=dev)
    xs[:7] = cs[3] + torch.as_tensor(
        rng.normal(size=(7, d)).astype(np.float32) * 0.01, device=dev)
    aux = (cs * cs).sum(1)
    ap, mp = ka.kmeans_assign_plain(xs, cs, aux)
    tiles = -(-c // ka.TILE)
    runs = {}
    for per in (None, 1, tiles):    # the wrapper's split, most, none
        if per is not None:
            monkeypatch.setattr(ka, "_tiles_per_split",
                                lambda *_, p=per: (p, -(-tiles // p)))
        runs[per] = ka.kmeans_assign(xs, cs, aux)
    torch.cuda.synchronize()
    ak, mk = runs[None]
    assert (ak[:7] == 3).all() and (ap[:7] == 3).all()
    assert (ak == ap).float().mean().item() > 0.99
    np.testing.assert_allclose(mk.cpu().numpy(), mp.cpu().numpy(),
                               rtol=RTOL, atol=ATOL)
    for a, m in runs.values():      # the split does not change the answer
        assert torch.equal(a, ak) and torch.equal(m, mk)
    masked = aux + ref.MASK_DIST
    am, mm = ka.kmeans_assign(xs, cs, masked)
    torch.cuda.synchronize()
    assert (am == -1).all() and (mm == ref.MASK_DIST).all()


def test_wrappers_raise_on_operands_the_kernels_do_not_take(dev):
    q = torch.zeros(2, 8, device=dev)
    data = torch.zeros(3, 16, 8, device=dev)
    valid = torch.ones(3, 16, dtype=torch.bool, device=dev)
    sel = torch.arange(3, dtype=torch.int32, device=dev)
    qmask = torch.ones(2, 3, dtype=torch.bool, device=dev)
    with pytest.raises(ValueError):                # not a power of two
        sti.scan_topk_indexed(q, data, valid, sel, qmask, k_pad=3000)
    with pytest.raises(ValueError, match="K_MAX"):  # past the limit
        sti.scan_topk_indexed(q, data, valid, sel, qmask,
                              k_pad=2 * sti.K_MAX)
    with pytest.raises(ValueError):
        sti.scan_topk_indexed(q, data, valid, sel.long(), qmask, k_pad=8)
    with pytest.raises(ValueError):
        sti.scan_topk_indexed(q.half(), data.half(), valid, sel, qmask,
                              k_pad=8)
    with pytest.raises(ValueError):
        st.scan_topk(q, data[0].t(), k_pad=8)
    with pytest.raises(ValueError):
        ka.kmeans_assign(q, data[0], torch.zeros(16, device=dev).double())


def test_ops_on_the_card_match_the_cpu(dev):
    rng = np.random.default_rng(9)
    qs = rng.normal(size=(30, 16)).astype(np.float32)
    xs = rng.normal(size=(500, 16)).astype(np.float32)
    dc, ic = ops.scan_topk(torch.as_tensor(qs), torch.as_tensor(xs), 20)
    dg, ig = ops.scan_topk(torch.as_tensor(qs, device=dev),
                           torch.as_tensor(xs, device=dev), 20)
    _same_topk(dg, ig, dc.to(dev), ic.to(dev))
    ac, mc = ops.kmeans_assign(torch.as_tensor(xs), torch.as_tensor(qs))
    ag, mg = ops.kmeans_assign(torch.as_tensor(xs, device=dev),
                               torch.as_tensor(qs, device=dev))
    assert (ag.cpu() == ac).float().mean().item() > 0.99
    np.testing.assert_allclose(mg.cpu().numpy(), mc.numpy(), rtol=RTOL,
                               atol=ATOL)


def test_per_query_search_on_the_card_launches_the_scan_kernel(dev):
    """``QuakeIndex.search`` on a CUDA index scans through the kernel by
    default: one ``scan_topk`` launch per partition it scans."""
    ds = datasets.clustered(3000, 16, n_clusters=16, seed=0)
    cpu = QuakeIndex.build(ds.vectors, num_partitions=30, kmeans_iters=4,
                           device="cpu")
    gpu = index_from_arrays(index_to_arrays(cpu), device=dev)
    assert gpu.config.scan_impl == "auto"
    for qi in datasets.queries_near(ds, 4, seed=9):
        before = st.LAUNCHES.count
        rg = gpu.search(qi, 10, nprobe=4, record_stats=False)
        assert st.LAUNCHES.count - before == sum(rg.nprobe.values())
        rc = cpu.search(qi, 10, nprobe=4, record_stats=False)
        assert rg.nprobe == rc.nprobe
        assert len(set(rg.ids.tolist()) & set(rc.ids.tolist())) >= 9


def test_main_path_on_the_card_matches_cpu(dev):
    ds = datasets.clustered(4000, 16, n_clusters=16, seed=0)
    q = datasets.queries_near(ds, 48, seed=3)
    cpu = QuakeIndex.build(ds.vectors, num_partitions=32, kmeans_iters=4,
                           device="cpu")
    state = index_to_arrays(cpu)
    gpu = index_from_arrays(state, device=dev)
    host_planned = {}

    def on_host_planner(kw):
        """The card's search on the CPU's planner, the host one."""
        kw = dict(kw)
        dtype = kw.pop("storage_dtype", "f32")
        if dtype not in host_planned:
            host_planned[dtype] = mq.BatchedSearchExecutor(
                gpu, storage_dtype=dtype, planner="vectorized")
        return host_planned[dtype].search(q, 10, **kw)

    for kw in (dict(nprobe=6), dict(), dict(rounds=1),
               dict(storage_dtype="bf16")):
        # the CPU kernel path (plain versions) computes what the kernels
        # do; bf16 queries ride in bf16 there, not in the torch oracle
        rc = cpu.search_batch(q, 10, impl="cuda", **kw)
        rg = on_host_planner(kw)
        assert np.mean(rc.ids == rg.ids) >= 0.99
        np.testing.assert_array_equal(rc.nprobe, rg.nprobe)
        # the card's default planner, the fused one: its centroid pass
        # is the kernel, so it matches up to matmul rounding
        rd = gpu.search_batch(q, 10, **kw)
        assert np.mean(rd.nprobe == rc.nprobe) >= 0.95
        assert np.mean(rd.ids == rc.ids) >= 0.95
    before = st.LAUNCHES.count
    rf = mq.BatchedSearchExecutor(gpu, planner="fused").search(q, 10)
    assert st.LAUNCHES.count > before
    assert np.mean(rf.ids == cpu.search_batch(q, 10).ids) >= 0.95
    before = ka.LAUNCHES.count
    big = int(np.argmax(cpu.levels[0].sizes()))
    new = cpu.levels[0].vectors[big][:40] + 0.01   # one partition's topic
    gpu.insert(new, np.arange(9000, 9040))
    cpu.insert(new, np.arange(9000, 9040))
    assert ka.LAUNCHES.count == before + 1          # routing on the card
    gpu.check_invariants()
    assert gpu.id_map == cpu.id_map
    ex = mq.get_executor(gpu)
    assert ex.planner == "fused"
    rc = cpu.search_batch(q, 10)
    rg = on_host_planner({})
    assert host_planned["f32"].delta_refreshes == 1
    assert np.mean(rg.ids == rc.ids) >= 0.99
    rd = gpu.search_batch(q, 10)
    assert ex.delta_refreshes == 1
    assert np.mean(rd.ids == rc.ids) >= 0.95
    built = QuakeIndex.build(ds.vectors, num_partitions=32, kmeans_iters=4,
                             device=dev)
    built.check_invariants()


def _exact_recall(ids, want) -> float:
    return float(np.mean([len(set(a[a >= 0].tolist()) & set(b.tolist()))
                          / want.shape[1] for a, b in zip(ids, want)]))


def test_default_executor_on_the_card_plans_there(dev):
    """A card index's executors plan on the card when no planner is
    named: the centroid pass is the ``scan_topk`` kernel, once a batch,
    and recall against exact k-NN is the host planner's within 0.005."""
    ds = datasets.clustered(20000, 32, n_clusters=64, seed=4)
    q = datasets.queries_near(ds, 512, seed=5)
    gpu = QuakeIndex.build(ds.vectors, num_partitions=64, kmeans_iters=4,
                           device=dev)
    assert mq.get_executor(gpu).planner == "fused"
    assert mq.get_executor(gpu, "bf16").planner == "fused"
    host = mq.BatchedSearchExecutor(gpu, planner="vectorized")
    want = ds.ground_truth(q, 10)              # ids are the row numbers
    for kw in (dict(), dict(nprobe=8, rounds=1)):
        gpu.search_batch(q, 10, **kw)           # snapshot, radius, operands
        before = st.LAUNCHES.count
        rd = gpu.search_batch(q, 10, **kw)
        assert st.LAUNCHES.count - before == 1
        before = st.LAUNCHES.count
        rv = host.search(q, 10, **kw)
        assert st.LAUNCHES.count == before
        rec_d = _exact_recall(rd.ids, want)
        rec_v = _exact_recall(rv.ids, want)
        assert abs(rec_d - rec_v) <= 0.005, (kw, rec_d, rec_v)
        assert rec_v >= 0.5


@pytest.mark.parametrize("planner", ["fused", "vectorized"])
def test_host_waits_on_the_card_follow_the_copy_sites(dev, planner):
    """The copies the host blocks on, as the CPU tests count them: APS
    2 x rounds + 4 on either planner; a pinned ``nprobe`` 6 on the fused
    planner (the queries once, the union width with the anchors, the two
    mirror pulls, two result pulls) and 8 on the host one."""
    from repro_torch.obs import tracing
    ds = datasets.clustered(8000, 16, n_clusters=32, seed=6)
    q = datasets.queries_near(ds, 64, seed=7)
    gpu = QuakeIndex.build(ds.vectors, num_partitions=40, kmeans_iters=4,
                           device=dev)
    ex = mq.BatchedSearchExecutor(gpu, planner=planner)
    for kw, want in ((dict(), None),
                     (dict(nprobe=6, rounds=1),
                      6 if planner == "fused" else 8)):
        ex.search(q, 10, **kw)
        before = tracing.program_totals()
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            r = ex.search(q, 10, **kw)
        after = tracing.program_totals()
        waits = after["quake.wait.count"] - before.get("quake.wait.count", 0)
        on_card = after.get("quake.plan.on_card.count", 0) \
            - before.get("quake.plan.on_card.count", 0)
        assert waits == (2 * r.rounds + 4 if want is None else want)
        assert on_card == (planner == "fused")


# ---------------------------------------------------------------------------
# int8: the q8 kernel, the int8 executor, maintenance on a CUDA index
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("p,s,d,b,u,k_pad", [
    (40, 96, 32, 37, 17, 64),     # typical, B not a tile multiple
    (9, 40, 4, 1, 9, 1),          # one word a row, one query, k_pad 1
    (20, 300, 132, 13, 11, 1024),  # wide rows, the largest k_pad
    (64, 64, 16, 64, 64, 256),    # union = all partitions, k_pad 256
])
def test_scan_topk_indexed_q8_matches_plain(dev, metric, p, s, d, b, u,
                                            k_pad):
    """The q8 kernel against its plain version on the same operands.
    The int8 products are exact and the dequantization runs in the
    reference's order with round-to-nearest intrinsics, so the distances
    agree to rtol 1e-4 / atol 1e-3 (in practice bit for bit)."""
    rng = np.random.default_rng(p + s + d)
    cents = torch.as_tensor(rng.normal(size=(p, d)).astype(np.float32) * 4,
                            device=dev)
    data = cents[:, None, :] + torch.as_tensor(
        rng.normal(size=(p, s, d)).astype(np.float32), device=dev)
    codes, scales = sti.quantize_int8_residual(data, cents)
    valid = torch.as_tensor(rng.random((p, s)) < 0.8, device=dev)
    valid[1] = False                           # an empty partition
    valid[2, s // 2:] = False                  # a short one
    sel = torch.as_tensor(rng.choice(p, u, replace=False).astype(np.int32),
                          device=dev)
    qmask = torch.as_tensor(rng.random((b, u)) < 0.5, device=dev)
    q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32),
                        device=dev) * 4
    q_codes, q_scales, aux, qc = ref.q8_scan_operands(
        q, codes, scales, valid, sel, metric, cents)
    args = (q_codes, q_scales, codes, scales, aux, qc, valid, sel, qmask)
    before = sti.LAUNCHES_Q8.count
    dk, ik = sti.scan_topk_indexed_q8(*args, k_pad=k_pad, metric=metric)
    assert sti.LAUNCHES_Q8.count == before + 1
    dp, ip_ = sti.scan_topk_indexed_q8_plain(*args, k_pad=k_pad,
                                             metric=metric)
    _same_topk(dk, ik, dp, ip_)
    with pytest.raises(ValueError):            # d not a multiple of 4
        sti.scan_topk_indexed_q8(q_codes[:, :-1].contiguous(), q_scales,
                                 codes[:, :, :-1].contiguous(), *args[3:],
                                 k_pad=k_pad, metric=metric)


def _q8_case(dev, p, s, d, b, u, seed):
    """IVF-residual int8 operands of the q8 scan for random data."""
    rng = np.random.default_rng(seed)
    cents = torch.as_tensor(rng.normal(size=(p, d)).astype(np.float32) * 4,
                            device=dev)
    data = cents[:, None, :] + torch.as_tensor(
        rng.normal(size=(p, s, d)).astype(np.float32), device=dev)
    codes, scales = sti.quantize_int8_residual(data, cents)
    valid = torch.as_tensor(rng.random((p, s)) < 0.9, device=dev)
    q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32),
                        device=dev) * 4
    return q, cents, codes, scales, valid


# ---------------------------------------------------------------------------
# k past 1024 on the card, and reproducible k-means
# ---------------------------------------------------------------------------

def test_scan_topk_k1025_on_the_card(dev):
    """q (1, 8) against x (1025, 8) at k = 1025 returns (1, 1025) from the
    kernel (k_pad 2048, past the old limit of 1024)."""
    rng = np.random.default_rng(0)
    q = torch.as_tensor(rng.normal(size=(1, 8)).astype(np.float32),
                        device=dev)
    x = torch.as_tensor(rng.normal(size=(1025, 8)).astype(np.float32),
                        device=dev)
    before = st.LAUNCHES.count
    d, i = ops.scan_topk(q, x, 1025)
    assert st.LAUNCHES.count == before + 1
    assert tuple(d.shape) == (1, 1025) and tuple(i.shape) == (1, 1025)
    dp, ip_ = ops.scan_topk(q.cpu(), x.cpu(), 1025, impl="cuda")
    _same_topk(d, i, dp.to(dev), ip_.to(dev))


@pytest.mark.parametrize("k", [1025, 3000, 9000])
def test_ops_return_k_columns_past_1024_on_the_card(dev, k):
    """ops.scan_topk, scan_selected_topk and scan_selected_topk_q8 at
    k = 1025 (k_pad 2048), k = 3000 (k_pad 4096) and k = 9000 (k_pad
    16384 = K_MAX, over more rows than that): k columns from the kernels,
    matching the plain versions."""
    rng = np.random.default_rng(k)
    n, s = max(3500, k + 1000), max(700, k // 8 + 200)
    assert ops._next_pow2(min(k, n, 8 * s)) <= st.K_MAX == sti.K_MAX
    q = torch.as_tensor(rng.normal(size=(20, 16)).astype(np.float32),
                        device=dev)
    x = torch.as_tensor(rng.normal(size=(n, 16)).astype(np.float32),
                        device=dev)
    before = st.LAUNCHES.count
    d, i = ops.scan_topk(q, x, k)
    assert st.LAUNCHES.count == before + 1 and tuple(i.shape) == (20, k)
    _same_topk(d, i, *(t.to(dev) for t in ops.scan_topk(
        q.cpu(), x.cpu(), k, impl="cuda")))

    p, b, u = 12, 20, 8
    data = torch.as_tensor(rng.normal(size=(p, s, 16)).astype(np.float32),
                           device=dev)
    valid = torch.as_tensor(rng.random((p, s)) < 0.9, device=dev)
    sel = torch.as_tensor(rng.choice(p, u, replace=False).astype(np.int32),
                          device=dev)
    qmask = torch.as_tensor(rng.random((b, u)) < 0.7, device=dev)
    qmask[:, 0] = True
    before = sti.LAUNCHES.count
    d, i = ops.scan_selected_topk(q, data, valid, sel, qmask, k)
    assert sti.LAUNCHES.count == before + 1 and tuple(i.shape) == (b, k)
    _same_topk(d, i, *(t.to(dev) for t in ops.scan_selected_topk(
        q.cpu(), data.cpu(), valid.cpu(), sel.cpu(), qmask.cpu(), k,
        impl="cuda")))

    q8, cents, codes, scales, valid8 = _q8_case(dev, p, s, 16, b, u, k)
    before = sti.LAUNCHES_Q8.count
    d, i = ops.scan_selected_topk_q8(q8, codes, scales, valid8, sel, qmask,
                                     k, centroids=cents)
    assert sti.LAUNCHES_Q8.count == before + 1 and tuple(i.shape) == (b, k)
    _same_topk(d, i, *(t.to(dev) for t in ops.scan_selected_topk_q8(
        q8.cpu(), codes.cpu(), scales.cpu(), valid8.cpu(), sel.cpu(),
        qmask.cpu(), k, centroids=cents.cpu(), impl="cuda")))


def test_kmeans_on_the_card_is_reproducible(dev):
    """Two builds at seed 0 (20,000 x 128, k = 64) give bit-equal
    centroids and equal assignments: the cluster sums are taken in a
    fixed order."""
    from repro_torch.core import kmeans
    x = datasets.clustered(20_000, 128, n_clusters=64, seed=0).vectors
    c1, a1 = kmeans.kmeans(x, 64, seed=0, device=dev)
    c2, a2 = kmeans.kmeans(x, 64, seed=0, device=dev)
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(a1, a2)


# ---------------------------------------------------------------------------
# the grouped driver of the indexed scans
# ---------------------------------------------------------------------------

def _grouped_qmask(rng, b, u, qt=sti.QT):
    """A mask with a slot no query probes, one every query probes, and
    slots probed by qt - 1, qt, qt + 1, 2 qt - 1, 2 qt and 2 qt + 1
    queries (all of them where b is smaller)."""
    qmask = rng.random((b, u)) < 0.2
    qmask[:, 0] = False
    qmask[:, 1] = True
    for col, n in zip(range(2, u), (qt - 1, qt, qt + 1, 2 * qt - 1, 2 * qt,
                                    2 * qt + 1)):
        qmask[:, col] = False
        qmask[rng.permutation(b)[:n], col] = True
    return qmask


@pytest.mark.parametrize("qt", [sti.QT, sti.QW])
@pytest.mark.parametrize("uc", [None, 4])
@pytest.mark.parametrize("b,u", [(1, 9), (40, 9), (70, 12), (1500, 1100)])
def test_group_queries_kernel_matches_plain(dev, b, u, uc, qt):
    """The grouping kernels against their plain version, exactly, with
    the slots in the kernels' order (longest partitions first within each
    chunk of ``uc`` slots), in tiles of either design's width; B and U
    past one pass of either kernel."""
    rng = np.random.default_rng(b * 100 + u)
    qmask = torch.as_tensor(_grouped_qmask(rng, b, u, qt), device=dev)
    sel = torch.as_tensor(rng.permutation(u).astype(np.int32), device=dev)
    nrows = torch.as_tensor(rng.integers(0, 50, size=u).astype(np.int32),
                            device=dev)
    order = sti.slot_order(sel, nrows, u if uc is None else uc)
    got = sti.group_queries_cuda(qmask, order, uc, qt)
    want = sti.group_queries_plain(qmask, order, uc, qt)
    torch.cuda.synchronize()
    for name, t in want.items():
        assert torch.equal(got[name], t), name


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("kind", ["f32", "bf16", "q8"])
@pytest.mark.parametrize("b,k_pad", [(1, 16), (40, 64), (70, 256)])
def test_grouped_driver_edge_cases_match_plain(dev, kind, metric, b, k_pad):
    """Slots probed by no query, by every query, and by counts around
    multiples of the query tile; B = 1 too.  Rows of d = 32 (16-byte
    copies) over partitions of up to 300 rows (several row stages)."""
    rng = np.random.default_rng(b + k_pad)
    p, s, d, u = 14, 300, 32, 9
    qmask = torch.as_tensor(_grouped_qmask(rng, b, u), device=dev)
    sel = torch.as_tensor(rng.choice(p, u, replace=False).astype(np.int32),
                          device=dev)
    if kind == "q8":
        q, cents, codes, scales, valid = _q8_case(dev, p, s, d, b, u, b)
        valid[sel[3].long(), 100:] = False         # a short partition
        q_codes, q_scales, aux, qc = ref.q8_scan_operands(
            q, codes, scales, valid, sel, metric, cents)
        args = (q_codes, q_scales, codes, scales, aux, qc, valid, sel, qmask)
        before = sti.LAUNCHES_Q8.count
        dk, ik = sti.scan_topk_indexed_q8(*args, k_pad=k_pad, metric=metric)
        assert sti.LAUNCHES_Q8.count == before + 1
        dp, ip_ = sti.scan_topk_indexed_q8_plain(*args, k_pad=k_pad,
                                                 metric=metric)
        torch.cuda.synchronize()
        assert torch.equal(dk, dp)                 # bit for bit
    else:
        dtype = torch.float32 if kind == "f32" else torch.bfloat16
        data = torch.as_tensor(rng.normal(size=(p, s, d)).astype(np.float32),
                               device=dev).to(dtype)
        valid = torch.as_tensor(rng.random((p, s)) < 0.9, device=dev)
        valid[sel[3].long(), 100:] = False         # a short partition
        q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32),
                            device=dev).to(dtype)
        before = sti.LAUNCHES.count
        dk, ik = sti.scan_topk_indexed(q, data, valid, sel, qmask,
                                       k_pad=k_pad, metric=metric)
        assert sti.LAUNCHES.count == before + 1
        dp, ip_ = sti.scan_topk_indexed_plain(q, data, valid, sel, qmask,
                                              k_pad=k_pad, metric=metric)
    _same_topk(dk, ik, dp, ip_)


@pytest.mark.parametrize("kind,d,k_pad", [
    ("f32", 960, 256), ("bf16", 960, 256),    # GIST-960's width
    ("f32", 1892, 256), ("bf16", 1888, 256),  # the widest whole queries
    ("q8", 256, 256), ("q8", 768, 256),
    ("q8", 1036, 256),        # the widest the plain version sums in f32
    ("f32", 130, 1024), ("q8", 132, 1024),    # buffers in global memory
    # past those widths the queries are staged a column chunk a stage
    ("f32", 1893, 256), ("bf16", 1893, 256),  # no 16-byte vectors
    ("f32", 3072, 256), ("bf16", 3072, 256),  # text-embedding-3-large
    ("f32", 4096, 256), ("bf16", 4096, 256),  # e5-mistral-7b
    ("f32", 3072, 1024), ("bf16", 4096, 16),  # buffers global, shared
    ("q8", 4836, 256), ("q8", 8192, 256), ("q8", 8192, 1024),
])
def test_grouped_driver_wide_rows_match_plain(dev, kind, d, k_pad):
    """Wide rows, staged in column chunks, with the top-K buffers in
    shared or global memory and the tile's queries whole or in column
    chunks as the block's shared memory allows, against the plain
    versions (q8 bit for bit)."""
    rng = np.random.default_rng(d + k_pad)
    p, s, b, u = 8, 150, 37, 6
    sel = torch.as_tensor(rng.choice(p, u, replace=False).astype(np.int32),
                          device=dev)
    qmask = torch.as_tensor(_grouped_qmask(rng, b, u), device=dev)
    if kind == "q8":
        q, cents, codes, scales, valid = _q8_case(dev, p, s, d, b, u, d)
        q_codes, q_scales, aux, qc = ref.q8_scan_operands(
            q, codes, scales, valid, sel, "l2", cents)
        args = (q_codes, q_scales, codes, scales, aux, qc, valid, sel, qmask)
        dk, ik = sti.scan_topk_indexed_q8(*args, k_pad=k_pad)
        dp, ip_ = sti.scan_topk_indexed_q8_plain(*args, k_pad=k_pad)
        torch.cuda.synchronize()
        assert torch.equal(dk, dp)                 # bit for bit
    else:
        dtype = torch.float32 if kind == "f32" else torch.bfloat16
        data = torch.as_tensor(rng.normal(size=(p, s, d)).astype(np.float32),
                               device=dev).to(dtype)
        valid = torch.as_tensor(rng.random((p, s)) < 0.9, device=dev)
        q = torch.as_tensor(rng.normal(size=(b, d)).astype(np.float32),
                            device=dev).to(dtype)
        dk, ik = sti.scan_topk_indexed(q, data, valid, sel, qmask,
                                       k_pad=k_pad)
        dp, ip_ = sti.scan_topk_indexed_plain(q, data, valid, sel, qmask,
                                              k_pad=k_pad)
    _same_topk(dk, ik, dp, ip_)


def test_grouped_driver_width_limits_on_the_card(dev):
    """How a block of the row-per-thread design lays out its shared
    memory (0 top-K buffers in shared memory, ``GLOBAL_BUFS`` in global,
    ``| QUERY_CHUNKS`` the queries by column chunks) at the widths the
    docs name: today's layouts wherever whole queries fit, query chunks
    only past that, and a layout at every width (the old 2, "too wide",
    never comes back).  Given the tiled design (``TILED``, f32 rows
    only), the library lays out its block at every width: ``TILED``,
    with ``GLOBAL_BUFS`` past k_pad 128."""
    at = torch.cuda.current_device()
    g, c, t = sti.GLOBAL_BUFS, sti.QUERY_CHUNKS, sti.TILED

    def rows(kind, d, k_pad):           # the row-per-thread design's
        return sti._placement(kind, d, k_pad, at)
    assert sti._placement("f32", 128, 128, at) == 0     # the main path
    assert sti._placement("q8", 128, 256, at) == 0      # the int8 path
    assert rows("f32", 868, 256) == 0
    assert rows("f32", 872, 256) == g
    assert sti._placement("q8", 736, 256, at) == 0
    assert sti._placement("q8", 740, 256, at) == g
    assert sti._placement("f32", 128, 512, at) == g     # buffers > 64 KB
    assert rows("f32", 1892, sti.K_MAX) == g
    assert sti._placement("bf16", 1888, 16, at) == g
    assert sti._placement("q8", 4832, 16, at) == g
    assert rows("f32", 1896, 16) == c
    assert sti._placement("bf16", 1896, 16, at) == c
    assert sti._placement("q8", 4836, 16, at) == c
    assert rows("f32", 3072, sti.K_MAX) == g | c
    assert sti._placement("f32", sti.TILED_MIN_D, 128, at, t) == t
    assert sti._placement("f32", 3072, 128, at, t) == t  # the wide cell
    assert sti._placement("f32", 3072, 256, at, t) == t | g
    for kind in ("f32", "bf16", "q8"):
        for k_pad in (16, 256, 1024, sti.K_MAX):
            got = {sti._placement(kind, d, k_pad, at)
                   for d in range(4, 16385, 4)}
            assert got <= {0, g, c, g | c}, (kind, k_pad, got)
            if kind == "f32":
                got = {sti._placement(kind, d, k_pad, at, t)
                       for d in range(4, 16385, 4)}
                assert got == {t if k_pad <= 128 else t | g}, (k_pad, got)
    # the widths that used to raise now run
    data = torch.zeros((2, 8, 1896), device=dev)
    valid = torch.ones((2, 8), dtype=torch.bool, device=dev)
    sel = torch.arange(2, dtype=torch.int32, device=dev)
    qmask = torch.ones((3, 2), dtype=torch.bool, device=dev)
    dk, ik = sti.scan_topk_indexed(data[0, :3].contiguous(), data, valid,
                                   sel, qmask, k_pad=16)
    torch.cuda.synchronize()
    assert torch.equal(dk, torch.zeros_like(dk))
    assert torch.equal(ik, torch.arange(16, dtype=torch.int32,
                                        device=dev).expand(3, 16))


def _tiled_case(dev, d, dtype, seed):
    """Operands of an indexed scan whose distances are exact in f32 in
    any order: rows and queries of small integers, 40 distinct rows
    repeated over 10 partitions of 300 slots (exact ties within and
    across partitions), an empty partition, a short one and invalid rows
    elsewhere, and 8 union slots probed by 0, 1, 63, 64, 65, every one
    of 130 queries, 30% and 129 of them."""
    rng = np.random.default_rng(seed)
    p, s, b = 10, 300, 130
    base = rng.integers(-3, 4, size=(40, d)).astype(np.float32)
    data = torch.as_tensor(base[rng.integers(0, 40, (p, s))], device=dev)
    valid = torch.as_tensor(rng.random((p, s)) < 0.9, device=dev)
    sel = torch.as_tensor(rng.permutation(p)[:8].astype(np.int32),
                          device=dev)
    valid[sel[2].long()] = False                 # empty, 63 queries
    valid[sel[4].long(), 200:] = False           # short, 65 queries
    qmask = np.zeros((b, 8), bool)
    for col, n in enumerate((0, 1, 63, 64, 65, b)):
        qmask[rng.permutation(b)[:n], col] = True
    qmask[:, 6] = rng.random(b) < 0.3
    qmask[rng.permutation(b)[:129], 7] = True
    q = torch.as_tensor(rng.integers(-3, 4, size=(b, d)),
                        dtype=torch.float32, device=dev)
    return (q.to(dtype), data.to(dtype), valid, sel,
            torch.as_tensor(qmask, device=dev))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("k_pad", [128, 1024])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("width", ["min-4", "min", 3070, 3072])
def test_tiled_scan_matches_plain(dev, width, metric, k_pad, dtype):
    """The indexed scan of f32 and bf16 rows on either side of
    ``TILED_MIN_D`` and at the wide cell's width (3,070: no 16-byte
    copies), against the plain version bit for bit: integer rows (exact
    in bf16 too) make every distance exact, so equal distances must keep
    the smaller flat index.  ``design`` takes the register-tiled design
    for the 130 queries' call on f32 rows of ``TILED_MIN_D`` and wider,
    a multiple of 4 (top-K buffers in shared memory at k_pad 128, global
    past it), the row-per-thread design for the rest, and for the first
    ``TILED_MIN_B - 1`` queries alone."""
    d = {"min-4": sti.TILED_MIN_D - 4, "min": sti.TILED_MIN_D}.get(width,
                                                                   width)
    torch.backends.cuda.matmul.allow_tf32 = False
    q, data, valid, sel, qmask = _tiled_case(dev, d, dtype, d + k_pad)
    few = sti.TILED_MIN_B - 1
    for args, tiled in (
            ((q, data, valid, sel, qmask), dtype == torch.float32
             and d >= sti.TILED_MIN_D and d % 4 == 0),
            ((q[:few].contiguous(), data, valid, sel,
              qmask[:few].contiguous()), False)):
        before = sti.LAUNCHES_TILED.count
        dk, ik = sti.scan_topk_indexed(*args, k_pad=k_pad, metric=metric)
        assert sti.LAUNCHES_TILED.count - before == int(tiled)
        dp, ip_ = sti.scan_topk_indexed_plain(*args, k_pad=k_pad,
                                              metric=metric)
        torch.cuda.synchronize()
        assert torch.equal(dk, dp) and torch.equal(ik, ip_)


@pytest.mark.parametrize("kind", ["f32", "bf16"])
def test_tiled_placement_agrees_with_meta(dev, kind):
    """The library's top-K buffers for the design ``design`` picks, and
    ``meta_placement`` (its mirror for calls on meta tensors), agree at
    the widths around the crossover and at the wide cell's, at k_pad in
    shared and in global memory, in calls of 1,024 queries and of one."""
    at = torch.cuda.current_device()
    dtype = torch.bfloat16 if kind == "bf16" else torch.float32
    data = torch.zeros((1, 1, 4096), dtype=dtype, device=dev)
    for d in (128, sti.TILED_MIN_D - 4, sti.TILED_MIN_D, 3070, 3072, 4096):
        rows = data[..., :d].contiguous()
        for b in (1, 1024):
            tiled = sti.design(torch.zeros((b, d), dtype=dtype,
                                           device=dev), rows)
            assert tiled == (sti.TILED if kind == "f32"
                             and b >= sti.TILED_MIN_B
                             and d >= sti.TILED_MIN_D and d % 4 == 0
                             else 0), (d, b)
            for k_pad in (16, 128, 256, 1024):
                got = sti._placement(kind, d, k_pad, at, tiled)
                want = sti.meta_placement(k_pad, tiled)
                assert got & (sti.TILED | sti.GLOBAL_BUFS) == want, (
                    d, b, k_pad)


def _wide_skewed(n, d, seed):
    """Rows of 24 Gaussian clusters whose sizes fall as 1 / i."""
    rng = np.random.default_rng(seed)
    centers = rng.normal(0, 3.0, (24, d))
    w = 1.0 / np.arange(1, 25)
    pick = rng.choice(24, size=n, p=w / w.sum())
    return (centers[pick] + rng.normal(0, 1.0, (n, d))).astype(np.float32)


def _near(a, b, q, x, ids):
    """|a - b| within 1e-5 of ||q||^2 + ||x||^2: at d = 3,072 the
    expanded form's rounding grows with the norms (the benchmark's
    ``dist_gap`` is normalised the same way)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    q2 = np.sum(np.asarray(q, np.float64) ** 2, axis=1)[:, None]
    x2 = np.sum(np.asarray(x, np.float64) ** 2, axis=1)[np.maximum(ids, 0)]
    miss = np.isinf(b)                 # fewer rows probed than k
    np.testing.assert_array_equal(np.isinf(a), miss)
    assert np.all(np.abs(a[~miss] - b[~miss]) <= 1e-5 * (q2 + x2)[~miss])


def _paged_executor(idx, **kw):
    """An executor whose snapshot has pages of 64 slots."""
    return mq.BatchedSearchExecutor(idx, page_size=64, **kw)


@pytest.fixture(scope="module")
def wide_pair():
    """A 3,072-wide index on the CPU and its copy on the card: skewed
    partitions that span several 64-row pages."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    x = _wide_skewed(4000, 3072, 8)
    cpu = QuakeIndex.build(x, num_partitions=20, kmeans_iters=4,
                           device="cpu")
    gpu = index_from_arrays(index_to_arrays(cpu), device="cuda")
    q = (x[np.random.default_rng(9).integers(0, len(x), 200)]
         + 0.05 * np.random.default_rng(10).normal(size=(200, 3072))
         ).astype(np.float32)
    return x, cpu, gpu, q


@pytest.mark.parametrize("design", ["tiled", "rows"])
@pytest.mark.parametrize("mode", [dict(nprobe=6, rounds=1), dict()],
                         ids=["nprobe", "aps"])
def test_paged_search_batch_at_3072_matches_the_plain_path(
        dev, wide_pair, mode, design, monkeypatch):
    """``search_batch`` over 64-row pages at d = 3,072, on the design
    ``design`` picks for its 200 queries (the register-tiled scan) and on
    the row-per-thread design it replaced (whose queries go in column
    chunks): the card's kernels answer as the plain path on the CPU over
    the same pages and plans."""
    x, cpu, gpu, q = wide_pair
    ex_c, ex_g = (_paged_executor(i, planner="vectorized")
                  for i in (cpu, gpu))
    at = dev.index or 0
    if design == "rows":
        monkeypatch.setattr(sti, "design", lambda *a: 0)
        assert sti._placement("f32", 3072, 128, at) & sti.QUERY_CHUNKS
    else:
        assert len(q) >= sti.TILED_MIN_B
    before = sti.LAUNCHES.count
    tiled = sti.LAUNCHES_TILED.count
    rg, rc = ex_g.search(q, 100, **mode), ex_c.search(q, 100, **mode)
    assert sti.LAUNCHES.count - before == rg.rounds
    assert sti.LAUNCHES_TILED.count - tiled == (
        rg.rounds if design == "tiled" else 0)
    assert not ex_g._snap.dense and ex_g._snap.num_pages > 20
    assert rg.rounds == rc.rounds and rg.comparisons == rc.comparisons
    _near(rg.dists, rc.dists, q, x, rc.ids)
    assert _recall(torch.as_tensor(rg.ids), torch.as_tensor(rc.ids)) \
        >= 0.999


def test_paged_default_executor_at_3072_is_exact_at_every_probe(dev,
                                                                wide_pair):
    """The default card executor (the fused planner: the centroid pass at
    d = 3,072 is the ``scan_topk`` kernel) over pages, every partition
    probed: exact k-NN."""
    x, _, gpu, q = wide_pair
    r = _paged_executor(gpu).search(q, 50, nprobe=gpu.num_partitions,
                                    rounds=1)
    xs = torch.as_tensor(x, device=dev)
    qs = torch.as_tensor(q, device=dev)
    torch.backends.cuda.matmul.allow_tf32 = False
    d = ((qs * qs).sum(1, keepdim=True) + (xs * xs).sum(1)[None, :]
         - 2.0 * qs @ xs.T)
    want_d, want_i = torch.topk(d, 50, dim=1, largest=False)
    _near(r.dists, want_d.cpu().numpy(), q, x, want_i.cpu().numpy())
    assert _exact_recall(r.ids, want_i.cpu().numpy()) >= 0.999


def test_wide_build_on_the_card(dev):
    """The build at d = 3,072 on the card: ``kmeans_assign`` agrees with
    its plain version, and the Lloyd build keeps every partition alive
    and every row."""
    x = _wide_skewed(6000, 3072, 11)
    xs = torch.as_tensor(x, device=dev)
    cs = xs[::97].contiguous()
    ak, mk = ops.kmeans_assign(xs, cs, impl="cuda")
    ap, mp = ops.kmeans_assign(xs, cs, impl="torch")
    assert (ak.long() == ap.long()).float().mean().item() > 0.999
    c2 = (cs * cs).sum(1).double().cpu().numpy()
    x2 = np.sum(x.astype(np.float64) ** 2, axis=1)
    assert np.all(np.abs(mk.cpu().numpy() - mp.cpu().numpy().astype(
        np.float64)) <= 1e-5 * (x2 + c2[ap.long().cpu().numpy()]))
    idx = QuakeIndex.build(x, num_partitions=40, kmeans_iters=4,
                           device=dev)
    sizes = idx.levels[0].sizes()
    assert sizes.sum() == len(x) and (sizes > 0).all()
    idx.check_invariants()


def test_int8_executor_on_the_card_launches_the_q8_kernel(dev):
    ds = datasets.clustered(4000, 16, n_clusters=16, seed=0)
    q = datasets.queries_near(ds, 48, seed=3)
    cpu = QuakeIndex.build(ds.vectors, num_partitions=32, kmeans_iters=4,
                           device="cpu")
    gpu = index_from_arrays(index_to_arrays(cpu), device=dev)
    for kw in (dict(nprobe=6), dict(), dict(rounds=1)):
        before = sti.LAUNCHES_Q8.count
        rg = gpu.search_batch(q, 10, storage_dtype="int8", **kw)
        assert sti.LAUNCHES_Q8.count - before == rg.rounds
        rc = cpu.search_batch(q, 10, storage_dtype="int8", **kw)
        np.testing.assert_array_equal(rg.nprobe, rc.nprobe)
        assert np.mean(rg.ids == rc.ids) >= 0.99


def test_maintenance_on_the_card_runs_its_kernels(dev):
    """One maintenance pass on a CUDA index: the 2-means and refinement
    run on the card, the merge verify's assignment is the kmeans_assign
    kernel, and profiling times the scan_topk kernel."""
    from repro_torch.core import Maintainer, QuakeConfig, profile
    rng = np.random.default_rng(2)
    x = rng.normal(size=(4000, 16)).astype(np.float32)
    idx = QuakeIndex.build(x, num_partitions=200, kmeans_iters=3,
                           config=QuakeConfig(min_partition_size=64,
                                              tau_ns=1.0), device=dev)
    for qi in x[rng.integers(0, 4000, 200)]:
        idx.search(qi, 10)
    before = (ka.LAUNCHES.count, st.LAUNCHES.count)
    lam = profile(16, sizes=(64, 256, 1024), repeats=2, device=dev)
    assert min(lam.c_fixed, lam.c_lin, lam.c_sel) >= 0.0
    assert st.LAUNCHES.count > before[1]
    rep = Maintainer(idx).run()
    assert rep.merges >= 1 and ka.LAUNCHES.count > before[0]
    assert rep.cost_after <= rep.cost_before + 1e-6
    idx.check_invariants()


# ---------------------------------------------------------------------------
# flash attention: the kernel, its operands, the LM prefill on the card
# ---------------------------------------------------------------------------

# kernel vs plain at the kernel's tiles: f32 to rtol = atol = 2e-5 (the
# JAX kernel test's bound; the two sum the dot products in other orders);
# bf16 to one bf16 ulp of the output, 2^-7 |o|, plus 1e-3 (a score that
# differs in its last f32 bit can round p, or the output, the other way)
FLASH_TOL = {torch.float32: (2e-5, 2e-5), torch.bfloat16: (2.0 ** -7, 1e-3)}


def _flash_close(out, ref):
    rtol, atol = FLASH_TOL[ref.dtype]
    torch.cuda.synchronize()
    o, r = out.float(), ref.float()
    assert torch.isfinite(o).all()
    bad = (o - r).abs() > atol + rtol * r.abs()
    assert not bool(bad.any()), float((o - r).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("d", [16, 32, 64, 128])
@pytest.mark.parametrize("b,h,kh,sq,sk", [
    (2, 8, 1, 100, 100),      # MQA, Sq not a tile multiple
    (1, 6, 2, 70, 200),       # GQA, Sq < Sk (causal aligned at 0)
    (2, 4, 4, 129, 33),       # MHA, Sq > Sk, one partial key tile
    (1, 4, 2, 300, 300),      # GQA, several key tiles across the diagonal
])
def test_flash_attention_matches_plain(dev, dtype, causal, d, b, h, kh, sq,
                                       sk):
    g = torch.Generator(device=dev).manual_seed(b + h + sq + d)
    q = torch.randn((b, sq, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, sk, kh, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, sk, kh, d), generator=g, device=dev).to(dtype)
    before = fa.LAUNCHES.count
    out = fa.flash_attention(q, k, v, causal=causal)
    assert fa.LAUNCHES.count == before + 1
    assert out.shape == q.shape and out.dtype == dtype
    qb, kb = fa.TILES[dtype]
    _flash_close(out, fa.flash_attention_plain(
        q, k, v, causal=causal, q_block=qb, k_block=kb))


def test_flash_attention_strided_views_and_bad_operands(dev):
    """q, k and v read in place from one fused projection (strided heads);
    operands the kernel does not take raise, and nothing launches."""
    g = torch.Generator(device=dev).manual_seed(5)
    qkv = torch.randn((2, 90, 12, 32), generator=g, device=dev)
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    out = fa.flash_attention_cuda(q, k, v, causal=True)
    qb, kb = fa.TILES[torch.float32]
    _flash_close(out, fa.flash_attention_plain(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
        q_block=qb, k_block=kb))
    before = fa.LAUNCHES.count
    bad = [
        (q.half(), k.half(), v.half()),                  # f16
        (q, k.bfloat16(), v),                            # mixed dtypes
        (q.transpose(1, 3).contiguous().transpose(1, 3), k, v),  # last dim
        (torch.zeros(2, 90, 8, 48, device=dev),
         torch.zeros(2, 90, 2, 48, device=dev),
         torch.zeros(2, 90, 2, 48, device=dev)),         # D = 48
        (q[:, :, :6], k[:, :, :1].expand(2, 90, 4, 32), v),  # H % KH
        (q, k.cpu(), v),                                 # another device
    ]
    for args in bad:
        with pytest.raises(ValueError):
            fa.flash_attention_cuda(*args, causal=True)
    assert fa.LAUNCHES.count == before


def test_flash_attention_bf16_strided_views_and_row_alignment(dev):
    """bf16 q, k and v read in place from one fused projection, against
    the plain version at the bf16 tiles.  The kernel copies rows 16 bytes
    at a time: a row stride that is not a multiple of 8 elements, or a
    start off 16 bytes, raises, and nothing launches."""
    g = torch.Generator(device=dev).manual_seed(6)
    qkv = torch.randn((2, 90, 12, 32), generator=g, device=dev).bfloat16()
    q, k, v = qkv[:, :, :8], qkv[:, :, 8:10], qkv[:, :, 10:]
    out = fa.flash_attention_cuda(q, k, v, causal=True)
    qb, kb = fa.TILES[torch.bfloat16]
    _flash_close(out, fa.flash_attention_plain(
        q.contiguous(), k.contiguous(), v.contiguous(), causal=True,
        q_block=qb, k_block=kb))
    before = fa.LAUNCHES.count
    flat = torch.randn(2 * 90 * 260 + 8, generator=g, device=dev).bfloat16()
    k, v = k.contiguous(), v.contiguous()
    bad = [
        (flat[:2 * 90 * 260].view(2, 90, 260)[..., :256].unflatten(
            -1, (8, 32)), k, v),                         # row stride 260
        (flat[4:4 + 2 * 90 * 256].view(2, 90, 8, 32), k, v),  # start + 8 B
    ]
    for args in bad:
        with pytest.raises(ValueError):
            fa.flash_attention_cuda(*args, causal=True)
    assert fa.LAUNCHES.count == before


def test_transformer_on_the_card_launches_flash_once_per_layer(dev):
    """A smoke config's prefill on the card: one flash launch per layer,
    logits and caches as on the CPU (plain attention); decode launches no
    flash kernel."""
    from repro_torch.configs import lm_archs
    from repro_torch.models import Transformer
    cfg = lm_archs.qwen25_smoke()
    gpu = Transformer(cfg, device=dev)
    cpu = Transformer(cfg, device="cpu", init=False)
    cpu.load_state_dict({n: t.cpu() for n, t in gpu.state_dict().items()})
    toks = torch.as_tensor(np.random.default_rng(0).integers(0, 512, (2, 70)))
    before = fa.LAUNCHES.count
    lg, (ck, cv) = gpu.prefill(toks)
    assert fa.LAUNCHES.count == before + cfg.n_layers
    lc, (kc, vc) = cpu.prefill(toks)
    for a, b_ in ((lg, lc), (ck, kc), (cv, vc)):
        np.testing.assert_allclose(a.cpu().numpy(), b_.numpy(), rtol=1e-4,
                                   atol=1e-4)
    pad = lambda c: torch.nn.functional.pad(c, (0, 0, 0, 0, 0, 4))
    ck, cv = pad(ck), pad(cv)
    before = fa.LAUNCHES.count
    lg2, _ = gpu.decode_step(lg.argmax(-1), ck, cv,
                             torch.full((2,), 70, device=dev))
    assert fa.LAUNCHES.count == before
    assert torch.isfinite(lg2).all()


# ---------------------------------------------------------------------------
# the online serving runtime on the card
# ---------------------------------------------------------------------------

def _serving_index(dev, n=6000, d=32, p=48):
    ds = datasets.clustered(n, d, n_clusters=24, seed=0)
    idx = QuakeIndex.build(ds.vectors, num_partitions=p, kmeans_iters=4,
                           device=dev)
    return ds, idx


def test_serving_device_backend_matches_host_on_the_card(dev):
    """``scan_backend="auto"`` on a CUDA index serves every round through
    the indexed-scan kernel (one launch a round at least); the host
    backend launches none, and both return the same ids."""
    from repro_torch.core import ServingConfig, ServingRuntime
    ds, idx = _serving_index(dev)
    q = datasets.queries_near(ds, 40, seed=1)
    res = {}
    for backend in ("auto", "host"):
        rt = ServingRuntime(idx, ServingConfig(
            k=10, flush_size=16, scan_backend=backend,
            maint_min_ops=10 ** 9))
        before = sti.LAUNCHES.count
        qids = rt.submit_batch(q)
        rt.drain()
        launches = sti.LAUNCHES.count - before
        st = rt.stats()
        if backend == "auto":
            assert rt.scheduler.scan_backend == "device"
            assert 0 < st["rounds_run"] <= launches
        else:
            assert launches == 0
        assert st["scan_faults"] == 0
        res[backend] = [rt.result(i) for i in qids]
        rt.close()
    for a, b in zip(res["auto"], res["host"]):
        assert a.status == b.status == "OK"
        assert set(a.ids.tolist()) == set(b.ids.tolist())


def test_serving_int8_rounds_launch_the_q8_kernel(dev):
    from repro_torch.core import ServingConfig, ServingRuntime
    ds, idx = _serving_index(dev)
    q = datasets.queries_near(ds, 24, seed=2)
    rt = ServingRuntime(idx, ServingConfig(
        k=10, flush_size=8, storage_dtype="int8", maint_min_ops=10 ** 9))
    before = sti.LAUNCHES_Q8.count
    qids = rt.submit_batch(q)
    rt.drain()
    assert sti.LAUNCHES_Q8.count - before >= rt.stats()["rounds_run"] > 0
    assert {rt.result(i).status for i in qids} == {"OK"}
    rt.close()


def test_serving_recover_on_the_card_matches_live(dev, tmp_path):
    """Writes, a maintenance pass and queries through a WAL on the card;
    the recovered index (on the card) has the live one's fingerprint."""
    from repro_torch.core import ServingConfig, ServingRuntime
    from repro_torch.faults import index_state_fingerprint
    ds, idx = _serving_index(dev)
    cfg = ServingConfig(k=10, flush_size=16, wal_dir=str(tmp_path),
                        ckpt_every_ops=3, maint_min_ops=10 ** 9)
    rt = ServingRuntime(idx, cfg)
    rng = np.random.default_rng(3)
    for i in range(5):
        x = (ds.vectors[rng.integers(6000, size=50)]
             + rng.normal(0, 0.01, (50, 32))).astype(np.float32)
        rt.submit_insert(x, np.arange(100_000 + 50 * i, 100_050 + 50 * i))
        if i == 2:
            rt.submit_delete(np.arange(10 * i, 10 * i + 30))
            rt.maybe_maintain(force=True)
        rt.submit_batch(datasets.queries_near(ds, 8, seed=10 + i))
    rt.drain()
    live = index_state_fingerprint(idx)
    rt.close()
    rt2 = ServingRuntime.recover(str(tmp_path), ServingConfig(k=10),
                                 device=dev)
    assert rt2.index.device.type == "cuda"
    assert index_state_fingerprint(rt2.index) == live
    assert rt2.recovery_report.fingerprint == live.hex()
    qid = rt2.submit_query(datasets.queries_near(ds, 1, seed=4)[0])
    rt2.drain()
    assert rt2.result(qid).status == "OK"
    rt2.close()


def test_serving_rounds_under_the_sync_guard(dev):
    """A device round's declared transfers (the uploads and the per-round
    pull) are its only synchronizing calls: the rounds run under
    ``set_sync_debug_mode("error")`` and build no kernel library once
    warm, while an undeclared pull in the guard raises."""
    from repro_torch import sanitize
    from repro_torch.core import ServingConfig, ServingRuntime
    ds, idx = _serving_index(dev)
    rt = ServingRuntime(idx, ServingConfig(k=10, flush_size=10 ** 6,
                                           maint_min_ops=10 ** 9))
    warm = rt.submit_batch(datasets.queries_near(ds, 8, seed=5))
    rt.drain()
    qids = rt.submit_batch(datasets.queries_near(ds, 12, seed=6))
    rt.flush()             # admits (plans on the host) and runs a round
    assert rt.scheduler.has_active()
    with sanitize.sanitized() as ev:
        while rt.scheduler.step():
            pass
        sanitize.assert_compile_budget("scan_probe_round.steady", ev.new())
        with pytest.raises(RuntimeError):
            torch.ones(2, device=dev).sum().item()
    assert torch.cuda.get_sync_debug_mode() == 0
    rt.drain()
    assert {rt.result(i).status for i in warm + qids} == {"OK"}
    assert rt.stats()["scan_faults"] == 0
    rt.close()


# ---------------------------------------------------------------------------
# the sharded engine on the card
# ---------------------------------------------------------------------------

def _engine(dev, **kw):
    from repro_torch.core import EngineConfig, ShardedQuakeEngine
    from repro_torch.launch.mesh import Mesh
    mesh = Mesh((1, 1, 1), ("pod", "data", "model"), device=dev)
    return ShardedQuakeEngine(mesh, EngineConfig(
        k=10, nprobe=8, part_axes=("pod", "data"), **kw))


@pytest.mark.parametrize("storage", ["f32", "bf16", "int8"])
def test_engine_on_the_card_matches_the_plain_versions(dev, storage):
    """The engine at ``"union_cuda"`` on the card launches the indexed
    (or q8) kernel and the dense kernel, and agrees with the same engine
    on CPU tensors (the kernels' plain versions); int8 bit-equal, and
    with ``"union_torch"`` (the oracles) on the card too."""
    from repro_torch.core import IndexSnapshot
    ds = datasets.clustered(3000, 16, n_clusters=16, seed=0)
    cpu_idx = QuakeIndex.build(ds.vectors, num_partitions=30,
                               kmeans_iters=4, device="cpu")
    gpu_idx = index_from_arrays(index_to_arrays(cpu_idx), device=dev)
    q = datasets.queries_near(ds, 24, seed=3)
    cpu = _engine("cpu", scan_impl="union_cuda", storage_dtype=storage)
    gpu = _engine(dev, scan_impl="union_cuda", storage_dtype=storage)
    orc = _engine(dev, scan_impl="union_torch", storage_dtype=storage)
    snap = IndexSnapshot.from_index(cpu_idx)
    sc, sg = cpu.shard_snapshot(snap), gpu.shard_snapshot(snap)
    counter = sti.LAUNCHES_Q8 if storage == "int8" else sti.LAUNCHES
    before = counter.count
    outs = []
    for eng, s in ((gpu, sg), (cpu, sc), (orc, sg)):
        fx = eng.search_fixed(q, s)
        ad = eng.search_adaptive(q, s)
        bt = eng.search_batch(gpu_idx if eng is not cpu else cpu_idx, q, 10,
                              recall_target=0.9)
        outs.append((fx, ad, bt))
        if eng is gpu:        # fixed, every adaptive round, every round
            assert counter.count - before >= 2 + bt.rounds
    (fg, ag, bg), (fc, ac, bc), (fo, ao, bo) = outs
    for (dk, ik), (dp, ip_) in ((fg, fc), (ag[:2], ac[:2])):
        _same_topk(dk.to(dev), ik.to(dev), dp.to(dev), ip_.to(dev))
    if storage == "int8":
        # on the same card the q8 kernel and the oracle share their f32
        # operands (aux, qc): distances bit-equal, ids but at exact ties
        for (dk, ik), (dp, ip_) in ((fg, fo), (ag[:2], ao[:2])):
            dk, dp, ik, ip_ = dk.cpu(), dp.cpu(), ik.cpu(), ip_.cpu()
            assert torch.equal(dk, dp)
            tied = dp == dp[:, -1:]
            tied[:, 1:] |= dp[:, 1:] == dp[:, :-1]
            tied[:, :-1] |= dp[:, :-1] == dp[:, 1:]
            assert ((ik == ip_) | tied).all()
    assert torch.equal(ag[3].cpu(), ac[3].cpu())
    np.testing.assert_array_equal(bg.nprobe, bc.nprobe)
    assert bg.rounds == bc.rounds
    assert _recall(torch.as_tensor(bg.ids), torch.as_tensor(bc.ids)) >= 0.999
    if storage == "int8":
        np.testing.assert_array_equal(bg.dists, bo.dists)
    if storage != "int8":
        before = st.LAUNCHES.count
        db, ib = gpu.search_bruteforce(q, sg)
        assert st.LAUNCHES.count - before == 1
        _same_topk(db, ib, *(t.to(dev) for t in
                             cpu.search_bruteforce(q, sc)))


def test_engine_bruteforce_past_2_to_24_rows(dev):
    """Brute force over a synthetic shard of more than 2^24 rows goes
    through one ``scan_topk`` launch and finds the exact top-k (a chunked
    ``torch.matmul`` + ``torch.topk`` on the same rows)."""
    from repro_torch.core import IndexSnapshot
    p, s, d = 1040, 16384, 16
    assert p * s > 1 << 24
    snap = IndexSnapshot.synthetic(p, s, d, seed=1, device=dev)
    eng = _engine(dev, scan_impl="union_cuda")
    q = (snap.centroids[torch.arange(0, p, p // 8)]
         + torch.randn(8, d, device=dev, generator=torch.Generator(
             device=dev).manual_seed(2)))
    before = st.LAUNCHES.count
    dk, ik = eng.search_bruteforce(q, snap)
    assert st.LAUNCHES.count - before == 1
    flat = snap.data.reshape(-1, d)
    best_d, best_i = [], []
    for r0 in range(0, flat.shape[0], 1 << 22):
        x = flat[r0:r0 + (1 << 22)]
        dist = ((q * q).sum(1)[:, None] + (x * x).sum(1)[None]
                - 2.0 * q @ x.T)
        v, i = torch.topk(dist, 10, dim=1, largest=False)
        best_d.append(v)
        best_i.append(i + r0)
    v, pos = torch.topk(torch.cat(best_d, 1), 10, dim=1, largest=False)
    ip_ = torch.gather(torch.cat(best_i, 1), 1, pos)
    _same_topk(dk, ik, v, snap.ids.reshape(-1)[ip_])


def test_engine_int8_bruteforce_raises_on_the_card(dev):
    from repro_torch.core import IndexSnapshot
    snap = IndexSnapshot.synthetic(8, 64, 16, seed=0, dtype=torch.int8,
                                   device=dev)
    eng = _engine(dev, scan_impl="union_cuda", storage_dtype="int8")
    q = snap.centroids[:4].clone()
    with pytest.raises(ValueError, match="int8 residual codes"):
        eng.search_bruteforce(q, snap)
    d, i = eng.search_fixed(q, snap)
    assert (i[:, 0] >= 0).all()


def test_one_rank_nccl_mesh_collectives_are_the_identity(dev, tmp_path):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    dist.init_process_group("nccl", init_method=f"file://{tmp_path}/init",
                            world_size=1, rank=0)
    try:
        mesh = make_host_mesh(device="cuda")
        assert mesh.device.type == "cuda"
        t = torch.arange(12, dtype=torch.float32, device=dev).reshape(3, 4)
        for axes in (("data",), ("model",), ("data", "model")):
            assert mesh.group(axes) is not None
            assert torch.equal(mesh.all_gather(t, axes, dim=1), t)
            for op in (mesh.psum, mesh.pmin, mesh.pmax):
                assert torch.equal(op(t, axes), t)
            assert torch.equal(mesh.psum(t.long(), axes), t.long())
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# recsys serving (models/recsys.py) on the card against the CPU
# ---------------------------------------------------------------------------

RECSYS_TOL = 1e-5     # card vs CPU, f32 with TF32 off: 1e-5 * |x| + 1e-5


def _recsys_pair(name, dev):
    """One smoke config's model on the CPU and the same weights on the
    card, and one pipeline batch."""
    from repro_torch.configs import recsys_archs
    from repro_torch.data import RecsysPipeline
    from repro_torch.models import recsys as rs
    cfg = recsys_archs.ARCHS[name][1]()
    cpu = rs.MODELS[name][1](cfg, device="cpu",
                             generator=torch.Generator().manual_seed(0))
    card = rs.MODELS[name][1](cfg, device=dev, init=False)
    card.load_state_dict(cpu.state_dict())
    batch = RecsysPipeline(batch=64, vocab=1000, hist_len=rs.history_len(cfg),
                           seed=1).batch_at(0)
    return rs, cpu, card, batch


def _recsys_close(got, want):
    got, want = got.cpu().double(), want.double()
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    ok = ~torch.isnan(want)
    assert torch.allclose(got[ok], want[ok], rtol=RECSYS_TOL,
                          atol=RECSYS_TOL)


@pytest.mark.parametrize("name", ["din", "sasrec", "two-tower-retrieval",
                                  "dlrm-rm2"])
def test_recsys_on_the_card_matches_the_cpu(dev, name):
    """Serve and retrieval (512 candidates, in chunks too) of the same
    weights on the card and the CPU, then the same batch with ids out of
    range both ways: NaN where the CPU has NaN, and no device assert."""
    rs, cpu, card, batch = _recsys_pair(name, dev)
    cand = torch.randperm(1000, generator=torch.Generator().manual_seed(2))
    cand = cand[:512].to(torch.int32)
    user = {k: torch.as_tensor(batch[k][:1])
            for k in ("history", "history_mask", "dense")}
    want = rs.recsys_serve(cpu, rs.batch_to(batch, "cpu"))
    _recsys_close(rs.recsys_serve(card, rs.batch_to(batch, dev)), want)
    want = rs.recsys_retrieval(cpu, user, cand)
    user_d = {k: v.to(dev) for k, v in user.items()}
    _recsys_close(rs.recsys_retrieval(card, user_d, cand.to(dev)), want)
    _recsys_close(rs.recsys_retrieval(card, user_d, cand.to(dev), chunk=100),
                  want)
    bad = {k: v.copy() for k, v in batch.items()}
    bad["history"][0, 0], bad["history"][1, 0] = 1000 + 7, -1
    bad["target_item"][2], bad["sparse"][3, 0] = 10 ** 6, -1001
    want = rs.recsys_serve(cpu, rs.batch_to(bad, "cpu"))
    got = rs.recsys_serve(card, rs.batch_to(bad, dev))
    torch.cuda.synchronize()
    _recsys_close(got, want)
    assert bool(torch.isnan(want).any())


def test_recsys_gathers_out_of_range_on_the_card(dev):
    from repro_torch.models import layers
    table = torch.randn(9, 4, generator=torch.Generator().manual_seed(0))
    ids = torch.tensor([[0, 8, -1, -9], [9, 40, -10, 3]], dtype=torch.int32)
    want = layers.take_fill(table, ids)
    got = layers.take_fill(table.to(dev), ids.to(dev))
    assert torch.equal(torch.isnan(got.cpu()), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got.cpu()), torch.nan_to_num(want))
    valid = torch.tensor([[True, True, False, True], [False] * 4])
    for mode in ("sum", "mean"):
        want = layers.embedding_bag(table, ids, mode=mode, valid=valid)
        got = layers.embedding_bag(table.to(dev), ids.to(dev), mode=mode,
                                   valid=valid.to(dev))
        assert torch.allclose(got.cpu(), want, rtol=1e-6, atol=1e-6)


def test_two_tower_retrieval_through_quake_on_the_card(dev):
    """A two-tower corpus (20,000 items, d = 64) in ``QuakeIndex(metric=
    "ip")`` on the card: probing every partition returns the exact GEMM's
    top-k (ids equal but at near-ties), through the indexed kernel; the
    int8 storage launches the q8 kernel."""
    from repro_torch.core import QuakeConfig
    from repro_torch.data import RecsysPipeline
    from repro_torch.models import recsys as rs
    cfg = rs.TwoTowerConfig(user_vocab=5000, item_vocab=20_000, embed_dim=64,
                            tower_mlp=(128, 64), hist_len=16)
    g = torch.Generator(device=dev).manual_seed(0)
    model = rs.TwoTower(cfg, device=dev, generator=g)
    items = rs.item_repr(model, torch.arange(cfg.item_vocab, device=dev))
    batch = RecsysPipeline(batch=64, vocab=cfg.user_vocab,
                           hist_len=cfg.hist_len, seed=2).batch_at(0)
    users = rs.user_repr(model, rs.batch_to(batch, dev))
    k = 20
    scores = users @ items.T
    top = torch.topk(scores, k, dim=1)
    idx = QuakeIndex.build(items.cpu().numpy(),
                           config=QuakeConfig(metric="ip"), device=dev)
    before = sti.LAUNCHES.count
    res = idx.search_batch(users.cpu().numpy(), k,
                           nprobe=idx.num_partitions, rounds=1)
    assert sti.LAUNCHES.count > before
    want = top.indices.cpu().numpy()
    exact = scores.double().cpu().numpy()
    rows = np.arange(len(want))[:, None]
    differ = res.ids != want
    gap = np.abs(exact[rows, res.ids] - exact[rows, want])
    assert (gap[differ] <= 4e-5).all()
    np.testing.assert_allclose(-res.dists, exact[rows, res.ids], rtol=1e-5,
                               atol=1e-5)
    before = sti.LAUNCHES_Q8.count
    r8 = idx.search_batch(users.cpu().numpy(), k, recall_target=0.9,
                          storage_dtype="int8")
    assert sti.LAUNCHES_Q8.count > before
    assert r8.ids.shape == (64, k)


# ---------------------------------------------------------------------------
# MoE serving and the GAT forward
# ---------------------------------------------------------------------------

MOE_TOL = GNN_TOL = 1e-5


@pytest.mark.parametrize("zero_router", [False, True],
                         ids=["random", "zero-router"])
@pytest.mark.parametrize("name", ["qwen3_moe_smoke", "llama4_scout_smoke"])
def test_moe_on_the_card_matches_the_cpu(dev, name, zero_router):
    """``moe_ffn`` (75 tokens: a full group of 64 and a padded one, at a
    capacity factor that drops), ``prefill`` and ``decode_step`` of the
    same smoke weights on the card and the CPU, within 1e-5 * |x| +
    1e-5; a zero router forces ties (uniform probabilities) and drops."""
    import dataclasses
    from repro_torch.configs import lm_archs
    from repro_torch.models import transformer as tr
    base = getattr(lm_archs, name)()
    cfg = dataclasses.replace(base, moe=dataclasses.replace(
        base.moe, capacity_factor=0.5))
    cpu = tr.Transformer(cfg, device="cpu",
                         generator=torch.Generator().manual_seed(1))
    if zero_router:
        for blk in cpu.blocks:
            blk.moe.router.data.zero_()
    card = tr.Transformer(cfg, device=dev, init=False)
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((3, 25, cfg.d_model),
                    generator=torch.Generator().manual_seed(2))
    for want, got in zip(tr.moe_ffn(cpu.blocks[0].moe, x, cfg),
                         tr.moe_ffn(card.blocks[0].moe, x.to(dev), cfg)):
        assert torch.allclose(got.cpu(), want, rtol=MOE_TOL, atol=MOE_TOL)
    toks = torch.randint(0, cfg.vocab_size, (2, 40),
                         generator=torch.Generator().manual_seed(3))
    lg, (ck, cv) = cpu.prefill(toks)
    lg_d, (ck_d, cv_d) = card.prefill(toks.to(dev))
    for got, want in ((lg_d, lg), (ck_d, ck), (cv_d, cv)):
        assert torch.allclose(got.cpu(), want, rtol=MOE_TOL, atol=MOE_TOL)
    pad = (0, 0, 0, 0, 0, 1)
    ck, cv = (torch.nn.functional.pad(t, pad) for t in (ck, cv))
    ck_d, cv_d = ck.to(dev), cv.to(dev)
    tok, cl = torch.tensor([3, 7]), torch.tensor([40, 37])
    want, _ = cpu.decode_step(tok, ck, cv, cl)
    got, _ = card.decode_step(tok.to(dev), ck_d, cv_d, cl.to(dev))
    assert torch.allclose(got.cpu(), want, rtol=MOE_TOL, atol=MOE_TOL)
    assert torch.allclose(ck_d.cpu(), ck, rtol=MOE_TOL, atol=MOE_TOL)


def test_segment_sums_on_the_card_are_reproducible(dev):
    """On a power-law graph of about 1M edges, the card's segment sums
    and maxes (edges sorted by destination once, each segment reduced in
    edge order, no atomics) give equal bits twice, and the CPU's sums
    within 1e-5 * |x| + 1e-5."""
    from repro_torch.data import graphs
    from repro_torch.models import layers
    src, dst = graphs.to_edges(graphs.power_law_graph(100_000, 5.0, seed=0))
    assert len(dst) > 900_000
    dst = torch.as_tensor(dst, dtype=torch.long)
    msg = torch.randn((len(dst), 8, 8),
                      generator=torch.Generator().manual_seed(0))
    scores = msg[:, :, 0]
    d_dev, m_dev, s_dev = dst.to(dev), msg.to(dev), scores.to(dev)
    for fn, data, gpu in ((layers.segment_sum, msg, m_dev),
                          (layers.segment_max, scores, s_dev),
                          (layers.segment_softmax, scores, s_dev)):
        a = fn(gpu, d_dev, 100_000)
        b = fn(gpu, d_dev, 100_000)
        assert torch.equal(a, b)
        want = fn(data, dst, 100_000)
        fin = torch.isfinite(want)
        assert torch.equal(torch.isfinite(a.cpu()), fin)
        assert torch.allclose(a.cpu()[fin], want[fin], rtol=GNN_TOL,
                              atol=GNN_TOL)


@pytest.mark.parametrize("shape", ["full_graph_sm", "minibatch_lg",
                                   "ogb_products", "molecule"])
def test_gat_forward_on_the_card_matches_the_cpu(dev, shape):
    """``gat_cora_smoke`` at each smoke shape's d_feat on a graph of that
    shape: the card's forward (pooled for ``molecule``) equal to itself
    twice and to the CPU's within 1e-5 * |x| + 1e-5."""
    import dataclasses
    from repro_torch.configs import gnn_archs
    from repro_torch.data import graphs
    from repro_torch.models import gnn
    sh = gnn_archs.GNN_SMOKE_SHAPES[shape]
    if shape == "molecule":
        src, dst, feats, graph_of = graphs.molecule_batch(
            sh["n_graphs"], sh["n_nodes"], sh["n_edges"], sh["d_feat"])
        n = len(feats)
    else:
        n = sh["n_nodes"]
        g = graphs.power_law_graph(n, sh["n_edges"] / n / 2, seed=1)
        src, dst = graphs.to_edges(g)
        feats = np.random.default_rng(2).normal(
            size=(n, sh["d_feat"])).astype(np.float32)
    cfg = dataclasses.replace(gnn_archs.gat_cora_smoke(), d_in=sh["d_feat"])
    cpu = gnn.GAT(cfg, device="cpu",
                  generator=torch.Generator().manual_seed(0))
    card = gnn.GAT(cfg, device=dev, init=False)
    card.load_state_dict(cpu.state_dict())
    args = [torch.as_tensor(a) for a in (feats, src, dst)]
    if shape == "molecule":
        args.append(torch.as_tensor(graph_of))

    def run(model, dev_):
        a = [t.to(dev_) for t in args]
        if shape == "molecule":
            return gnn.graph_pool_logits(model, *a, sh["n_graphs"])
        return gnn.forward(model, *a)

    want = run(cpu, "cpu")
    got = run(card, dev)
    assert torch.equal(got, run(card, dev))
    assert torch.allclose(got.cpu(), want, rtol=GNN_TOL, atol=GNN_TOL)


# ---------------------------------------------------------------------------
# training (train/, the models' losses) on the card against the CPU
# ---------------------------------------------------------------------------

TRAIN_TOL, TRAIN_SMALL, TRAIN_NOISE = 1e-5, 1e-3, 1e-6
TRAIN_OPT = dict(lr=1e-2, warmup_steps=1, total_steps=10)


def _train_case(name, dev):
    """(CPU model, card model with its weights, loss, batch) of one smoke
    config."""
    import dataclasses
    from repro_torch.configs import gnn_archs, lm_archs, recsys_archs
    from repro_torch.data import RecsysPipeline, TokenPipeline, graphs
    from repro_torch.models import recsys as rs
    from repro_torch.models import gnn, transformer as tr
    if name in rs.MODELS:
        cfg = recsys_archs.ARCHS[name][1]()
        make = lambda d, g: rs.MODELS[name][1](  # noqa: E731
            cfg, device=d, generator=g, init=g is not None)
        loss = rs.recsys_loss
        batch = RecsysPipeline(batch=32, vocab=1000,
                               hist_len=rs.history_len(cfg),
                               seed=1).batch_at(0)
    elif name == "gat":
        sh = gnn_archs.GNN_SMOKE_SHAPES["full_graph_sm"]
        cfg = dataclasses.replace(gnn_archs.gat_cora_smoke(),
                                  d_in=sh["d_feat"])
        make = lambda d, g: gnn.GAT(  # noqa: E731
            cfg, device=d, generator=g, init=g is not None)
        src, dst = graphs.to_edges(graphs.power_law_graph(
            sh["n_nodes"], sh["n_edges"] / sh["n_nodes"] / 2, seed=1))
        rng = np.random.default_rng(2)
        batch = {"feats": rng.normal(size=(sh["n_nodes"], sh["d_feat"])
                                     ).astype(np.float32),
                 "src": src, "dst": dst,
                 "labels": rng.integers(0, 7, sh["n_nodes"])}

        def loss(m, b):
            return gnn.loss_fn(m, b["feats"], b["src"], b["dst"],
                               b["labels"])
    else:
        cfg = dataclasses.replace(getattr(lm_archs, name)(), q_block=16,
                                  k_block=32, attn_grouped=True)
        make = lambda d, g: tr.Transformer(  # noqa: E731
            cfg, device=d, generator=g, init=g is not None)
        batch = TokenPipeline(cfg.vocab_size, 2, 64).batch_at(0)

        def loss(m, b):
            return tr.lm_loss(m, b["tokens"])
    cpu = make("cpu", torch.Generator().manual_seed(0))
    card = make(dev, None)
    card.load_state_dict(cpu.state_dict())
    return cpu, card, loss, batch


def _hold_params_near(card, cpu, grads, lr):
    """Parameters within TRAIN_TOL * |x| + TRAIN_TOL, but entries whose CPU
    gradient is under TRAIN_SMALL of its leaf's largest, or under
    TRAIN_NOISE of the largest of all (its f32 rounding level: a leaf that
    cancels to zero holds noise alone): Adam's first update there is lr *
    sign(g) of a rounding-level g, held to 2 * lr."""
    want = dict(cpu.named_parameters())
    top = max(float(g.abs().max()) for g in grads.values())
    for n, p in card.named_parameters():
        w, x = want[n].detach().double(), p.detach().cpu().double()
        g = grads[n].abs()
        noise = (g < TRAIN_SMALL * g.max()) | (g < TRAIN_NOISE * top)
        tol = torch.where(noise, 2.0 * lr, TRAIN_TOL * w.abs() + TRAIN_TOL)
        assert bool(((x - w).abs() <= tol).all()), n


@pytest.mark.parametrize("name", ["qwen25_smoke", "granite_smoke",
                                  "qwen3_moe_smoke", "din", "sasrec",
                                  "two-tower-retrieval", "dlrm-rm2", "gat"])
def test_train_step_on_the_card_matches_the_cpu(dev, name):
    """One ``make_train_step`` step of a smoke config, f32 with TF32 off:
    loss and grad norm within 1e-5 * |x| + 1e-5 of the CPU's step on the
    same weights, and the parameters after it (``_hold_params_near``)."""
    from repro_torch.train import optimizer as opt, steps
    cpu, card, loss, batch = _train_case(name, dev)
    _, g = steps.value_and_grad(loss, cpu, steps.to_device(batch, "cpu"))
    step = steps.make_train_step(loss, opt.AdamWConfig(**TRAIN_OPT))
    _, _, mc = step(cpu, opt.init_state(cpu), batch)
    _, st, mg = step(card, opt.init_state(card), batch)
    assert st.step.device.type == "cuda"
    for k in ("loss", "grad_norm"):
        assert abs(float(mg[k]) - float(mc[k])) <= \
            TRAIN_TOL * abs(float(mc[k])) + TRAIN_TOL, k
    _hold_params_near(card, cpu, g, float(mc["lr"]))


def test_async_checkpoint_of_card_tensors_keeps_save_time_values(
        dev, tmp_path):
    """A save of CUDA tensors, then an in-place update before the writer
    thread has finished: the checkpoint holds the values at save time, and
    restores onto the card (the default device)."""
    from repro_torch.train import CheckpointManager
    from repro_torch.train import optimizer as opt
    w = torch.randn(4_000_000, device=dev)
    st = opt.init_state({"w": w})
    want = w.cpu().clone()
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(1, ({"w": w}, st))
    w.mul_(-3.0)
    st.m["w"].fill_(1.0)
    mgr.wait()
    got, man = mgr.restore(({"w": w}, st))
    assert man["step"] == 1 and got[0]["w"].device.type == "cuda"
    assert torch.equal(got[0]["w"].cpu(), want)
    assert not got[1].m["w"].any()
    mgr.restore_into(({"w": w}, st))
    assert torch.equal(w.cpu(), want)


def test_compressed_step_on_one_nccl_rank_matches_one_gloo_rank(
        dev, tmp_path):
    """``make_compressed_dp_step`` (qwen25_smoke) on a one-rank NCCL
    group, every collective a real NCCL call, against the same step in a
    one-rank gloo group on the CPU: loss within 1e-5 * |x| + 1e-5, the
    parameters as ``_hold_params_near``, whose marked entries also take
    the codes that sit within 1e-3 of a rounding tie."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.train import optimizer as opt, steps
    cpu0, _, loss, batch = _train_case("qwen25_smoke", dev)

    def run(device, backend, tag):
        dist.init_process_group(backend,
                                init_method=f"file://{tmp_path}/{tag}",
                                world_size=1, rank=0)
        try:
            mesh = make_host_mesh(device=device)
            model = type(cpu0)(cpu0.cfg, device=mesh.device, init=False)
            model.load_state_dict(cpu0.state_dict())
            st, res = opt.init_state(model), opt.init_residual(model)
            step = steps.make_compressed_dp_step(
                loss, opt.AdamWConfig(**TRAIN_OPT), mesh, ("data",))
            return model, step(model, st, res, batch)[3]
        finally:
            dist.destroy_process_group()

    cpu, mc = run("cpu", "gloo", "gloo")
    card, mg = run("cuda", "nccl", "nccl")
    assert abs(float(mg["loss"]) - float(mc["loss"])) <= \
        TRAIN_TOL * abs(float(mc["loss"])) + TRAIN_TOL
    _, g = steps.value_and_grad(loss, cpu0, batch)
    for n, t in g.items():
        q = (t / (t.abs().max() / 127.0)).abs()
        tie = ((q - q.floor()) - 0.5).abs() < 1e-3
        g[n] = torch.where(tie, 0.0, t)     # marked as near zero
    _hold_params_near(card, cpu, g, float(mc["lr"]))


# ---------------------------------------------------------------------------
# the kernels' wrappers on meta tensors (the dry-run's count)
# ---------------------------------------------------------------------------

def _meta_and_card_bytes(dev, fn, args):
    """(the most bytes the call's tensors hold at once on meta, on the
    card), each storage rounded to the caching allocator's 512 bytes,
    after a warm call on the card (workspaces made once); the card's
    ``max_memory_allocated`` growth must hold at least as much (it also
    holds what a library call inside an op allocates)."""
    from repro_torch.kernels import build
    from repro_torch.roofline.count import LiveBytes

    def peak(ts):
        live = LiveBytes([a for a in ts if isinstance(a, torch.Tensor)],
                         granule=512)
        with build.card_route_on_meta(), live:
            out = fn(*ts)
        torch.cuda.synchronize()
        del out
        return live.peak

    def to(t, d):
        return t.to(d) if isinstance(t, torch.Tensor) else t
    meta = peak([to(a, "meta") for a in args])
    card = [to(a, dev) for a in args]
    fn(*card)
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    got = peak(card)
    assert torch.cuda.max_memory_allocated() - before >= got
    return meta, got


@pytest.mark.parametrize("q,n", [(1, 5000), (64, 20000)])
def test_meta_scan_topk_allocates_as_the_card(dev, q, n):
    g = torch.Generator().manual_seed(0)
    xs, qs = torch.randn(n, 64, generator=g), torch.randn(q, 64, generator=g)
    got, want = _meta_and_card_bytes(
        dev, lambda a, b: st.scan_topk(a, b, k_pad=128), (qs, xs))
    assert got == want


def test_meta_kmeans_assign_allocates_as_the_card(dev):
    g = torch.Generator().manual_seed(1)
    xs, c = torch.randn(30000, 128, generator=g), torch.randn(
        1000, 128, generator=g)
    aux = (c * c).sum(1)
    got, want = _meta_and_card_bytes(dev, ka.kmeans_assign, (xs, c, aux))
    assert got == want


@pytest.mark.parametrize("q8,d,k_pad", [(False, 128, 128),
                                         (True, 128, 128),
                                         (False, 3072, 128),
                                         (False, 3072, 1024)])
def test_meta_indexed_scans_allocate_as_the_card(dev, q8, d, k_pad):
    """Both designs (the tiled one at d = 3,072, its buffers in shared
    and in global memory) allocate on meta tensors as on the card."""
    g = torch.Generator().manual_seed(2)
    p, s, b, u = 32, 256, 48, 12
    valid = torch.ones(p, s, dtype=torch.bool)
    sel = torch.randperm(p, generator=g)[:u].to(torch.int32)
    qmask = torch.rand(b, u, generator=g) < 0.5
    if not q8:
        data, q = torch.randn(p, s, d, generator=g), torch.randn(
            b, d, generator=g)
        got, want = _meta_and_card_bytes(
            dev, lambda *a: sti.scan_topk_indexed(*a, k_pad=k_pad),
            (q, data, valid, sel, qmask))
    else:
        codes = torch.randint(-127, 128, (p, s, d), generator=g,
                              dtype=torch.int8)
        args = (torch.randint(-127, 128, (b, d), generator=g,
                              dtype=torch.int8),
                torch.rand(b, generator=g), codes, torch.rand(p, s, generator=g),
                torch.rand(p, s, generator=g), torch.randn(b, u, generator=g),
                valid, sel, qmask)
        got, want = _meta_and_card_bytes(
            dev, lambda *a: sti.scan_topk_indexed_q8(*a, k_pad=128), args)
    assert got == want


def test_meta_flash_attention_allocates_as_the_card(dev):
    g = torch.Generator().manual_seed(3)
    q = torch.randn(2, 1000, 8, 128, generator=g).bfloat16()
    k = torch.randn(2, 1000, 2, 128, generator=g).bfloat16()
    got, want = _meta_and_card_bytes(
        dev, lambda a, b, c: fa.flash_attention(a, b, c, causal=True),
        (q, k, k.clone()))
    assert got == want

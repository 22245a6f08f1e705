"""The port's sharded engine (``repro_torch.core.distributed``) and meshes
(``repro_torch.launch.mesh``) against the JAX package's, on the CPU.

Both engines serve the same structure: a JAX-built index loaded into the
port through ``index_from_arrays`` (in process) or through each
package's own checkpoint loader (the multi-rank case).  Scan
implementations pair up by name: the JAX ``"gather"``, ``"union_jnp"``
and ``"union_pallas"`` (its Pallas kernel in interpret mode) against the
port's ``"gather"``, ``"union_torch"`` (plain oracles) and
``"union_cuda"`` (the kernels' plain versions on CPU tensors).

Tolerances: L2 distances within ``REL·|d| + ABS`` (1e-5 each), where
``|d|`` is the scan's own distance, ``d - ||q||^2`` (two f32 scans that
sum in another order differ by ulps of the norms, not of the small
difference); ids equal except where both lists sit within twice that
bound of the k-th distance (a near-tie); recall estimates to rtol 1e-4;
probe counts, rounds and scan statistics exactly.

The multi-rank case runs four gloo ranks of the port, one process each,
on a (1, 2, 2) ("pod", "data", "model") mesh, and the JAX engine on four
virtual host devices, on the same mesh and index; results meet through
``.npz`` files.
"""
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh as JMesh

from repro.core import EngineConfig as JConfig
from repro.core import IndexSnapshot as JSnapshot
from repro.core import QuakeIndex as JIndex
from repro.core import ShardedQuakeEngine as JEngine
from repro.data import datasets as jds
from repro_torch.core import (EngineConfig, IndexSnapshot,
                              ShardedQuakeEngine, index_from_arrays)
from repro_torch.core.geometry import betainc_table
from repro_torch.core.snapshot import Q8_PARTS, synthetic_blocks
from repro_torch.kernels.ref import quantize_int8_residual
from repro_torch.launch.mesh import Mesh, describe, make_host_mesh
from test_torch_core import export_jax_index

REL, ABS = 1e-5, 1e-5
K = 10
IMPLS = [("gather", "gather"), ("union_jnp", "union_torch"),
         ("union_pallas", "union_cuda")]
SRC = str(Path(__file__).resolve().parents[1] / "src")
SCRIPTS = str(Path(__file__).resolve().parents[1] / "scripts")


@pytest.fixture(scope="module")
def built():
    ds = jds.clustered(4000, 16, n_clusters=16, seed=0)
    j = JIndex.build(ds.vectors, num_partitions=32, kmeans_iters=4)
    return ds, j, export_jax_index(j), jds.queries_near(ds, 8, seed=2)


def _port(state):
    return index_from_arrays(state, device="cpu")


def _meshes():
    jm = JMesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
               ("pod", "data", "model"))
    return jm, Mesh((1, 1, 1), ("pod", "data", "model"), device="cpu")


def _engines(j, state, jimpl="union_jnp", timpl="union_torch", **kw):
    """The JAX and the port engine on one-device meshes, each with its
    sharded snapshot of the same index."""
    jm, tm = _meshes()
    kw = dict(k=K, part_axes=("pod", "data"), **kw)
    je = JEngine(jm, JConfig(scan_impl=jimpl, **kw))
    te = ShardedQuakeEngine(tm, EngineConfig(scan_impl=timpl, **kw))
    return (je, je.shard_snapshot(JSnapshot.from_index(j)),
            te, te.shard_snapshot(IndexSnapshot.from_index(_port(state))))


def assert_same_topk(q, d_port, i_port, d_ref, i_ref):
    """The module's tolerances on (B, k) top-k lists, f32 or f64."""
    d_port, d_ref = np.asarray(d_port, np.float64), np.asarray(d_ref,
                                                                np.float64)
    i_port, i_ref = np.asarray(i_port), np.asarray(i_ref)
    real = np.isfinite(d_ref) & (d_ref < 1e37)
    assert np.array_equal(real, np.isfinite(d_port) & (d_port < 1e37))
    q2 = np.sum(np.asarray(q, np.float64) ** 2, axis=1)[:, None]
    tol = np.where(real, REL * np.abs(d_ref - q2) + ABS, 0.0)
    assert (np.abs(np.where(real, d_port, 0.0) - np.where(real, d_ref, 0.0))
            <= tol).all()
    kth = np.where(real, d_ref, -np.inf).max(axis=1, keepdims=True)
    near = np.abs(d_ref - kth) <= 2 * tol
    assert ((i_port == i_ref) | (near & real)).all()


def _recall(ids, gt) -> float:
    ids = np.asarray(ids)
    return float(np.mean([len(set(a.tolist()) & set(b.tolist())) / gt.shape[1]
                          for a, b in zip(ids, gt)]))


def assert_same_batch(rt, rj, q):
    assert_same_topk(q, rt.dists, rt.ids, rj.dists, rj.ids)
    np.testing.assert_array_equal(rt.nprobe, rj.nprobe)
    assert (rt.rounds, rt.partitions_scanned, rt.vectors_scanned,
            rt.comparisons) == (rj.rounds, rj.partitions_scanned,
                                rj.vectors_scanned, rj.comparisons)
    if rj.recall_estimate is None:
        assert rt.recall_estimate is None
    else:
        np.testing.assert_allclose(rt.recall_estimate, rj.recall_estimate,
                                   rtol=1e-4, equal_nan=True)


# ---------------------------------------------------------------------------
# snapshots
# ---------------------------------------------------------------------------

def test_snapshot_matches_reference_and_splits_into_blocks(built):
    _, j, state, _ = built
    p = _port(state)
    js = JSnapshot.from_index(j, pad_partitions_to=2, headroom=1.5)
    ts = IndexSnapshot.from_index(p, pad_partitions_to=2, headroom=1.5)
    for name in ("data", "ids", "centroids", "sizes"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)))
    # the JAX table is betainc evaluated in f32, the port's is scipy's in
    # f64 rounded to f32: they differ by f32 rounding of the evaluation
    np.testing.assert_allclose(ts.beta_table.numpy(),
                               np.asarray(js.beta_table), rtol=1e-4,
                               atol=1e-6)
    # a shard's block is its slice of the whole, flat indices local to it
    f32 = IndexSnapshot.from_index(p, pad_partitions_to=4)
    for dtype in (torch.float32, torch.bfloat16, torch.int8):
        whole = IndexSnapshot.from_index(p, pad_partitions_to=4,
                                         dtype=dtype)
        # converted block by block, the storage equals the whole converted
        if dtype == torch.int8:
            codes, scales = quantize_int8_residual(f32.data, f32.centroids)
            assert torch.equal(whole.data, codes)
            assert torch.equal(whole.scales, scales)
        else:
            assert torch.equal(whole.data, f32.data.to(dtype))
        for lo in range(0, whole.num_partitions, 8):
            blk = IndexSnapshot.from_index(p, pad_partitions_to=4,
                                           dtype=dtype, parts=(lo, lo + 8))
            for name in ("data", "ids", "centroids", "sizes", "scales"):
                a, b = getattr(blk, name), getattr(whole, name)
                assert (a is None) == (b is None)
                if a is not None:
                    assert torch.equal(a, b[lo:lo + 8]), (name, lo)
    with pytest.raises(ValueError, match="outside"):
        IndexSnapshot.from_index(p, parts=(0, 33))


def test_synthetic_snapshot_shapes_and_int8_form():
    p, s, d = 2 * Q8_PARTS + 5, 16, 8
    snap = IndexSnapshot.synthetic(p, s, d, seed=3, device="cpu")
    assert snap.data.shape == (p, s, d) and snap.data.dtype == torch.float32
    assert torch.equal(snap.ids.reshape(-1),
                       torch.arange(p * s, dtype=torch.int32))
    assert torch.equal(snap.sizes, torch.full((p,), s, dtype=torch.int32))
    np.testing.assert_array_equal(snap.beta_table.numpy(), betainc_table(d))
    assert snap.scales is None
    # the JAX package's distribution: centroids 3 N(0,1), rows c + N(0,1)
    assert abs(float(snap.centroids.std()) - 3.0) < 0.3
    noise = snap.data - snap.centroids[:, None, :]
    assert abs(float(noise.mean())) < 0.05
    assert abs(float(noise.std()) - 1.0) < 0.05
    # int8 drawn and quantized block by block equals quantizing the f32
    q8 = IndexSnapshot.synthetic(p, s, d, seed=3, dtype=torch.int8,
                                 device="cpu")
    codes, scales = quantize_int8_residual(snap.data, snap.centroids)
    assert q8.data.dtype == torch.int8
    assert torch.equal(q8.data, codes) and torch.equal(q8.scales, scales)
    assert torch.equal(q8.centroids, snap.centroids)
    # the blocks drawn again are the snapshot's rows
    blocks = list(synthetic_blocks(p, s, d, seed=3, device="cpu"))
    assert [(a, z) for a, z, _, _ in blocks] == [
        (0, Q8_PARTS), (Q8_PARTS, 2 * Q8_PARTS), (2 * Q8_PARTS, p)]
    for a, z, c, x in blocks:
        assert torch.equal(c, snap.centroids[a:z])
        assert torch.equal(x, snap.data[a:z])
    bf = IndexSnapshot.synthetic(p, s, d, seed=3, dtype=torch.bfloat16,
                                 device="cpu")
    assert torch.equal(bf.data, snap.data.to(torch.bfloat16))
    other = IndexSnapshot.synthetic(p, s, d, seed=4, device="cpu")
    assert not torch.equal(other.data, snap.data)


# ---------------------------------------------------------------------------
# meshes
# ---------------------------------------------------------------------------

def test_one_device_mesh_collectives_are_the_identity():
    m = make_host_mesh(device="cpu")
    assert m.axis_names == ("data", "model") and m.size == 1
    assert m.device == torch.device("cpu")
    assert describe(m) == "{'data': 1, 'model': 1} (1 devices)"
    t = torch.arange(6, dtype=torch.float32).reshape(2, 3)
    for axes in ((), ("data",), ("data", "model")):
        assert m.group(axes) is None
        assert torch.equal(m.all_gather(t, axes, dim=1), t)
        for op in (m.psum, m.pmin, m.pmax):
            assert torch.equal(op(t, axes), t)
    assert m.index(("data", "model")) == 0
    assert m.axis_size(("data", "model")) == 1
    with pytest.raises(ValueError, match="process group"):
        Mesh((2, 1), ("data", "model"), device="cpu")
    with pytest.raises(ValueError, match="not in the mesh"):
        m.psum(t, ("pod",))
    with pytest.raises(ValueError, match="split"):
        make_host_mesh(model=2, device="cpu")


# ---------------------------------------------------------------------------
# the engine on a (1, 1, 1) mesh against the JAX engine
# ---------------------------------------------------------------------------

def test_bruteforce_matches_reference(built):
    ds, j, state, q = built
    je, js, te, ts = _engines(j, state, timpl="union_cuda")
    dj, ij = je.search_bruteforce(jnp.asarray(q), js)
    dt, it = te.search_bruteforce(q, ts)
    assert_same_topk(q, dt, it, dj, ij)
    assert _recall(it, ds.ground_truth(q, K)) == 1.0


@pytest.mark.parametrize("jimpl,timpl", IMPLS)
def test_search_fixed_matches_reference(built, jimpl, timpl):
    _, j, state, q = built
    je, js, te, ts = _engines(j, state, jimpl, timpl, nprobe=8)
    dj, ij = je.search_fixed(jnp.asarray(q), js)
    dt, it = te.search_fixed(q, ts)
    assert_same_topk(q, dt, it, dj, ij)


@pytest.mark.parametrize("jimpl,timpl", IMPLS[:2])
def test_search_adaptive_matches_reference(built, jimpl, timpl):
    _, j, state, q = built
    je, js, te, ts = _engines(j, state, jimpl, timpl, recall_target=0.95,
                              chunk=1)
    dj, ij, rj, nj = je.search_adaptive(jnp.asarray(q), js)
    dt, it, rt, nt = te.search_adaptive(q, ts)
    assert_same_topk(q, dt, it, dj, ij)
    np.testing.assert_allclose(rt.numpy(), np.asarray(rj), rtol=1e-4)
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
    assert 1 < int(nt[0]) < 32      # it stopped early, after round 1


@pytest.mark.parametrize("mode", [dict(nprobe=6), dict(recall_target=0.9),
                                  dict(recall_target=0.9, rounds=1),
                                  dict(nprobe=8, union_cap=5)])
def test_search_batch_matches_reference(built, mode):
    _, j, state, _ = built
    ds = built[0]
    q = jds.queries_near(ds, 16, seed=8)
    je, _, te, _ = _engines(j, state, timpl="union_cuda")
    p = _port(state)
    rj = je.search_batch(j, q, K, **mode)
    rt = te.search_batch(p, q, K, **mode)
    assert_same_batch(rt, rj, q)
    if mode == dict(recall_target=0.9):   # the round loop really ran
        assert rt.rounds > 1 and rt.round_trace is not None


@pytest.mark.parametrize("storage", ["bf16", "int8"])
def test_storage_dtypes_match_reference(built, storage):
    _, j, state, q = built
    je, js, te, ts = _engines(j, state, nprobe=8, storage_dtype=storage)
    assert ts.data.dtype == {"bf16": torch.bfloat16,
                             "int8": torch.int8}[storage]
    dj, ij = je.search_fixed(jnp.asarray(q), js)
    dt, it = te.search_fixed(q, ts)
    if storage == "int8":
        # int8 codes give the same ids; distances to the oracle's rounding
        np.testing.assert_array_equal(it.numpy(), np.asarray(ij))
    assert_same_topk(q, dt, it, dj, ij)
    p = _port(state)
    rj = je.search_batch(j, q, K, nprobe=6)
    rt = te.search_batch(p, q, K, nprobe=6)
    assert_same_batch(rt, rj, q)


def test_journal_refresh_counts_match_reference(built):
    ds, j, state, _ = built
    p = _port(state)
    je, _, te, _ = _engines(j, state, nprobe=32)
    jc = JIndex.build(ds.vectors, num_partitions=32, kmeans_iters=4)
    engines = ((je, jc, jnp.asarray), (te, p, lambda a: a))
    q = jds.queries_near(ds, 4, seed=9)
    new_ids = np.arange(60_000, 60_004)
    for eng, idx, conv in engines:
        ss = eng.refresh_snapshot(idx)
        assert (eng.full_rebuilds, eng.delta_refreshes) == (1, 0)
        idx.insert(q * 0.999, new_ids)
        ss2 = eng.refresh_snapshot(idx)
        assert (eng.full_rebuilds, eng.delta_refreshes) == (1, 1)
        assert ss2.capacity == ss.capacity
        _, i = eng.search_fixed(conv(q), ss2)
        assert set(np.asarray(i).ravel().tolist()) >= set(new_ids.tolist())
        idx.journal.record(structural=True, reason="test")
        eng.refresh_snapshot(idx)
        assert (eng.full_rebuilds, eng.delta_refreshes) == (2, 1)
    # the delta-patched block equals a fresh one
    te.refresh_snapshot(p)
    p.insert(q * 0.998, new_ids + 10)
    patched = te.refresh_snapshot(p)
    assert te.delta_refreshes == 2
    fresh = IndexSnapshot.from_index(p, capacity=patched.capacity)
    for name in ("data", "ids", "centroids", "sizes"):
        assert torch.equal(getattr(patched, name), getattr(fresh, name))


def test_int8_block_is_rebuilt_on_a_delta_only(built):
    ds, _, state, _ = built
    p = _port(state)
    _, tm = _meshes()
    eng = ShardedQuakeEngine(tm, EngineConfig(
        k=K, part_axes=("pod", "data"), scan_impl="union_cuda",
        storage_dtype="int8"))
    first = eng.refresh_snapshot(p)
    assert eng.refresh_snapshot(p) is first
    p.insert(jds.queries_near(ds, 4, seed=9), np.arange(70_000, 70_004))
    assert eng.refresh_snapshot(p) is not first
    assert (eng.full_rebuilds, eng.delta_refreshes) == (2, 0)
    fresh = IndexSnapshot.from_index(p, dtype=torch.int8,
                                     headroom=p.config.snapshot_headroom)
    assert torch.equal(eng._snap.data, fresh.data)


# ---------------------------------------------------------------------------
# the two faults of the JAX engine (ROADMAP Queue 3), smallest input
# ---------------------------------------------------------------------------

def test_reference_storage_faults_are_not_copied():
    ds = jds.clustered(2000, 16, n_clusters=8, seed=0)
    j = JIndex.build(ds.vectors, num_partitions=16)
    state = export_jax_index(j)
    q = jds.queries_near(ds, 8, seed=2)
    gt = ds.ground_truth(q, K)
    # the exact top-k of the rows a bf16 snapshot stores
    xb = torch.as_tensor(ds.vectors).to(torch.bfloat16).double().numpy()
    gt_bf16 = np.argsort(((q[:, None, :] - xb[None]) ** 2).sum(-1),
                         axis=1, kind="stable")[:, :K]
    for storage in ("bf16", "int8"):
        je, js, te, ts = _engines(j, state, timpl="union_cuda", nprobe=16,
                                  storage_dtype=storage)
        _, ij = je.search_bruteforce(jnp.asarray(q), js)
        if storage == "bf16":
            # the JAX engine sums ||x||^2 in bf16; the port in f32
            assert _recall(ij, gt) == pytest.approx(0.8625)
            _, it = te.search_bruteforce(q, ts)
            assert _recall(it, gt_bf16) == 1.0
            assert _recall(it, gt) == pytest.approx(0.9875)
            continue
        # the JAX engine reads the int8 residual codes as vectors
        assert _recall(ij, gt) == 0.0
        with pytest.raises(ValueError, match="int8 residual codes"):
            te.search_bruteforce(q, ts)
        _, it = te.search_fixed(q, ts)
        assert _recall(it, gt) >= 0.9
    jm, tm = _meshes()
    te = ShardedQuakeEngine(tm, EngineConfig(
        k=K, part_axes=("pod", "data"), scan_impl="gather",
        storage_dtype="int8"))
    ts = te.shard_snapshot(IndexSnapshot.from_index(_port(state)))
    with pytest.raises(ValueError, match="gather scan reads int8"):
        te.search_fixed(q, ts)
    with pytest.raises(ValueError, match="gather scan reads int8"):
        te.search_adaptive(q, ts)


def test_engine_config_and_padding():
    _, tm = _meshes()
    for bad in (dict(scan_impl="union_pallas"), dict(storage_dtype="i4"),
                dict(metric="cos")):
        with pytest.raises(ValueError):
            ShardedQuakeEngine(tm, EngineConfig(**bad))
    with pytest.raises(ValueError, match="also a partition axis"):
        ShardedQuakeEngine(tm, EngineConfig(part_axes=("data", "model")))
    eng = ShardedQuakeEngine(tm, EngineConfig(part_axes=("pod", "data")))
    assert (eng.n_part_shards, eng.batch_axis, eng.n_batch_shards) == \
        (1, "model", 1)
    q = torch.ones(5, 3)
    assert eng.pad_queries(q) is q


# ---------------------------------------------------------------------------
# four ranks over torch.distributed against four JAX devices
# ---------------------------------------------------------------------------

LAYOUTS = {"numa": dict(part_axes=("pod", "data"), batch_axis="model"),
           "replicated": dict(part_axes=(), batch_axis="data")}
ENGINE = dict(k=K, nprobe=8, recall_target=0.95, chunk=1)

COMMON = textwrap.dedent("""
    import sys
    import numpy as np
    LAYOUTS = {layouts!r}
    ENGINE = {engine!r}


    def run_all(make_engine, make_snap, index, q, conv, take):
        out = {{}}
        for name, kw in LAYOUTS.items():
            eng = make_engine(dict(ENGINE, **kw))
            snap = make_snap(eng)
            for entry in ("bruteforce", "fixed", "adaptive"):
                res = getattr(eng, "search_" + entry)(conv(q), snap)
                for f, v in zip(("d", "i", "r", "nprobe"), res):
                    out[f"{{name}}.{{entry}}.{{f}}"] = take(v)
            for mode, kw2 in (("nprobe", dict(nprobe=6)),
                              ("aps", dict(recall_target=0.9))):
                r = eng.search_batch(index, q, ENGINE["k"], **kw2)
                for f in ("ids", "dists", "nprobe", "rounds",
                          "partitions_scanned", "vectors_scanned",
                          "comparisons", "recall_estimate"):
                    v = getattr(r, f)
                    if v is not None:
                        out[f"{{name}}.batch_{{mode}}.{{f}}"] = np.asarray(v)
        return out
""").format(layouts=LAYOUTS, engine=ENGINE)

JAX_SCRIPT = COMMON + textwrap.dedent("""
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.core import (EngineConfig, IndexSnapshot, QuakeIndex,
                            ShardedQuakeEngine)
    assert len(jax.devices()) == 4
    root, inputs, dest = sys.argv[1:4]
    index = QuakeIndex.load(root)
    mesh = Mesh(np.array(jax.devices()).reshape(1, 2, 2),
                ("pod", "data", "model"))
    out = run_all(
        lambda kw: ShardedQuakeEngine(mesh, EngineConfig(
            scan_impl="union_jnp", **kw)),
        lambda eng: eng.shard_snapshot(IndexSnapshot.from_index(
            index, pad_partitions_to=eng.n_part_shards)),
        index, np.load(inputs)["q"], jnp.asarray, np.asarray)
    np.savez(dest, **out)
""")

TORCH_SCRIPT = COMMON + textwrap.dedent("""
    import torch
    import torch.distributed as dist
    root, inputs, dest, init, rank, scripts = sys.argv[1:7]
    sys.path.insert(0, scripts)
    from engine_ranks import plans_agree, record_plans
    dist.init_process_group("gloo", init_method="file://" + init,
                            world_size=4, rank=int(rank))
    try:
        from repro_torch.core import (EngineConfig, IndexSnapshot,
                                      QuakeIndex, ShardedQuakeEngine)
        from repro_torch.launch.mesh import Mesh
        index = QuakeIndex.load(root, device="cpu")
        mesh = Mesh((1, 2, 2), ("pod", "data", "model"), device="cpu")
        # every rank plans search_batch on its own copy of the index: the
        # (B, P) probe matrices it scans must agree across ranks
        with record_plans([]) as plans:
            out = run_all(
                lambda kw: ShardedQuakeEngine(mesh, EngineConfig(
                    scan_impl="union_cuda", **kw)),
                lambda eng: eng.shard_snapshot(IndexSnapshot.from_index(
                    index, pad_partitions_to=eng.n_part_shards)),
                index, np.load(inputs)["q"], lambda a: a,
                lambda t: t.numpy() if torch.is_tensor(t) else np.asarray(t))
        assert len(plans) > 2
        out["plans"] = plans_agree(plans, "cpu")
        out["part_index"] = np.asarray(
            [mesh.index(("pod", "data")), mesh.index(("model",))])
        # an odd batch is padded to the batch shards; its rows are the
        # even batch's
        q = np.load(inputs)["q"]
        eng = ShardedQuakeEngine(mesh, EngineConfig(
            scan_impl="union_cuda", **dict(ENGINE, **LAYOUTS["numa"])))
        snap = eng.refresh_snapshot(index)
        d12, i12 = eng.search_fixed(q, snap)
        d11, i11 = eng.search_fixed(q[:11], snap)
        assert torch.equal(i11, i12[:11])
        assert torch.allclose(d11, d12[:11], rtol=1e-6, atol=1e-4)
        # a journal delta patches each rank's own block in place: the
        # patched block equals a fresh one, and serves the new rows
        new_ids = np.arange(90_000, 90_000 + len(q))
        index.insert(q * 0.999, new_ids)
        snap = eng.refresh_snapshot(index)
        assert (eng.full_rebuilds, eng.delta_refreshes) == (1, 1)
        lo = eng.part_index * snap.num_partitions
        fresh = IndexSnapshot.from_index(
            index, capacity=snap.capacity, pad_partitions_to=2,
            parts=(lo, lo + snap.num_partitions))
        for name in ("data", "ids", "centroids", "sizes"):
            assert torch.equal(getattr(snap, name), getattr(fresh, name))
        _, ids = eng.search_fixed(q, snap)
        assert all(new_ids[r] in ids[r].tolist() for r in range(len(q)))
        np.savez(dest, **out)
    finally:
        dist.destroy_process_group()
""")


def test_four_gloo_ranks_match_four_jax_devices(built, tmp_path):
    ds, j, _, _ = built
    root = tmp_path / "index"
    j.save(str(root))
    q = jds.queries_near(ds, 12, seed=5)
    np.savez(tmp_path / "inputs.npz", q=q)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    # one thread a process: the five subprocesses share the test run's cores
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                "--xla_cpu_multi_thread_eigen=false "
                "intra_op_parallelism_threads=1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", JAX_SCRIPT, str(root),
         str(tmp_path / "inputs.npz"), str(tmp_path / "jax.npz")],
        env=jenv, stdout=subprocess.PIPE, stderr=subprocess.PIPE)]
    for r in range(4):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", TORCH_SCRIPT, str(root),
             str(tmp_path / "inputs.npz"), str(tmp_path / f"rank{r}.npz"),
             str(tmp_path / "init"), str(r), SCRIPTS],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE))
    try:
        for p in procs:
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, err.decode()[-3000:]
    finally:
        for p in procs:
            p.kill()
    ref = dict(np.load(tmp_path / "jax.npz"))
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(4)]
    # ranks (pod, data, model) row-major: partition shard pod*2 + data,
    # batch shard model
    assert [tuple(r["part_index"]) for r in ranks] == [(0, 0), (0, 1),
                                                       (1, 0), (1, 1)]
    for r in ranks[1:]:           # every rank returns the whole batch
        for key, v in ranks[0].items():
            if key != "part_index":
                np.testing.assert_array_equal(r[key], v, err_msg=key)
    got = ranks[0]
    gt = ds.ground_truth(q, K)
    for name in LAYOUTS:
        for entry in ("bruteforce", "fixed", "adaptive"):
            key = f"{name}.{entry}"
            assert_same_topk(q, got[key + ".d"], got[key + ".i"],
                             ref[key + ".d"], ref[key + ".i"])
        assert _recall(got[f"{name}.bruteforce.i"], gt) == 1.0
        np.testing.assert_allclose(got[f"{name}.adaptive.r"],
                                   ref[f"{name}.adaptive.r"], rtol=1e-4)
        np.testing.assert_array_equal(got[f"{name}.adaptive.nprobe"],
                                      ref[f"{name}.adaptive.nprobe"])
        for mode in ("nprobe", "aps"):
            key = f"{name}.batch_{mode}"
            assert_same_topk(q, got[key + ".dists"], got[key + ".ids"],
                             ref[key + ".dists"], ref[key + ".ids"])
            for f in ("nprobe", "rounds", "partitions_scanned",
                      "vectors_scanned", "comparisons"):
                np.testing.assert_array_equal(got[f"{key}.{f}"],
                                              ref[f"{key}.{f}"],
                                              err_msg=f"{key}.{f}")
            if f"{key}.recall_estimate" in ref:
                np.testing.assert_allclose(got[f"{key}.recall_estimate"],
                                           ref[f"{key}.recall_estimate"],
                                           rtol=1e-4, equal_nan=True)
        assert int(got[f"{name}.batch_aps.rounds"]) > 1

"""The port's examples (``repro_torch.examples``) against the JAX package's
(``examples/*.py``) on the CPU, at reduced sizes.

The reference examples take no size arguments, so each test runs the
same sequence of ``repro`` calls as the reference example at the reduced
size (``dynamic_workload`` and ``train_lm`` call the reference example's
own functions) beside the port's ``run(...)`` at that size, and holds:

- the numbers that do not depend on floating-point detail equal: vectors
  and partitions after the build and after maintenance, months, steps,
  restarts, the brute-force ids;
- recalls within 0.02 (k-means and maintenance agree to rounding, not
  bit for bit, so a query may see one neighbour more or less);
- the two-tower embeddings within 1e-5 (the same weights, carried over by
  ``convert.recsys_params_from_jax``);
- ``train_lm``'s steps, restarts and resume point equal, its first loss
  near ln(vocab) in both (each package draws its own weights).

Each ``main`` defaults to the card: without CUDA it raises.
"""
import contextlib
import importlib.util
import io
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from repro.core import EngineConfig as JEngineConfig
from repro.core import IndexSnapshot as JSnapshot
from repro.core import Maintainer as JMaintainer
from repro.core import QuakeConfig as JConfig
from repro.core import QuakeIndex as JIndex
from repro.core import ShardedQuakeEngine as JEngine
from repro.data import datasets as jds
from repro.data.wikipedia import wikipedia_workload as jwikipedia
from repro.models import recsys as jrecsys
from repro_torch.examples import (dynamic_workload, quickstart,
                                  retrieval_serving, train_lm)
from repro_torch.models.convert import recsys_params_from_jax

ROOT = Path(__file__).resolve().parents[1]
RECALL_TOL = 0.02


def _reference_example(name: str):
    """The JAX package's ``examples/<name>.py`` as a module."""
    spec = importlib.util.spec_from_file_location(
        f"reference_example_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recall(ids, gt) -> float:
    return len(set(ids.tolist()) & set(gt.tolist())) / len(gt)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

QS = dict(n=3000, dim=16, n_clusters=16, n_queries=40, n_burst=600,
          n_hot=60)


def _reference_quickstart(n, dim, n_clusters, n_queries, n_burst, n_hot,
                          k=10):
    """``examples/quickstart.py``'s steps at these sizes."""
    rng = np.random.default_rng(0)
    ds = jds.clustered(n, dim, n_clusters=n_clusters, seed=0)
    idx = JIndex.build(ds.vectors, ids=np.arange(ds.n),
                       config=JConfig(metric="l2"))
    out = {"partitions": idx.levels[0].num_partitions}
    q = jds.queries_near(ds, n_queries, seed=1)
    gt = ds.ground_truth(q, k)
    rs = [idx.search(q[i], k=k, recall_target=0.9) for i in range(len(q))]
    out["recall"] = float(np.mean([_recall(r.ids, gt[i])
                                   for i, r in enumerate(rs)]))
    out["nprobe"] = float(np.mean([r.nprobe[0] for r in rs]))
    hot = ds.vectors[ds.cluster_of == 0]
    burst = hot[rng.integers(0, len(hot), n_burst)] + \
        rng.normal(scale=0.05, size=(n_burst, ds.dim)).astype(np.float32)
    idx.insert(burst, np.arange(ds.n, ds.n + n_burst))
    hot_q = burst[rng.integers(0, len(burst), n_hot)] + \
        rng.normal(scale=0.05, size=(n_hot, ds.dim)).astype(np.float32)
    for i in range(len(hot_q)):
        idx.search(hot_q[i], k=k, recall_target=0.9)
    m = JMaintainer(idx)
    out["cost_before"] = m.total_cost()
    m.run()
    out["cost_after"] = m.total_cost()
    idx.check_invariants()
    all_vecs = np.concatenate([ds.vectors, burst])
    all_ds = jds.VectorDataset(all_vecs, np.zeros(len(all_vecs), np.int64),
                               ds.centers, metric="l2")
    gt2 = all_ds.ground_truth(q, k)
    out["recall_after"] = float(np.mean(
        [_recall(idx.search(q[i], k, recall_target=0.9).ids, gt2[i])
         for i in range(len(q))]))
    out.update(vectors_after=idx.num_vectors,
               partitions_after=idx.levels[0].num_partitions)
    return out


@pytest.fixture(scope="module")
def quickstart_runs():
    return (quickstart.run(device="cpu", **QS),
            _reference_quickstart(**QS))


@pytest.mark.parametrize("key", ["partitions", "vectors_after",
                                 "partitions_after"])
def test_quickstart_counts_equal_reference(quickstart_runs, key):
    got, want = quickstart_runs
    assert got[key] == want[key]


@pytest.mark.parametrize("key", ["recall", "recall_after"])
def test_quickstart_recall_near_reference(quickstart_runs, key):
    got, want = quickstart_runs
    assert abs(got[key] - want[key]) <= RECALL_TOL, (got[key], want[key])


def test_quickstart_maintenance_lowers_cost(quickstart_runs):
    got, want = quickstart_runs
    assert got["cost_after"] < got["cost_before"]
    assert want["cost_after"] < want["cost_before"]
    assert abs(got["nprobe"] - want["nprobe"]) <= 1.0
    assert got["us_per_query"] > 0 and got["build_s"] > 0


def test_quickstart_keeps_its_index():
    out = quickstart.run(n=800, dim=8, n_clusters=8, n_queries=5,
                         n_burst=50, n_hot=5, device="cpu")
    idx, ds = out["index"], out["dataset"]
    assert idx.num_vectors == ds.n == 850
    idx.check_invariants()


# ---------------------------------------------------------------------------
# dynamic_workload
# ---------------------------------------------------------------------------

DW = dict(n_total=4000, dim=16, months=3, queries_per_month=40)
_ROW = re.compile(r"^\s*(\d+)\s+(\d+)\s+(\d+)\s+([\d.]+)\s+(\d+)\s+"
                  r"([\d.]+)\s+(\d+)\s*$")


@pytest.fixture(scope="module")
def dynamic_runs():
    got = dynamic_workload.run(device="cpu", **DW)
    ref = _reference_example("dynamic_workload")
    wl = jwikipedia(seed=0, **DW)
    want = {}
    for method in ("static", "quake"):
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            ref.run(method, wl)            # qs[:60], as the port's
        want[method] = [
            {"month": int(m[1]), "n_vec": int(m[2]), "parts": int(m[3]),
             "recall": float(m[4])}
            for m in map(_ROW.match, buf.getvalue().splitlines()) if m]
    return got, want


@pytest.mark.parametrize("method", ["static", "quake"])
def test_dynamic_workload_months_and_partitions_equal(dynamic_runs, method):
    got, want = dynamic_runs
    assert len(got[method]) == len(want[method]) >= DW["months"]
    for g, w in zip(got[method], want[method]):
        assert (g["month"], g["n_vec"], g["parts"]) == \
            (w["month"], w["n_vec"], w["parts"])


@pytest.mark.parametrize("method", ["static", "quake"])
def test_dynamic_workload_recall_near_reference(dynamic_runs, method):
    got, want = dynamic_runs
    for g, w in zip(got[method], want[method]):
        # the reference prints three decimals
        assert abs(g["recall"] - w["recall"]) <= RECALL_TOL + 5e-4


# ---------------------------------------------------------------------------
# retrieval_serving
# ---------------------------------------------------------------------------

RS = dict(user_vocab=2000, item_vocab=6000, embed_dim=16, tower_mlp=(32, 16),
          hist_len=8, batch=48, k=10)


def _reference_retrieval(params, cfg, history, batch, k):
    """``examples/retrieval_serving.py``'s steps at these sizes."""
    items = np.asarray(jrecsys.item_repr(params,
                                         jnp.arange(cfg.item_vocab), cfg))
    hb = {"history": jnp.asarray(history),
          "history_mask": jnp.ones((batch, cfg.hist_len), bool)}
    users = np.asarray(jrecsys.user_repr(params, hb, cfg))
    gt = np.argsort(-(users @ items.T), axis=1)[:, :k]
    idx = JIndex.build(items, config=JConfig(metric="ip"))
    rs = [idx.search(users[i], k, recall_target=0.9) for i in range(batch)]
    out = {"items": items, "gt": gt,
           "quake_recall": float(np.mean([_recall(r.ids, gt[i])
                                          for i, r in enumerate(rs)]))}
    mesh = Mesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                ("pod", "data", "model"))
    eng = JEngine(mesh, JEngineConfig(k=k, nprobe=16, recall_target=0.9,
                                      part_axes=("pod", "data")))
    snap = eng.shard_snapshot(JSnapshot.from_index(idx))
    qs = eng.pad_queries(jnp.asarray(users))
    _, i_e, _, nprobe = eng.search_adaptive(qs, snap)
    out["engine_recall"] = float(np.mean(
        [_recall(np.asarray(i_e[r]), gt[r]) for r in range(batch)]))
    out["engine_nprobe"] = float(np.mean(np.asarray(nprobe)))
    eng8 = JEngine(mesh, JEngineConfig(
        k=k, nprobe=24, part_axes=("pod", "data"),
        scan_impl="union_pallas", storage_dtype="int8"))
    ss8 = eng8.shard_snapshot(JSnapshot.from_index(idx))
    _, i_8 = eng8.search_fixed(qs, ss8)
    out["int8_recall"] = float(np.mean(
        [_recall(np.asarray(i_8[r]), gt[r]) for r in range(batch)]))
    return out


@pytest.fixture(scope="module")
def retrieval_runs():
    jcfg = jrecsys.TwoTowerConfig(
        user_vocab=RS["user_vocab"], item_vocab=RS["item_vocab"],
        embed_dim=RS["embed_dim"], tower_mlp=RS["tower_mlp"],
        hist_len=RS["hist_len"])
    params = jrecsys.twotower_init(jax.random.PRNGKey(0), jcfg)
    model = recsys_params_from_jax(
        "two-tower-retrieval", jax.tree.map(np.asarray, params),
        retrieval_serving.recsys.TwoTowerConfig(
            **{k: RS[k] for k in ("user_vocab", "item_vocab", "embed_dim",
                                  "tower_mlp", "hist_len")}),
        device="cpu")
    history = np.random.default_rng(0).integers(
        0, RS["user_vocab"], (RS["batch"], RS["hist_len"]))
    got = retrieval_serving.run(device="cpu", model=model, history=history,
                                **RS)
    want = _reference_retrieval(params, jcfg, history, RS["batch"], RS["k"])
    return got, want, model


def test_retrieval_embeddings_and_brute_force_equal_reference(
        retrieval_runs):
    got, want, model = retrieval_runs
    assert (got["items"], got["dim"]) == want["items"].shape
    with torch.no_grad():
        items = retrieval_serving.recsys.item_repr(
            model, torch.arange(RS["item_vocab"])).numpy()
    np.testing.assert_allclose(items, want["items"], rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("key", ["quake_recall", "engine_recall",
                                 "int8_recall"])
def test_retrieval_recall_near_reference(retrieval_runs, key):
    got, want, _ = retrieval_runs
    assert abs(got[key] - want[key]) <= RECALL_TOL, (got[key], want[key])
    assert got[key] >= 0.5


def test_retrieval_engine_nprobe_near_reference(retrieval_runs):
    got, want, _ = retrieval_runs
    assert abs(got["engine_nprobe"] - want["engine_nprobe"]) <= 1.0
    assert got["quake_scanned"] < RS["item_vocab"]


# ---------------------------------------------------------------------------
# train_lm
# ---------------------------------------------------------------------------

_DONE = re.compile(r"done: (\d+) steps in [\d.]+s, loss ([\d.]+) -> "
                   r"([\d.]+), restarts=(\d+)")


def test_train_lm_like_reference(tmp_path, capsys):
    argv = ["--preset", "lm-tiny", "--steps", "6", "--batch", "2", "--seq",
            "32", "--ckpt-every", "3"]
    got = train_lm.run(argv + ["--ckpt-dir", str(tmp_path / "port")],
                       device="cpu")
    ref = _reference_example("train_lm")
    ref.main(argv + ["--ckpt-dir", str(tmp_path / "ref")])
    m = _DONE.search(capsys.readouterr().out.splitlines()[-1])
    steps, first, _, restarts = int(m[1]), float(m[2]), m[3], int(m[4])
    assert (got["steps"], got["restarts"]) == (steps, restarts) == (6, 0)
    # each draws its own weights (torch's generator against JAX's keys; the
    # same weights give the same loss, test_torch_train.py): both start
    # near ln(vocab) = 7.62
    for loss in (got["loss_first"], first):
        assert abs(loss - np.log(2048)) <= 0.5
    # a second run on the same directory resumes at the last checkpoint
    again = train_lm.run(argv + ["--ckpt-dir", str(tmp_path / "port")],
                         device="cpu")
    assert again["resumed_from"] == 6 and again["steps"] == 0


def test_train_lm_main_defaults():
    assert train_lm.DEFAULT_ARGV == ["--preset", "lm-tiny", "--steps", "60",
                                     "--batch", "8", "--seq", "128",
                                     "--ckpt-every", "25"]


@pytest.mark.parametrize("mod", [quickstart, dynamic_workload,
                                 retrieval_serving])
def test_examples_default_to_the_card(mod):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mod.run(**{"quickstart": dict(n=200, dim=4, n_clusters=2),
                   "dynamic_workload": dict(n_total=300, dim=4, months=1,
                                            queries_per_month=4),
                   "retrieval_serving": dict(user_vocab=20, item_vocab=40,
                                             embed_dim=4, tower_mlp=(4,),
                                             batch=4)}[
            mod.__name__.rsplit(".", 1)[1]])


# ---------------------------------------------------------------------------
# the dry-run's op-level attribution (launch.dryrun --profile)
# ---------------------------------------------------------------------------

PROFILE_CELLS = [("gat-cora", "full_graph_sm", False),
                 ("quake-ann", "serve_adaptive_1k", False),
                 ("qwen2.5-14b", "train_4k", True)]


@pytest.fixture(scope="module")
def profile_counts():
    from repro_torch import configs
    from repro_torch.launch.mesh import make_production_mesh
    return {f"{n}/{s}": configs.get_arch(n).build(
        s, make_production_mesh(), smoke=smoke).count()
        for n, s, smoke in PROFILE_CELLS}


@pytest.mark.parametrize("cell", [f"{n}/{s}" for n, s, _ in PROFILE_CELLS])
def test_top_collectives_add_up_to_the_count(profile_counts, cell):
    from repro_torch.roofline.profile import top_collectives
    res = profile_counts[cell]
    rows = top_collectives(res, n=10 ** 6)
    assert rows and set(rows[0]) >= {"kind", "shape", "trips",
                                     "wire_gb_total", "comp"}
    assert sum(r["trips"] for r in rows) == res["collectives"]["ops"]
    assert sum(r["wire_gb_total"] for r in rows) * 1e9 == pytest.approx(
        res["collectives"]["wire_bytes"], rel=1e-12)
    gbs = [r["wire_gb_total"] for r in rows]
    assert gbs == sorted(gbs, reverse=True)
    assert {r["comp"] for r in rows} <= {"forward", "backward"}
    assert top_collectives(res, 3) == rows[:3]


@pytest.mark.parametrize("cell", [f"{n}/{s}" for n, s, _ in PROFILE_CELLS])
def test_top_memory_ops_add_up_to_the_ops_bytes(profile_counts, cell):
    from repro_torch.roofline.profile import top_memory_ops
    res = profile_counts[cell]
    rows = top_memory_ops(res, n=10 ** 6)
    kernels = sum(w["bytes"] for w in res["kernels"].values())
    assert sum(gb for _, gb, _ in rows) * 1e9 == pytest.approx(
        res["bytes_accessed"] - kernels, rel=1e-12)
    assert [gb for _, gb, _ in rows] == sorted(
        (gb for _, gb, _ in rows), reverse=True)
    assert all(op.startswith("aten.") and re.fullmatch(r"\w+\[[\d,]*\]", ex)
               for op, _, ex in rows)


def test_recorded_collectives_keep_their_result_shape():
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh()
    t = torch.zeros((4, 3), device="meta")
    with mesh.recording() as recs:
        mesh._ag(t, ("data",), 1)
        mesh._rs(torch.zeros((32, 3), device="meta"), ("model",), 0)
        mesh._ar(t.to(torch.bfloat16), ("data",), "SUM")
    assert [(r["kind"], r["shape"], r["dtype"]) for r in recs] == [
        ("all-gather", (4, 48), "float32"),
        ("reduce-scatter", (2, 3), "float32"),
        ("all-reduce", (4, 3), "bfloat16")]


def test_dryrun_profile_prints_both_tables(capsys):
    from repro_torch.launch import dryrun
    dryrun.run_cell("gat-cora", "full_graph_sm", False, profile=True)
    out = capsys.readouterr().out
    assert "top collectives" in out and "top memory opcode classes" in out
    assert re.search(r"all-reduce\s+f32\[2708,8,8\]", out)

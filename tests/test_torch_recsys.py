"""The port's recsys serving path (repro_torch.models.recsys) against the
JAX package.

Every case gives both packages the same numpy inputs: the MLP and
embedding layers against ``repro.models.layers``, the four models'
forwards, the serve adapters and the retrieval adapters against
``repro.models.recsys`` and ``repro.configs.families`` at the smoke
configs, the weights carried over by ``recsys_params_from_jax``; the
gathers' out-of-range semantics against ``jnp.take`` (eager, as the
reference's CPU tests run it); the configs and ``RecsysPipeline`` field by
field and byte by byte; and a small two-tower corpus served through the
port's ``QuakeIndex(metric="ip")``.

Tolerances: layers to rtol = atol = 1e-5; model outputs to 1e-4 * |x| +
1e-4 (two frameworks summing in other orders through several layers);
top-k ids equal except where the two scores lie within that tolerance
(near-ties).  Chunked and unchunked calls agree to 1e-6 * |x| + 1e-6:
the GEMMs block by their row count, so the last bit can differ.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import families as jfam
from repro.configs import recsys_archs as jarch
from repro.data import pipelines as jpipe
from repro.models import layers as jlayers
from repro.models import recsys as jrs
from repro_torch.configs import recsys_archs as archs
from repro_torch.core import QuakeConfig, QuakeIndex
from repro_torch.data import RecsysPipeline
from repro_torch.models import layers, recsys as rs
from repro_torch.models.convert import (recsys_config_from_jax,
                                        recsys_params_from_jax)

LAYER_TOL = 1e-5
MODEL_TOL = 1e-4
CHUNK_TOL = 1e-6
N_CAND = jfam.RECSYS_SMOKE_SHAPES["retrieval_cand"]["n_cand"]   # 512
NAMES = list(archs.ARCHS)
# the reference's config functions, by the port's
JFNS = {"din": ("din", "din_smoke"), "sasrec": ("sasrec", "sasrec_smoke"),
        "two-tower-retrieval": ("two_tower", "two_tower_smoke"),
        "dlrm-rm2": ("dlrm_rm2", "dlrm_smoke")}
JINIT = {"din": jrs.din_init, "sasrec": jrs.sasrec_init,
         "two-tower-retrieval": jrs.twotower_init,
         "dlrm-rm2": jrs.dlrm_init}
USER_KEYS = ("history", "history_mask", "dense")


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _same_topk(ref, out, k, tol):
    """Top-k of ``out`` against ``ref`` (scores, larger is better): ids
    equal by position except where the two ids' reference scores lie
    within ``tol * |x| + tol`` of each other."""
    ref, out = np.asarray(ref, np.float64), np.asarray(out, np.float64)
    i_r = np.argsort(-ref, kind="stable")[:k]
    i_o = np.argsort(-out, kind="stable")[:k]
    diff = i_r != i_o
    bound = 2 * (tol * np.abs(ref[i_r]) + tol)
    assert (np.abs(ref[i_r] - ref[i_o])[diff] <= bound[diff]).all()


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_init_mlp_draws_with_fan_in_of_axis_0():
    g = torch.Generator().manual_seed(0)
    dims = (400, 300, 1)
    mlp = layers.init_mlp(g, dims)
    assert [tuple(w.shape) for w in mlp.w] == [(400, 300), (300, 1)]
    assert [tuple(b.shape) for b in mlp.b] == [(300,), (1,)]
    assert all(not b.any() for b in mlp.b)
    # std 1/sqrt(fan_in) over axis 0: 0.05 for (400, 300); axis 1 would
    # give 0.0577
    assert abs(float(mlp.w[0].std()) - 400 ** -0.5) < 0.001
    assert all(p.device.type == "cpu" and p.dtype == torch.float32
               for p in mlp.parameters())


@pytest.mark.parametrize("final_act", [False, True])
@pytest.mark.parametrize("act", ["relu", "sigmoid"])
def test_apply_mlp_matches_reference(final_act, act):
    rng = np.random.default_rng(5)
    dims = (24, 40, 16, 3)
    params = jax.tree.map(np.asarray, jlayers.init_mlp(
        jax.random.PRNGKey(1), dims))
    params["b"] = [rng.normal(size=b.shape).astype(np.float32)
                   for b in params["b"]]
    x = rng.normal(size=(7, 5, 24)).astype(np.float32)
    mlp = layers.MLP(dims, device="cpu")
    mlp.load_state_dict({f"{k}.{i}": _t(v) for k in ("w", "b")
                         for i, v in enumerate(params[k])})
    ref = jlayers.apply_mlp(params, jnp.asarray(x),
                            act=getattr(jax.nn, act), final_act=final_act)
    out = layers.apply_mlp(mlp, _t(x), act=getattr(torch, act),
                           final_act=final_act)
    assert tuple(out.shape) == ref.shape == (7, 5, 3)
    _close(out.numpy(), ref, LAYER_TOL)


@pytest.mark.parametrize("valid", [False, True])
@pytest.mark.parametrize("weights", [False, True])
@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_embedding_bag_matches_reference(mode, weights, valid):
    """Ids out of range both ways (clip: past the table reads the last
    row, negative reads row 0), and a bag with no valid entry."""
    rng = np.random.default_rng(9)
    v, d = 40, 6
    table = rng.normal(size=(v, d)).astype(np.float32)
    ids = rng.integers(0, v, (3, 4, 7)).astype(np.int32)
    ids[0, 0, :3] = [v, v + 9, -1]
    ids[1, 2, :2] = [-v - 3, v - 1]
    w = rng.random((3, 4, 7)).astype(np.float32) if weights else None
    ok = rng.random((3, 4, 7)) < 0.7 if valid else None
    if valid:
        ok[2, 1] = False
    ref = jlayers.embedding_bag(
        jnp.asarray(table), jnp.asarray(ids), mode=mode,
        weights=None if w is None else jnp.asarray(w),
        valid=None if ok is None else jnp.asarray(ok))
    out = layers.embedding_bag(
        _t(table), _t(ids), weights=None if w is None else _t(w),
        valid=None if ok is None else _t(ok), mode=mode)
    assert tuple(out.shape) == ref.shape == (3, 4, d)
    _close(out.numpy(), ref, LAYER_TOL)


def test_embedding_bag_rejects_unknown_mode():
    with pytest.raises(ValueError, match="mode"):
        layers.embedding_bag(torch.zeros(3, 2), torch.zeros(1, 2,
                                                            dtype=torch.long),
                             mode="max")


@pytest.mark.parametrize("shape", [(9, 5), (9, 2, 3)])
def test_take_fill_matches_jnp_take_out_of_range(shape):
    """``jnp.take``'s default: -V..-1 wrap, past either end reads NaN."""
    table = np.random.default_rng(2).normal(size=shape).astype(np.float32)
    v = shape[0]
    ids = np.array([[0, v - 1, -1, -v], [v, v + 4, -v - 1, 3]], np.int32)
    ref = np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0))
    out = layers.take_fill(_t(table), _t(ids)).numpy()
    assert out.shape == ref.shape
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_array_equal(out[~np.isnan(ref)], ref[~np.isnan(ref)])


def test_dlrm_lookup_matches_reference_out_of_range():
    rng = np.random.default_rng(4)
    f, v, d = 5, 11, 3
    tables = rng.normal(size=(f, v, d)).astype(np.float32)
    sparse = rng.integers(0, v, (6, f)).astype(np.int32)
    sparse[0, :4] = [-1, v, -v, -v - 2]
    sparse[3, 4] = v + 100
    ref = np.asarray(jrs._dlrm_lookup(jnp.asarray(tables),
                                      jnp.asarray(sparse)))
    out = rs._dlrm_lookup(_t(tables), _t(sparse)).numpy()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    np.testing.assert_array_equal(out[~np.isnan(ref)], ref[~np.isnan(ref)])


@pytest.mark.parametrize("f", [2, 5, 27])
def test_dlrm_interaction_order_matches_reference(f):
    """``torch.triu_indices(f, f, 1)`` walks the strict upper triangle in
    the row-major order of ``jnp.triu_indices(f, k=1)``."""
    iu, ju = jnp.triu_indices(f, k=1)
    got = torch.triu_indices(f, f, 1)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(iu))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ju))
    assert got.shape[1] == f * (f - 1) // 2


# ---------------------------------------------------------------------------
# configs and the pipeline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", [0, 1], ids=["full", "smoke"])
@pytest.mark.parametrize("name", NAMES)
def test_config_matches_reference(name, size):
    jcfg = getattr(jarch, JFNS[name][size])()
    cfg = archs.ARCHS[name][size]()
    fields = dataclasses.asdict(jcfg)
    assert fields.pop("tp_axis") == "model"
    assert dataclasses.asdict(cfg) == fields
    assert recsys_config_from_jax(name, dataclasses.asdict(jcfg)) == cfg
    if name == "dlrm-rm2":
        assert cfg.n_interactions == jcfg.n_interactions
    assert rs.history_len(cfg) == getattr(
        jcfg, "seq_len", getattr(jcfg, "hist_len", 50))


def test_shapes_match_reference():
    assert archs.RECSYS_SHAPES == jfam.RECSYS_SHAPES
    assert archs.RECSYS_SMOKE_SHAPES == jfam.RECSYS_SMOKE_SHAPES


@pytest.mark.parametrize("seed,step,batch", [(0, 0, 5), (3, 17, 64),
                                             (11, 2, 1)])
def test_pipeline_batches_are_byte_equal(seed, step, batch):
    kw = dict(batch=batch, vocab=1000, hist_len=30, seed=seed)
    ref = jpipe.RecsysPipeline(**kw).batch_at(step)
    out = RecsysPipeline(**kw).batch_at(step)
    assert out.keys() == ref.keys()
    for k in ref:
        assert out[k].dtype == ref[k].dtype and out[k].shape == ref[k].shape
        assert out[k].tobytes() == ref[k].tobytes()


# ---------------------------------------------------------------------------
# the four models against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=NAMES)
def served(request):
    """One smoke config in both packages: the reference's params, the
    port's model from the same weights, and one pipeline batch."""
    name = request.param
    jcfg = getattr(jarch, JFNS[name][1])()
    params = jax.tree.map(np.asarray, JINIT[name](jax.random.PRNGKey(0),
                                                  jcfg))
    cfg = recsys_config_from_jax(name, dataclasses.asdict(jcfg))
    model = recsys_params_from_jax(name, params, cfg, device="cpu")
    batch = RecsysPipeline(batch=16, vocab=1000, hist_len=rs.history_len(cfg),
                           seed=1).batch_at(0)
    return dict(name=name, jcfg=jcfg, params=params, model=model,
                batch=batch)


def _jb(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _forward_pair(s, batch):
    """(reference, port) of the model's own forward: DIN and DLRM logits,
    SASRec's sequence representation, the two-tower's user and item
    embeddings (concatenated)."""
    name, p, jcfg, m = s["name"], s["params"], s["jcfg"], s["model"]
    jb, tb = _jb(batch), rs.batch_to(batch, "cpu")
    if name == "din":
        return jrs.din_forward(p, jb, jcfg), rs.din_forward(m, tb)
    if name == "dlrm-rm2":
        return jrs.dlrm_forward(p, jb, jcfg), rs.dlrm_forward(m, tb)
    if name == "sasrec":
        return (jrs.sasrec_encode(p, jb["history"], jb["history_mask"],
                                  jcfg),
                rs.sasrec_encode(m, tb["history"], tb["history_mask"]))
    ref = jnp.concatenate([jrs.user_repr(p, jb, jcfg),
                           jrs.item_repr(p, jb["target_item"], jcfg)])
    out = torch.cat([rs.user_repr(m, tb),
                     rs.item_repr(m, tb["target_item"])])
    return ref, out


def test_forward_matches_reference(served):
    ref, out = _forward_pair(served, served["batch"])
    assert tuple(out.shape) == ref.shape
    assert torch.isfinite(out).all()
    _close(out.numpy(), ref, MODEL_TOL)


def test_out_of_range_id_matches_reference(served):
    """An id past the table in the gathers with fill semantics (history,
    target, candidates, sparse fields) reads NaN in both packages; the
    two-tower's history goes through the clipping ``embedding_bag``."""
    batch = {k: v.copy() for k, v in served["batch"].items()}
    v = 1000
    batch["history"][0, 0] = v + 3
    batch["history"][1, 0] = -1
    batch["target_item"][2] = v
    batch["sparse"][3, 5] = -v - 1
    ref, out = _forward_pair(served, batch)
    ref, out = np.asarray(ref), out.numpy()
    assert np.isnan(ref).any()
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))
    ok = ~np.isnan(ref)
    _close(out[ok], ref[ok], MODEL_TOL)


def test_serve_matches_reference(served):
    """``recsys_serve``: DIN's and DLRM's forward, SASRec's and the two
    tower's score adapter (``_recsys_score_adapter``)."""
    name = served["name"]
    fwd = jfam.RECSYS_FNS[name][3]
    jb = _jb(served["batch"])
    if fwd is None:
        ref = jfam._recsys_score_adapter(served["params"], jb,
                                         served["jcfg"], model=name)
    else:
        ref = fwd(served["params"], jb, served["jcfg"])
    out = rs.recsys_serve(served["model"], rs.batch_to(served["batch"],
                                                       "cpu"))
    assert tuple(out.shape) == ref.shape == (16,)
    _close(out.numpy(), ref, MODEL_TOL)


def _user(batch, to):
    return {k: to(batch[k][:1]) for k in USER_KEYS}


def test_retrieval_matches_reference(served):
    """``_recsys_retrieval_adapter``: one user against ``n_cand``
    candidates (ids drawn over the vocabulary), scores and top-100."""
    name = served["name"]
    cand = np.random.default_rng(6).permutation(1000)[:N_CAND] \
        .astype(np.int32)
    ref = jfam._recsys_retrieval_adapter(
        served["params"], _user(served["batch"], jnp.asarray),
        jnp.asarray(cand), model=name, mcfg=served["jcfg"])
    out = rs.recsys_retrieval(served["model"],
                              _user(served["batch"], torch.as_tensor),
                              _t(cand))
    assert tuple(out.shape) == ref.shape == (N_CAND,)
    _close(out.numpy(), ref, MODEL_TOL)
    _same_topk(ref, out.numpy(), 100, MODEL_TOL)


def test_chunked_equals_unchunked(served):
    """Rows are independent: serve and retrieval in chunks of rows (the
    last one ragged) give the unchunked result."""
    m = served["model"]
    tb = rs.batch_to(served["batch"], "cpu")
    _close(rs.recsys_serve(m, tb, chunk=5).numpy(),
           rs.recsys_serve(m, tb).numpy(), CHUNK_TOL)
    user = _user(served["batch"], torch.as_tensor)
    cand = torch.arange(N_CAND, dtype=torch.int32)
    whole = rs.recsys_retrieval(m, user, cand).numpy()
    parts = rs.recsys_retrieval(m, user, cand, chunk=100).numpy()
    _close(parts, whole, CHUNK_TOL)
    _same_topk(whole, parts, 100, CHUNK_TOL)


def test_retrieval_scores_match_reference():
    """``retrieval_scores``: users against encoded candidates, one GEMM."""
    jcfg = jarch.two_tower_smoke()
    p = jax.tree.map(np.asarray, jrs.twotower_init(jax.random.PRNGKey(2),
                                                   jcfg))
    m = recsys_params_from_jax("two-tower-retrieval", p,
                               archs.two_tower_smoke(), device="cpu")
    batch = RecsysPipeline(batch=16, vocab=1000, hist_len=50,
                           seed=4).batch_at(1)
    ids = np.arange(300, dtype=np.int32)
    cands = jrs.item_repr(p, jnp.asarray(ids), jcfg)
    ref = jrs.retrieval_scores(p, _jb(batch), cands, jcfg)
    out = rs.retrieval_scores(m, rs.batch_to(batch, "cpu"),
                              rs.item_repr(m, _t(ids)))
    assert tuple(out.shape) == ref.shape == (16, 300)
    _close(out.numpy(), ref, MODEL_TOL)


# ---------------------------------------------------------------------------
# weights, devices, and Quake
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_model_draws_with_the_reference_fan_in(name):
    """The tree names of the reference's init, and each tensor's std at
    ``1/sqrt(fan_in)`` over the reference's axis."""
    jcfg = getattr(jarch, JFNS[name][1])()
    shapes = jax.eval_shape(lambda k: JINIT[name](k, jcfg),
                            jax.random.PRNGKey(0))
    model = rs.MODELS[name][1](archs.ARCHS[name][1](), device="cpu",
                               generator=torch.Generator().manual_seed(0))
    state = model.state_dict()
    want = {".".join(str(getattr(k, "key", getattr(k, "idx", k)))
                     for k in path): leaf.shape
            for path, leaf in jax.tree_util.tree_leaves_with_path(shapes)}
    assert {k: tuple(v.shape) for k, v in state.items()} == want
    axis = {"item_embed": 1, "user_embed": 1, "pos_embed": 1, "tables": 2}
    for k, t in state.items():
        parts = k.split(".")
        if "b" in parts:                         # MLP biases
            assert not t.any(), k
        elif parts[-1].startswith("ln"):         # norm scales
            assert bool((t == 1).all()), k
        else:
            fan = t.shape[axis.get(parts[-1], 0)]
            rel = float(t.std()) * fan ** 0.5
            assert abs(rel - 1.0) < 4 / (2 * t.numel()) ** 0.5 + 0.01, k


def test_entry_points_need_cuda_without_a_device(monkeypatch):
    """The models and the conversion default to the card, and raise
    where CUDA is absent instead of moving to the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for name in NAMES:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            rs.MODELS[name][1](archs.ARCHS[name][1]())
    jcfg = jarch.din_smoke()
    params = jax.tree.map(np.asarray, jrs.din_init(jax.random.PRNGKey(0),
                                                   jcfg))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        recsys_params_from_jax("din", params, archs.din_smoke())


def test_two_tower_retrieval_through_quake_on_the_cpu():
    """``examples/retrieval_serving.py``'s flow in the port: a two-tower
    model (scaled down) encodes 4,000 items and 32 users, the items go
    into ``QuakeIndex(metric="ip")``, and probing every partition returns
    the exact GEMM's top-k (ids equal but at near-ties)."""
    cfg = rs.TwoTowerConfig(user_vocab=2000, item_vocab=4000, embed_dim=32,
                            tower_mlp=(64, 32), hist_len=16)
    model = rs.TwoTower(cfg, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    items = rs.item_repr(model, torch.arange(cfg.item_vocab)).numpy()
    batch = RecsysPipeline(batch=32, vocab=cfg.user_vocab,
                           hist_len=cfg.hist_len, seed=2).batch_at(0)
    users = rs.user_repr(model, rs.batch_to(batch, "cpu")).numpy()
    np.testing.assert_allclose(np.linalg.norm(items, axis=1), 1.0,
                               rtol=1e-5)
    idx = QuakeIndex.build(items, config=QuakeConfig(metric="ip"),
                           device="cpu")
    k, p = 10, idx.num_partitions
    res = idx.search_batch(users, k, nprobe=p, rounds=1)
    exact = users.astype(np.float64) @ items.T.astype(np.float64)
    for b in range(len(users)):
        want = np.argsort(-exact[b], kind="stable")[:k]
        got = res.ids[b]
        differ = got != want
        assert (np.abs(exact[b][got] - exact[b][want])[differ]
                <= 2e-5).all()
        np.testing.assert_allclose(-res.dists[b], exact[b][got],
                                   rtol=1e-5, atol=1e-5)
    aps = idx.search_batch(users, k, recall_target=0.9)
    assert aps.ids.shape == (32, k) and (aps.ids >= 0).all()

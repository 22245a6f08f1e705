"""The port's GAT forward (repro_torch.models.gnn), its segment reductions
and its graph data (repro_torch.data.graphs, GraphMinibatchPipeline)
against the JAX package.

Every case gives both packages the same numpy inputs: ``gat_cora_smoke``
with the reference's weights (``gnn_params_from_jax``) on one graph of
each of the four ``GNN_SMOKE_SHAPES`` (``d_in`` the shape's ``d_feat``):
a community graph, a neighbour-sampled minibatch (whose outermost nodes
have no incoming edge), a power-law graph, and a batch of molecules
through ``graph_pool_logits``.  Edges are given in the generators' order,
not sorted by destination.  Tolerance: 1e-5 * |x| + 1e-5 (two layers of
f32 products summed in other orders).  The generators, the sampler and
the pipeline are numpy in both packages and must give equal arrays.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import families as jfam
from repro.configs import gnn_archs as jarch
from repro.data import graphs as jgraphs
from repro.data import pipelines as jpipe
from repro.models import gnn as jgnn
from repro.models import layers as jlayers
from repro_torch.configs import gnn_archs
from repro_torch.data import graphs, pipelines
from repro_torch.models import gnn, layers
from repro_torch.models.convert import gnn_config_from_jax, gnn_params_from_jax

TOL = 1e-5
SHAPES = list(gnn_archs.GNN_SMOKE_SHAPES)


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=TOL, atol=TOL)


def _smoke_graph(name, seed=0):
    """(feats (N, d_feat), src, dst, graph_of or None) of one smoke shape,
    from the port's generators."""
    sh = gnn_archs.GNN_SMOKE_SHAPES[name]
    rng = np.random.default_rng(seed + 10)
    if name == "full_graph_sm":
        g, feats, _ = graphs.community_graph(
            sh["n_nodes"], sh["n_edges"] / sh["n_nodes"] / 2,
            d_feat=sh["d_feat"], seed=seed)
        src, dst = graphs.to_edges(g)
        return feats, src, dst, None
    if name == "minibatch_lg":
        g = graphs.power_law_graph(1024, 4.0, seed=seed)
        feats = rng.normal(size=(1024, sh["d_feat"])).astype(np.float32)
        labels = rng.integers(0, 7, 1024).astype(np.int32)
        b = pipelines.GraphMinibatchPipeline(
            g, feats, labels, batch_nodes=8, seed=seed).batch_at(3)
        return b["feats"], b["src"], b["dst"], None
    if name == "ogb_products":
        g = graphs.power_law_graph(sh["n_nodes"],
                                   sh["n_edges"] / sh["n_nodes"] / 2,
                                   seed=seed)
        src, dst = graphs.to_edges(g)
        feats = rng.normal(size=(sh["n_nodes"], sh["d_feat"])).astype(
            np.float32)
        return feats, src, dst, None
    src, dst, feats, graph_of = graphs.molecule_batch(
        sh["n_graphs"], sh["n_nodes"], sh["n_edges"], sh["d_feat"], seed=seed)
    return feats, src, dst, graph_of


def _models(d_feat, seed=0):
    jcfg = dataclasses.replace(jarch.gat_cora_smoke(), d_in=d_feat)
    params = jax.tree.map(np.asarray,
                          jgnn.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for lp in params["layers"]:     # nonzero biases, so b is exercised
        lp["b"] = rng.normal(size=lp["b"].shape).astype(np.float32) * 0.1
    cfg = gnn_config_from_jax(dataclasses.asdict(jcfg))
    return jcfg, params, gnn_params_from_jax(params, cfg, device="cpu")


@pytest.fixture(scope="module", params=SHAPES)
def case(request):
    feats, src, dst, graph_of = _smoke_graph(request.param)
    jcfg, params, model = _models(feats.shape[1])
    return dict(name=request.param, feats=feats, src=src, dst=dst,
                graph_of=graph_of, jcfg=jcfg, params=params, model=model)


def test_smoke_graphs_have_nodes_without_incoming_edges():
    """The sampled minibatch's outermost nodes only send messages, so the
    forward meets nodes whose softmax has no edge (the -1e30 floor)."""
    feats, _, dst, _ = _smoke_graph("minibatch_lg")
    indeg = np.bincount(dst, minlength=feats.shape[0])
    assert (indeg == 0).sum() > feats.shape[0] // 4


def test_forward_matches_reference(case):
    n = case["feats"].shape[0]
    if case["graph_of"] is None:
        ref = jgnn.forward(case["params"], jnp.asarray(case["feats"]),
                           jnp.asarray(case["src"]), jnp.asarray(case["dst"]),
                           case["jcfg"])
        out = gnn.forward(case["model"], _t(case["feats"]), _t(case["src"]),
                          _t(case["dst"]))
        assert tuple(out.shape) == (n, 7)
    else:
        ng = gnn_archs.GNN_SMOKE_SHAPES[case["name"]]["n_graphs"]
        ref = jgnn.graph_pool_logits(
            case["params"], jnp.asarray(case["feats"]),
            jnp.asarray(case["src"]), jnp.asarray(case["dst"]),
            jnp.asarray(case["graph_of"]), ng, case["jcfg"])
        out = gnn.graph_pool_logits(
            case["model"], _t(case["feats"]), _t(case["src"]),
            _t(case["dst"]), _t(case["graph_of"]), ng)
        assert tuple(out.shape) == (ng, 7)
    assert out.dtype == torch.float32 and bool(torch.isfinite(out).all())
    _close(out.numpy(), np.asarray(ref))


@pytest.mark.parametrize("last", [False, True], ids=["hidden", "last"])
def test_gat_layer_matches_reference(case, last):
    """Layer 0's weights as a hidden layer (ELU of the concatenated
    heads) and as a last layer (the mean over heads), on edges in the
    generator's order."""
    n = case["feats"].shape[0]
    args = (case["feats"], case["src"], case["dst"])
    ref = jgnn.gat_layer(jax.tree.map(jnp.asarray,
                                      case["params"]["layers"][0]),
                         *map(jnp.asarray, args), n, case["jcfg"], last)
    out = gnn.gat_layer(case["model"].layers[0], *map(_t, args), n,
                        case["model"].cfg, last)
    _close(out.numpy(), np.asarray(ref))


def test_segment_ops_match_reference(case):
    """``segment_softmax``, ``segment_sum`` and ``segment_max`` of random
    per-edge scores (two heads) over the edges' destinations."""
    n = case["feats"].shape[0]
    dst = case["dst"]
    scores = np.random.default_rng(8).normal(
        size=(len(dst), 2)).astype(np.float32) * 3
    for jfn, fn in ((jlayers.segment_softmax, layers.segment_softmax),
                    (jax.ops.segment_sum, layers.segment_sum),
                    (jax.ops.segment_max, layers.segment_max)):
        ref = jfn(jnp.asarray(scores), jnp.asarray(dst), n)
        _close(fn(_t(scores), _t(dst).long(), n).numpy(), np.asarray(ref))


def test_segment_sum_order_is_the_row_order():
    """Each segment is summed in the order its rows come: 1e8 + 1 - 1e8
    + 1 is 1 in f32 that way, and 2 or 0 in other orders."""
    data = torch.tensor([1e8, 5.0, 1.0, -1e8, 1.0])
    ids = torch.tensor([3, 0, 3, 3, 3])
    out = layers.segment_sum(data, ids, 5)
    assert out.tolist() == [5.0, 0.0, 0.0, 1.0, 0.0]
    rows = torch.stack([data, -data], 1)
    assert layers.segment_sum(rows, ids, 5)[3].tolist() == [1.0, -1.0]


def test_gat_weights_match_reference_layout():
    """The port draws the reference's shapes (8 heads of 8, then one head
    of 7) with the fan-in stds."""
    cfg = gnn_archs.gat_cora()
    model = gnn.GAT(cfg, device="cpu")
    jp = jax.eval_shape(lambda k: jgnn.init_params(k, jarch.gat_cora()),
                        jax.random.PRNGKey(0))
    for lp, jlp in zip(model.layers, jp["layers"]):
        for name in ("w", "a_src", "a_dst", "b"):
            assert tuple(getattr(lp, name).shape) == jlp[name].shape
    assert abs(float(model.layers[0].w.std()) * 1433 ** 0.5 - 1) < 0.05
    assert not model.layers[1].b.any()


@pytest.mark.parametrize("fn", ["gat_cora", "gat_cora_smoke"])
def test_gnn_config_matches_reference(fn):
    jcfg = getattr(jarch, fn)()
    assert gnn_config_from_jax(dataclasses.asdict(jcfg)) == \
        getattr(gnn_archs, fn)()


def test_gnn_shapes_match_reference():
    assert gnn_archs.GNN_SHAPES == jfam.GNN_SHAPES
    assert gnn_archs.GNN_SMOKE_SHAPES == jfam.GNN_SMOKE_SHAPES


# ---------------------------------------------------------------------------
# graph data: the same seed gives equal arrays
# ---------------------------------------------------------------------------

def _equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _equal_csr(a, b):
    assert a.n_nodes == b.n_nodes
    _equal(a.indptr, b.indptr)
    _equal(a.indices, b.indices)


@pytest.mark.parametrize("seed", [0, 5])
def test_generators_match_reference(seed):
    ga, fa, la = graphs.community_graph(300, 3.5, n_comm=6, d_feat=12,
                                        seed=seed)
    gb, fb, lb = jgraphs.community_graph(300, 3.5, n_comm=6, d_feat=12,
                                         seed=seed)
    _equal_csr(ga, gb)
    _equal(fa, fb)
    _equal(la, lb)
    _equal_csr(graphs.power_law_graph(700, 6.0, seed=seed),
               jgraphs.power_law_graph(700, 6.0, seed=seed))
    for a, b in zip(graphs.molecule_batch(5, 12, 20, 7, seed=seed),
                    jgraphs.molecule_batch(5, 12, 20, 7, seed=seed)):
        _equal(a, b)
    src, dst = graphs.to_edges(ga)
    jsrc, jdst = jgraphs.to_edges(gb)
    _equal(src, jsrc)
    _equal(dst, jdst)
    _equal_csr(graphs.from_edges(dst, src, 300),
               jgraphs.from_edges(jdst, jsrc, 300))
    assert ga.n_edges == gb.n_edges
    _equal(ga.degree(), gb.degree())


def test_sampler_matches_reference():
    g = graphs.power_law_graph(2000, 5.0, seed=3)
    jg = jgraphs.power_law_graph(2000, 5.0, seed=3)
    seeds = np.arange(0, 2000, 97)
    blocks = graphs.sample_blocks(g, seeds, (6, 4),
                                  np.random.default_rng(1))
    jblocks = jgraphs.sample_blocks(jg, seeds, (6, 4),
                                    np.random.default_rng(1))
    assert len(blocks) == len(jblocks) == 2
    for a, b in zip(blocks, jblocks):
        for f in ("seeds", "neighbors", "mask"):
            _equal(getattr(a, f), getattr(b, f))
    for a, b in zip(graphs.sampled_subgraph(g, seeds, (15, 10), seed=4),
                    jgraphs.sampled_subgraph(jg, seeds, (15, 10), seed=4)):
        _equal(a, b)


@pytest.mark.parametrize("step", [0, 7])
def test_graph_minibatch_pipeline_matches_reference(step):
    g = graphs.power_law_graph(3000, 4.0, seed=2)
    rng = np.random.default_rng(0)
    feats = rng.normal(size=(3000, 9)).astype(np.float32)
    labels = rng.integers(0, 7, 3000).astype(np.int32)
    a = pipelines.GraphMinibatchPipeline(g, feats, labels, 64,
                                         seed=11).batch_at(step)
    b = jpipe.GraphMinibatchPipeline(g, feats, labels, 64,
                                     seed=11).batch_at(step)
    assert a.keys() == b.keys()
    for k in a:
        _equal(a[k], b[k])
    assert len(a["src"]) <= 64 * 15 + 64 * 15 * 10

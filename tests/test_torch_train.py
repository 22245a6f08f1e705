"""The port's training path (``repro_torch.train``, the training functions
of ``repro_torch.models``, ``launch/train.py``) against the JAX package,
on the CPU.

Every case gives both packages the same numpy inputs and weights (the
reference's ``init_params`` carried over by ``models/convert``), and
holds the port's result against the reference's:

- ``TokenPipeline`` batches byte for byte;
- the schedule, clipping, one AdamW update and the int8 codes;
- the training attention against the jnp ``flash_attention`` (forward and
  gradients), the LM losses at the five smoke configs, the recsys and GAT
  losses (value and every gradient);
- one and two ``make_train_step`` steps against the reference's step on
  the same state, the checkpoints, the supervisor's restart and replay,
  and the compressed data-parallel step on four gloo ranks against the
  reference's ``shard_map`` on four host devices.

Tolerances (f32): losses to 1e-5 relative; each gradient leaf to
``GRAD_REL * max|g| + GRAD_ABS`` (two frameworks summing in other
orders); parameters after a step to ``P_REL * |p| + P_ABS``, except where
the reference gradient of a step is under ``SMALL * max|g|`` of its
leaf: Adam's first update there is ``lr * sign(g)`` of a gradient at the
rounding level, held to 2 * lr a step; the moments like gradients; one
AdamW update from equal gradients to ``UPDATE_TOL``.  A bf16 cast step:
loss to 1e-2 relative and each leaf's gradient at cosine >= 0.999 to the
reference's.
"""
import dataclasses
import functools
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
from torch import nn

from repro.configs import families as jfam
from repro.configs import gnn_archs as jga
from repro.configs import lm_archs as jarch
from repro.configs import recsys_archs as jra
from repro.data import graphs as jgraphs
from repro.data import pipelines as jpipe
from repro.models import gnn as jgnn
from repro.models import layers as jlayers
from repro.models import recsys as jrs
from repro.models import transformer as jtr
from repro.train import CheckpointManager as JCheckpointManager
from repro.train import LoopConfig as JLoopConfig
from repro.train import optimizer as jopt
from repro.train import steps as jsteps
from repro.train import train_loop as jtrain_loop
from repro_torch.configs import recsys_archs, training
from repro_torch.data import TokenPipeline
from repro_torch.launch import train as launch_train
from repro_torch.models import gnn, layers
from repro_torch.models import recsys as rs
from repro_torch.models import transformer as tr
from repro_torch.models.convert import (adamw_state_from_jax,
                                        config_from_jax, gnn_config_from_jax,
                                        gnn_params_from_jax, named_from_jax,
                                        params_from_jax,
                                        recsys_params_from_jax)
from repro_torch.train import (CheckpointManager, LoopConfig, optimizer,
                               steps, train_loop)
from repro_torch.train.loop import LoopReport

LOSS_REL = 1e-5
GRAD_REL, GRAD_ABS = 1e-4, 1e-6
P_REL, P_ABS = 1e-5, 1e-6
SMALL = 1e-3
UPDATE_TOL = 1e-6
BF16_LOSS_REL, BF16_COS, BF16_LEAF_COS = 1e-2, 0.999, 0.99
ATT_TOL = 2e-5                    # f32 attention (tests/test_kernels.py's)
SRC = str(Path(__file__).resolve().parents[1] / "src")
# the smoke configs, with the attention path each runs (grouped, or K/V
# repeated to the query heads)
LM_SMOKE = [("qwen25_smoke", True), ("granite_smoke", False),
            ("mistral_large_smoke", True), ("qwen3_moe_smoke", True),
            ("llama4_scout_smoke", False)]
SEQ = 37                # tokens: 3 query tiles of 16, 5 key tiles of 8
LOSS_CHUNK = 16
STEP_CFG = optimizer.AdamWConfig(lr=1e-2, warmup_steps=2, total_steps=10)
J_STEP_CFG = jopt.AdamWConfig(**dataclasses.asdict(STEP_CFG))


def _t(a):
    return torch.from_numpy(np.array(a))


def _np(x):
    return x.detach().float().numpy() if torch.is_tensor(x) \
        else np.asarray(x, np.float32)


def _loss_close(got, want, rel=LOSS_REL):
    assert abs(float(got) - float(want)) <= rel * abs(float(want)), \
        (float(got), float(want))


def _hold_tree(got, want, rel=GRAD_REL, abs_=GRAD_ABS, what="grad"):
    """Every leaf of ``got`` (name -> tensor) within ``rel * max|want| +
    abs_`` of ``want``'s (name -> numpy), the same names on both sides."""
    assert set(got) == set(want), set(got) ^ set(want)
    for n, w in want.items():
        g = _np(got[n])
        assert g.shape == w.shape, (n, g.shape, w.shape)
        err = float(np.abs(g - w).max()) if w.size else 0.0
        tol = rel * float(np.abs(w).max() if w.size else 0.0) + abs_
        assert err <= tol, f"{what} {n}: |diff| {err:.3g} > {tol:.3g}"


def _lm(name, **replace):
    jcfg = dataclasses.replace(getattr(jarch, name)(), q_block=16,
                               k_block=8, **replace)
    params = jax.tree.map(np.asarray,
                          jtr.init_params(jax.random.PRNGKey(0), jcfg))
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    return jcfg, params, cfg, params_from_jax(params, cfg, device="cpu")


def _tokens(vocab, b=2, s=SEQ, seed=0):
    return np.random.default_rng(seed).integers(
        0, vocab, (b, s)).astype(np.int32)


# ---------------------------------------------------------------------------
# the pipeline and the optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("vocab,batch,seq,seed,step", [
    (512, 4, 37, 0, 0), (512, 4, 37, 0, 1), (152064, 2, 300, 3, 17),
    (8192, 8, 128, 0, 123456)])
def test_token_pipeline_matches_reference(vocab, batch, seq, seed, step):
    want = jpipe.TokenPipeline(vocab, batch, seq, seed).batch_at(step)
    got = TokenPipeline(vocab, batch, seq, seed).batch_at(step)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype
        assert got[k].tobytes() == want[k].tobytes()


@pytest.mark.parametrize("step", [0, 4, 10, 55, 100, 150])
def test_schedule_matches_reference(step):
    """At step 0, inside the warmup, at its boundary, mid-decay, at the
    end and past it."""
    cfg = optimizer.AdamWConfig(lr=2e-3, warmup_steps=10, total_steps=100)
    want = float(jopt.schedule(jopt.AdamWConfig(**dataclasses.asdict(cfg)),
                               jnp.asarray(step)))
    got = optimizer.schedule(cfg, torch.tensor(step, dtype=torch.int32))
    assert got.dtype == torch.float32
    assert abs(float(got) - want) <= 1e-7 * abs(want) + 1e-12


def _tree(seed, scale=1.0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.normal(size=(7, 5)) * scale).astype(np.float32),
            "b": (rng.normal(size=(13,)) * scale).astype(np.float32),
            "c": (rng.normal(size=(2, 3, 4)) * scale).astype(np.float32)}


@pytest.mark.parametrize("scale", [10.0, 0.01], ids=["above", "below"])
def test_clip_by_global_norm_matches_reference(scale):
    g = _tree(1, scale)
    want, wnorm = jopt.clip_by_global_norm(g, 1.0)
    got, norm = optimizer.clip_by_global_norm(
        {k: _t(v) for k, v in g.items()}, 1.0)
    _loss_close(norm, wnorm, 1e-6)
    for k in g:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=0)
    if scale < 1:
        assert all(torch.equal(got[k], _t(g[k])) for k in g)


@pytest.mark.parametrize("start", [0, 7])
def test_apply_update_matches_reference(start):
    """One AdamW update from the same parameters, gradients and state (a
    first step, and one at step 7 with nonzero moments), gradients above
    the clip norm."""
    cfg = optimizer.AdamWConfig(lr=1e-2, warmup_steps=4, total_steps=20)
    jcfg = jopt.AdamWConfig(**dataclasses.asdict(cfg))
    p, g = _tree(2), _tree(3, 5.0)
    m = _tree(4, 0.1) if start else {k: np.zeros_like(v) for k, v in
                                     p.items()}
    v = {k: np.abs(x) for k, x in _tree(5, 0.01).items()} if start else \
        {k: np.zeros_like(x) for k, x in p.items()}
    jst = jopt.AdamWState(jnp.asarray(start, jnp.int32), m, v)
    wp, wst, winfo = jopt.apply_update(p, g, jst, jcfg)
    tp = {k: _t(x) for k, x in p.items()}
    st = optimizer.AdamWState(torch.tensor(start, dtype=torch.int32),
                              {k: _t(x) for k, x in m.items()},
                              {k: _t(x) for k, x in v.items()})
    out, st2, info = optimizer.apply_update(
        tp, {k: _t(x) for k, x in g.items()}, st, cfg)
    assert out is tp and st2 is st and int(st.step) == start + 1
    for got, want in ((tp, wp), (st.m, wst.m), (st.v, wst.v)):
        for k in p:
            np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                       rtol=UPDATE_TOL, atol=UPDATE_TOL)
    _loss_close(info["lr"], winfo["lr"], 1e-7)
    _loss_close(info["grad_norm"], winfo["grad_norm"], 1e-6)


def test_int8_compression_matches_reference():
    """Codes and scale equal to the reference's, halves rounding to even
    (``jnp.round``): the scale is 1 exactly when max|g| is 127."""
    rng = np.random.default_rng(6)
    g = np.concatenate([[127.0, -127.0, 0.5, 1.5, 2.5, -0.5, -2.5, 3.5,
                         126.5, -126.5], rng.normal(size=200) * 40]
                       ).astype(np.float32)
    for x in (g, g * 1e-3):
        wq, ws = jopt.compress_int8(jnp.asarray(x))
        q, s = optimizer.compress_int8(_t(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(wq))
        assert float(s) == float(ws)
        np.testing.assert_array_equal(
            optimizer.decompress_int8(q, s).numpy(),
            np.asarray(jopt.decompress_int8(wq, ws)))
    assert optimizer.compress_int8(_t(g))[0][2:7].tolist() == \
        [0, 2, 2, 0, -2]


# ---------------------------------------------------------------------------
# the training attention and the LM losses
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("grouped,causal,b,sq,sk,h,kh,d", [
    (True, True, 2, 37, 37, 4, 2, 8),       # GQA, 3 x 5 tiles, ragged ends
    (False, False, 2, 37, 37, 4, 2, 8),
    (False, True, 1, 21, 21, 6, 1, 16),     # MQA
    (True, False, 1, 21, 21, 6, 1, 16),
    (True, True, 2, 20, 45, 4, 4, 8),       # MHA, Sq != Sk
    (False, False, 2, 20, 45, 4, 4, 8),
])
def test_training_attention_matches_reference(grouped, causal, b, sq, sk, h,
                                              kh, d):
    """Forward and the gradients of q, k, v against ``jax.grad`` of the
    jnp blockwise attention, 16 x 8 tiles: the grouped and the repeat
    path, causal and full, at each shape."""
    rng = np.random.default_rng(b * 100 + sq + sk + h)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, kh, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, kh, d)).astype(np.float32)
    w = rng.normal(size=(b, sq, h, d)).astype(np.float32)

    def jf(q, k, v):
        return jlayers.flash_attention(q, k, v, causal=causal, q_block=16,
                                       k_block=8, grouped=grouped)
    want, wgrads = jax.jit(jax.value_and_grad(
        lambda *a: jnp.sum(jf(*a) * w), argnums=(0, 1, 2)))(q, k, v)
    want = jf(q, k, v)
    tq, tk, tv = (_t(a).requires_grad_() for a in (q, k, v))
    out = layers.flash_attention(tq, tk, tv, causal=causal, q_block=16,
                                 k_block=8, grouped=grouped)
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(want),
                               rtol=ATT_TOL, atol=ATT_TOL)
    (out * _t(w)).sum().backward()
    _hold_tree({"q": tq.grad, "k": tk.grad, "v": tv.grad},
               dict(zip("qkv", map(np.asarray, wgrads))))


@functools.lru_cache(maxsize=None)
def _jax_lm_value_and_grad(name):
    """The reference's jitted ``value_and_grad`` of ``lm_loss`` at
    ``name``'s smoke config (the train-step tests' reference gradient)."""
    jcfg = _lm(name)[0]
    return jax.jit(jax.value_and_grad(
        lambda p, t: jtr.lm_loss(p, t, jcfg)))


def _jhidden(p, t, cfg, w):
    x, aux = jtr.hidden_states(p, t, cfg)
    return jnp.mean(x * w) + aux


def _hidden(m, t, cfg, w):
    x, aux = tr.hidden_states(m, t, cfg)
    return torch.mean(x * _t(w)) + aux


@functools.lru_cache(maxsize=None)
def _lm_case(name, grouped):
    """A smoke config's weights in both packages, tokens, and the
    reference's (loss, gradients by the port's names) of each LM loss,
    from one compile: ``lm_loss``, ``lm_loss_chunked`` (chunks of
    LOSS_CHUNK over SEQ positions: a padded, masked last chunk) and a
    weighted mean of ``hidden_states``' output plus its aux (a loss-sized
    objective)."""
    jcfg, params, cfg, model = _lm(name, attn_grouped=grouped)
    tokens = _tokens(cfg.vocab_size)
    w = np.random.default_rng(1).normal(
        size=(2, SEQ, cfg.d_model)).astype(np.float32)

    def three(p, t):
        return {f: jax.value_and_grad(lambda q: jfn(q, t))(p)
                for f, jfn in (
                    ("lm_loss", lambda q, t: jtr.lm_loss(q, t, jcfg)),
                    ("lm_loss_chunked", lambda q, t: jtr.lm_loss_chunked(
                        q, t, jcfg, chunk=LOSS_CHUNK)),
                    ("hidden_states", lambda q, t: _jhidden(q, t, jcfg, w)))}
    refs = {f: (float(lv), named_from_jax(g, cfg))
            for f, (lv, g) in jax.jit(three)(params, tokens).items()}
    return cfg, model, tokens, w, refs


@pytest.mark.parametrize("fn", ["lm_loss", "lm_loss_chunked",
                                "hidden_states"])
@pytest.mark.parametrize("name,grouped", LM_SMOKE)
def test_lm_losses_and_grads_match_reference(name, grouped, fn):
    """Each LM training function and every gradient, remat on and off,
    against ``jax.value_and_grad`` of the reference's (MoE configs with
    the aux term); the grouped attention at three configs, the repeat
    path at two."""
    cfg, model, tokens, w, refs = _lm_case(name, grouped)
    port = {"lm_loss": tr.lm_loss,
            "lm_loss_chunked": lambda m, t, c: tr.lm_loss_chunked(
                m, t, c, chunk=LOSS_CHUNK),
            "hidden_states": lambda m, t, c: _hidden(m, t, c, w)}[fn]
    wl, want = refs[fn]
    for remat in (True, False):
        c = dataclasses.replace(cfg, remat=remat)
        loss, grads = steps.value_and_grad(lambda m, t: port(m, t, c),
                                           model, tokens)
        _loss_close(loss, wl)
        _hold_tree(grads, want)


# ---------------------------------------------------------------------------
# the recsys and GAT losses
# ---------------------------------------------------------------------------

RECSYS = {"din": (jrs.din_init, jrs.din_loss, rs.din_loss),
          "sasrec": (jrs.sasrec_init, jrs.sasrec_loss, rs.sasrec_loss),
          "two-tower-retrieval": (jrs.twotower_init, jrs.twotower_loss,
                                  rs.twotower_loss),
          "dlrm-rm2": (jrs.dlrm_init, jrs.dlrm_loss, rs.dlrm_loss)}


def _recsys(name):
    jcfg = jra.__dict__[{"two-tower-retrieval": "two_tower_smoke",
                         "dlrm-rm2": "dlrm_smoke"}.get(
                             name, f"{name}_smoke")]()
    cfg = recsys_archs.ARCHS[name][1]()
    params = jax.tree.map(np.asarray,
                          RECSYS[name][0](jax.random.PRNGKey(0), jcfg))
    model = recsys_params_from_jax(name, params, cfg, device="cpu")
    vocab = getattr(cfg, "vocab", getattr(cfg, "item_vocab", None))
    batch = jpipe.RecsysPipeline(batch=32, vocab=vocab,
                                 hist_len=rs.history_len(cfg),
                                 seed=1).batch_at(0)
    return jcfg, params, model, batch


@pytest.mark.parametrize("name", list(RECSYS))
def test_recsys_losses_and_grads_match_reference(name):
    jcfg, params, model, batch = _recsys(name)
    wl, wg = jax.jit(jax.value_and_grad(
        lambda p, b: RECSYS[name][1](p, b, jcfg)))(params, batch)
    loss, grads = steps.value_and_grad(RECSYS[name][2], model,
                                       steps.to_device(batch, "cpu"))
    _loss_close(loss, wl)
    _hold_tree(grads, named_from_jax(wg))
    assert rs.recsys_loss(model, steps.to_device(batch, "cpu")).item() == \
        pytest.approx(float(loss), rel=1e-6)


def _gat(shape, seed=0):
    sh = jfam.GNN_SMOKE_SHAPES[shape]
    jcfg = dataclasses.replace(jga.gat_cora_smoke(), d_in=sh["d_feat"])
    params = jax.tree.map(np.asarray,
                          jgnn.init_params(jax.random.PRNGKey(seed), jcfg))
    rng = np.random.default_rng(seed)
    for lp in params["layers"]:     # nonzero biases, so b is exercised
        lp["b"] = rng.normal(size=lp["b"].shape).astype(np.float32) * 0.1
    model = gnn_params_from_jax(
        params, gnn_config_from_jax(dataclasses.asdict(jcfg)), device="cpu")
    if sh["kind"] == "pooled":
        src, dst, feats, graph_of = jgraphs.molecule_batch(
            sh["n_graphs"], sh["n_nodes"], sh["n_edges"], sh["d_feat"],
            seed=seed)
        labels = rng.integers(0, 7, sh["n_graphs"]).astype(np.int32)
    else:
        n = sh["n_nodes"]
        g = jgraphs.power_law_graph(n, sh["n_edges"] / n / 2, seed=seed)
        src, dst = jgraphs.to_edges(g)
        feats = rng.normal(size=(n, sh["d_feat"])).astype(np.float32)
        labels = rng.integers(0, 7, n).astype(np.int32)
        graph_of = None
    batch = {"feats": feats, "src": src.astype(np.int32),
             "dst": dst.astype(np.int32), "labels": labels}
    if graph_of is not None:
        batch["graph_of"] = graph_of.astype(np.int32)
    return sh, jcfg, params, model, batch


def _jpooled(p, b, cfg, n_graphs):
    """The loss of the reference's ``families._make_gnn_pooled_step``."""
    logits = jgnn.graph_pool_logits(p, b["feats"], b["src"], b["dst"],
                                    b["graph_of"], n_graphs, cfg)
    gold = jnp.take_along_axis(logits, b["labels"][:, None], axis=-1)[:, 0]
    return jnp.mean(jax.nn.logsumexp(logits, axis=-1) - gold)


@pytest.mark.parametrize("case", ["full", "label_mask", "pooled"])
def test_gat_losses_and_grads_match_reference(case):
    shape = "molecule" if case == "pooled" else "full_graph_sm"
    sh, jcfg, params, model, batch = _gat(shape)
    tb = steps.to_device(batch, "cpu")
    if case == "pooled":
        n = sh["n_graphs"]
        wl, wg = jax.jit(jax.value_and_grad(_jpooled), static_argnums=(
            2, 3))(params, batch, jcfg, n)
        loss, grads = steps.value_and_grad(
            lambda m, b: gnn.pooled_loss(m, b["feats"], b["src"], b["dst"],
                                         b["graph_of"], b["labels"], n),
            model, tb)
    else:
        mask = (np.random.default_rng(2).random(len(batch["labels"]))
                < 0.3).astype(np.float32) if case == "label_mask" else None
        wl, wg = jax.jit(jax.value_and_grad(
            lambda p, b, m: jgnn.loss_fn(p, b["feats"], b["src"], b["dst"],
                                         b["labels"], jcfg, label_mask=m)))(
            params, batch, mask)
        loss, grads = steps.value_and_grad(
            lambda m, b: gnn.loss_fn(m, b["feats"], b["src"], b["dst"],
                                     b["labels"], None if mask is None
                                     else _t(mask)), model, tb)
    _loss_close(loss, wl)
    _hold_tree(grads, named_from_jax(wg))


# ---------------------------------------------------------------------------
# train steps
# ---------------------------------------------------------------------------

def _hold_params(got, want, small, lrs, what="param"):
    """``_hold_tree``'s rule for parameters after a step: P_REL * |p| +
    P_ABS, or 2 * lr a step where a step's reference gradient is small."""
    for n, w in want.items():
        g = _np(got[n])
        tol = np.where(small[n], 2.0 * sum(lrs), P_REL * np.abs(w) + P_ABS)
        bad = np.abs(g - w) > tol
        assert not bad.any(), (f"{what} {n}: {int(bad.sum())} entries, max "
                               f"|diff| {float(np.abs(g - w).max()):.3g}")


def _small(grads_named):
    return {n: np.abs(g) < SMALL * np.abs(g).max() for n, g in
            grads_named.items()}


def _ref_grad(params, batch, mb):
    """The reference step's gradient at qwen25_smoke: the mean over the
    microbatches."""
    n = batch["tokens"].shape[0] // mb
    vg = _jax_lm_value_and_grad("qwen25_smoke")
    gs = [vg(params, batch["tokens"][i * n:(i + 1) * n])[1]
          for i in range(mb)]
    return jax.tree.map(lambda *a: sum(a) / mb, *gs)


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_reference(mb):
    """Two steps of ``make_train_step`` (qwen25_smoke, ``lm_loss``, 2 rows
    in one microbatch, 4 rows in two), each from the same state as the
    reference's step: the first from the initial state, the second from the
    reference's state after its first step, loaded into the port's model
    and AdamW state through ``models/convert``.  After each: loss, grad
    norm, lr, parameters, the moments and the step."""
    jcfg, params, cfg, model = _lm("qwen25_smoke")

    def jloss(p, b):
        return jtr.lm_loss(p, b["tokens"], jcfg)
    jstep = jax.jit(jsteps.make_train_step(jloss, J_STEP_CFG, mb))
    step = steps.make_train_step(lambda m, b: tr.lm_loss(m, b["tokens"]),
                                 STEP_CFG, mb)
    jst = jopt.init_state(params)
    for i in range(2):
        model.load_state_dict({n: _t(a) for n, a in
                               named_from_jax(params, cfg).items()})
        st = adamw_state_from_jax(jst, cfg, device="cpu")
        batch = TokenPipeline(cfg.vocab_size, 2 * mb, SEQ).batch_at(i)
        small = _small(named_from_jax(_ref_grad(params, batch, mb), cfg))
        params, jst, jm = jstep(params, jst, batch)
        out, st2, m = step(model, st, batch)
        assert out is model and st2 is st and int(st.step) == i + 1
        _loss_close(m["loss"], jm["loss"])
        _loss_close(m["grad_norm"], jm["grad_norm"], 1e-4)
        _loss_close(m["lr"], jm["lr"], 1e-7)
        _hold_params(dict(model.named_parameters()),
                     named_from_jax(params, cfg), small, [float(jm["lr"])])
        _hold_tree(st.m, named_from_jax(jst.m, cfg), what="m")
        _hold_tree(st.v, named_from_jax(jst.v, cfg), abs_=1e-12, what="v")


def _cosine(a, b) -> float:
    return float(a @ b) / max(float(np.linalg.norm(a) * np.linalg.norm(b)),
                              1e-30)


def test_bf16_cast_step_matches_reference():
    """``cast_dtype=bf16`` at a bf16 compute dtype: the loss and the
    gradient (of the casts, taken to f32 for the masters) against the
    reference's cast, and a step's loss (with the f32 masters kept).  The
    whole gradient is held at cosine BF16_COS; each leaf at BF16_LEAF_COS
    (the k bias's gradient is small, mostly cancelling under the
    softmax)."""
    jcfg, params, cfg, model = _lm("qwen25_smoke",
                                   compute_dtype=jnp.bfloat16)
    tokens = _tokens(cfg.vocab_size, b=4)

    def jloss(p, b):
        pc = jax.tree.map(lambda x: x.astype(jnp.bfloat16), p)
        return jtr.lm_loss(pc, b["tokens"], jcfg)
    wl, wg = jax.jit(jax.value_and_grad(jloss))(params, {"tokens": tokens})
    loss, grads = steps.value_and_grad(
        lambda m, b: tr.lm_loss(m, b["tokens"]), model, {"tokens": _t(tokens)},
        cast_dtype=torch.bfloat16)
    _loss_close(loss, wl, BF16_LOSS_REL)
    want = named_from_jax(wg, cfg)
    assert all(grads[n].dtype == torch.bfloat16 for n in want)
    assert _cosine(np.concatenate([_np(grads[n]).ravel() for n in want]),
                   np.concatenate([w.ravel() for w in want.values()])) \
        >= BF16_COS
    for n, w in want.items():
        assert _cosine(_np(grads[n]).ravel(), w.ravel()) >= BF16_LEAF_COS, n
    m = steps.make_train_step(lambda m_, b: tr.lm_loss(m_, b["tokens"]),
                              STEP_CFG, cast_dtype=torch.bfloat16)(
        model, optimizer.init_state(model), {"tokens": tokens})[2]
    _loss_close(m["loss"], wl, BF16_LOSS_REL)   # the loss at the same state
    assert all(p.dtype == torch.float32 for p in model.parameters())


@pytest.mark.parametrize("shape", ["full_graph_sm", "molecule"])
def test_gat_train_step_matches_reference(shape):
    """One step of the reference's ``families._make_gnn_step`` /
    ``_make_gnn_pooled_step`` (OPT_CFG, a one-device mesh) against
    ``make_train_step`` on ``loss_fn`` / ``pooled_loss``."""
    sh, jcfg, params, model, batch = _gat(shape)
    mesh = JMesh(np.array(jax.devices()[:1]).reshape(1, 1, 1),
                 ("pod", "data", "model"))
    jcfg = dataclasses.replace(jcfg, dp_axes=("pod", "data"))
    if sh["kind"] == "pooled":
        n = sh["n_graphs"]
        jstep = jfam._make_gnn_pooled_step(jcfg, mesh, n)

        def loss(m, b):
            return gnn.pooled_loss(m, b["feats"], b["src"], b["dst"],
                                   b["graph_of"], b["labels"], n)
    else:
        jstep = jfam._make_gnn_step(jcfg, mesh)

        def loss(m, b):
            return gnn.loss_fn(m, b["feats"], b["src"], b["dst"],
                               b["labels"])
    wp, _, jm = jax.jit(jstep)(params, jopt.init_state(params), batch)
    _, _, m = steps.make_train_step(loss, training.OPT_CFG)(
        model, optimizer.init_state(model), batch)
    _loss_close(m["loss"], jm["loss"])
    g_ref = jax.jit(jax.grad(
        lambda p, b: _jpooled(p, b, jcfg, sh["n_graphs"])
        if sh["kind"] == "pooled" else
        jgnn.loss_fn(p, b["feats"], b["src"], b["dst"], b["labels"],
                     jcfg)))(params, batch)
    _hold_params(dict(model.named_parameters()), named_from_jax(wp),
                 _small(named_from_jax(g_ref)), [float(jm["lr"])])


def test_serve_step_and_config_hash_match_reference():
    """``make_serve_step`` runs the forward without gradients (the
    reference's is the identity wrapper), and ``config_hash`` is the
    reference's hash of the same repr."""
    from repro.train.checkpoint import config_hash as jconfig_hash
    from repro_torch.train.checkpoint import config_hash
    jcfg, params, cfg, model = _lm("qwen25_smoke")
    tokens = _tokens(cfg.vocab_size)
    serve = steps.make_serve_step(tr.forward_train)
    assert serve.__name__ == "forward_train"
    with torch.enable_grad():
        logits, aux = serve(model, tokens)
    assert not logits.requires_grad and logits.shape == (2, SEQ, 512)
    want = jax.jit(lambda p, t: jtr.forward_train(p, t, jcfg)[0])(params,
                                                                 tokens)
    np.testing.assert_allclose(logits.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-4)
    for obj in (STEP_CFG, {"a": 1, "b": (2, 3)}, "lm-20m"):
        assert config_hash(obj) == jconfig_hash(obj)


def test_microbatches_drop_trailing_rows():
    """5 rows in 2 microbatches: rows 0-1 and 2-3, row 4 dropped, as the
    reference's ``x[:mb * n].reshape(n, mb, ...)``."""
    _, _, cfg, model = _lm("qwen25_smoke")
    tokens = _tokens(cfg.vocab_size, b=5)
    seen = []

    def loss(m, b):
        seen.append(b["tokens"].clone())
        return tr.lm_loss(m, b["tokens"])
    steps.make_train_step(loss, STEP_CFG, 2)(model,
                                            optimizer.init_state(model),
                                            {"tokens": tokens})
    assert [s.tolist() for s in seen] == [tokens[0:2].tolist(),
                                          tokens[2:4].tolist()]


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------

class _Linear(nn.Module):
    def __init__(self, w):
        super().__init__()
        self.w = nn.Parameter(torch.tensor(w), requires_grad=False)


def _state(n=6):
    model = _Linear(np.arange(float(n), dtype=np.float32))
    return (model, optimizer.init_state(model),
            {"nested": [torch.ones((2, 3)), torch.tensor([1, 2],
                                                         dtype=torch.int32)],
             "half": torch.full((4,), 1.5, dtype=torch.bfloat16)})


def test_checkpoint_roundtrip_and_gc(tmp_path):
    """Save three times with keep=2 (the reference keeps the same two),
    then restore a new state and into a live one."""
    state = _state()
    mgr = CheckpointManager(str(tmp_path / "t"), keep=2, async_write=False)
    jmgr = JCheckpointManager(str(tmp_path / "j"), keep=2,
                              async_write=False)
    for s in (1, 2, 3):
        mgr.save(s, state, extra={"cursor": s}, block=True)
        jmgr.save(s, {"w": jnp.zeros(2)}, block=True)
    assert mgr.list() == jmgr.list() == ["ckpt_00000002", "ckpt_00000003"]
    restored, man = mgr.restore(state, device="cpu")
    assert (man["step"], man["cursor"], man["leaves"]) == (3, 3, 7)
    assert set(restored[0]) == {"w"} and restored[1].step.dtype == \
        torch.int32
    assert restored[2]["half"].dtype == torch.bfloat16
    for a, b in zip(_flat(restored), _flat(state)):
        assert torch.equal(a, b)
    with torch.no_grad():
        state[0].w.add_(5.0)
    assert mgr.restore_into(state)["step"] == 3
    assert torch.equal(state[0].w, torch.arange(6.0))


def _flat(tree):
    if isinstance(tree, nn.Module):
        return [p.detach() for p in tree.parameters()]
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in _flat(v)]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _flat(v)]
    return [tree]


@pytest.mark.parametrize("kind", ["missing", "shape"])
def test_checkpoint_rejects_missing_and_misshapen_leaves(tmp_path, kind):
    """KeyError for a missing leaf and ValueError for a shape mismatch, as
    the reference raises; nothing is written into a live state."""
    like = ({"w": np.zeros(4, np.float32), "extra": np.zeros(2, np.float32)}
            if kind == "missing" else {"w": np.zeros(5, np.float32)})
    err = KeyError if kind == "missing" else ValueError
    jmgr = JCheckpointManager(str(tmp_path / "j"), async_write=False)
    jmgr.save(1, {"w": jnp.zeros(4)}, block=True)
    with pytest.raises(err):
        jmgr.restore(like)
    mgr = CheckpointManager(str(tmp_path / "t"), async_write=False)
    mgr.save(1, {"w": torch.zeros(4)}, block=True)
    live = {k: torch.full(v.shape, 7.0) for k, v in like.items()}
    with pytest.raises(err):
        mgr.restore({k: _t(v) for k, v in like.items()}, device="cpu")
    with pytest.raises(err):
        mgr.restore_into(live)
    assert all(bool((t == 7.0).all()) for t in live.values())


def test_async_save_then_in_place_update_restores_saved_values(tmp_path):
    """The writer thread runs while the state is updated in place: the
    checkpoint holds the values at save time (CPU tensors share memory
    with their numpy views, so save must copy)."""
    model = _Linear(np.random.default_rng(0).normal(
        size=2_000_000).astype(np.float32))
    st = optimizer.init_state(model)
    want = [t.clone() for t in _flat((model, st))]
    mgr = CheckpointManager(str(tmp_path), async_write=True)
    mgr.save(1, (model, st))
    with torch.no_grad():
        model.w.mul_(-2.0).add_(1.0)
        st.m["w"].fill_(3.0)
        st.step.add_(9)
    mgr.wait()
    got, _ = mgr.restore((model, st), device="cpu")
    for a, b in zip(_flat(got), want):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# the supervisor
# ---------------------------------------------------------------------------

W0 = np.random.default_rng(11).normal(size=(8, 1)).astype(np.float32)


def _lin_batch(step):
    rng = np.random.default_rng([7, step])
    x = rng.normal(size=(16, 8)).astype(np.float32)
    return {"x": x, "y": (x @ np.linspace(-1, 1, 8, dtype=np.float32)
                          [:, None]).astype(np.float32)}


def _run_loops(tmp_path, loop_cfg, fail_at, tag):
    """The same loop through both packages: a linear model on
    step-indexed batches, one failure injected before step ``fail_at``."""
    def injector():
        fired = []

        def inject(step):
            if step == fail_at and not fired:
                fired.append(step)
                raise RuntimeError(f"injected failure at step {step}")
        return inject

    jstep = jax.jit(jsteps.make_train_step(
        lambda p, b: jnp.mean((b["x"] @ p["w"] - b["y"]) ** 2), J_STEP_CFG))

    def jstep_fn(state, batch):
        p, o, m = jstep(*state, batch)
        return (p, o), m
    jparams = {"w": jnp.asarray(W0)}
    # the reference's manager writes synchronously: its supervisor asks
    # for the latest checkpoint without waiting for the writer thread
    # (ROADMAP Queue 3), so with asynchronous writes a restart right after
    # a save may miss it
    jrep = jtrain_loop((jparams, jopt.init_state(jparams)), jstep_fn,
                       _lin_batch, JCheckpointManager(
                           str(tmp_path / f"j{tag}"), async_write=False),
                       JLoopConfig(**dataclasses.asdict(loop_cfg)),
                       failure_injector=injector())
    step = steps.make_train_step(
        lambda m, b: torch.mean((b["x"] @ m.w - b["y"]) ** 2), STEP_CFG)
    model = _Linear(W0)

    def step_fn(state, batch):
        m, o, metrics = step(*state, batch)
        return (m, o), metrics
    state = (model, optimizer.init_state(model))
    ckpt = CheckpointManager(str(tmp_path / f"t{tag}"))
    rep = train_loop(state, step_fn, _lin_batch, ckpt, loop_cfg,
                     failure_injector=injector())
    assert isinstance(rep, LoopReport)
    return jrep, rep, model, ckpt, state, step_fn


def test_train_loop_restart_and_replay_match_reference(tmp_path):
    """A failure one step after a checkpoint: both supervisors restore it
    and replay the same batches (the port's from an asynchronous write it
    waits for); losses and restarts agree, and a second run on the
    directory resumes from its last checkpoint."""
    cfg = LoopConfig(n_steps=12, ckpt_every=5)
    jrep, rep, model, ckpt, state, step_fn = _run_loops(tmp_path, cfg, 6,
                                                        "a")
    assert (rep.restarts, rep.resumed_from) == (jrep.restarts,
                                                jrep.resumed_from) == (1, None)
    assert len(rep.losses) == len(jrep.losses) == 13
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=LOSS_REL)
    # the replayed step 5 after the restore gives the first run's loss
    assert rep.losses[6] == rep.losses[5]
    more = LoopConfig(n_steps=15, ckpt_every=5)
    rep2 = train_loop(state, step_fn, _lin_batch, ckpt, more)
    assert rep2.resumed_from == 12 and len(rep2.losses) == 3
    assert ckpt.list() == ["ckpt_00000010", "ckpt_00000012",
                           "ckpt_00000015"]


def test_restart_without_checkpoint_starts_from_the_initial_state(tmp_path):
    """No checkpoint before the failure at step 3: the port's supervisor
    loads its copy of the initial state (the steps updated the live one
    in place) and replays from step 0, as the reference's does from its
    untouched initial state."""
    cfg = LoopConfig(n_steps=6, ckpt_every=100)
    jrep, rep, model, *_ = _run_loops(tmp_path, cfg, 3, "b")
    assert rep.restarts == jrep.restarts == 1
    assert rep.losses[3:6] == rep.losses[0:3]
    np.testing.assert_allclose(rep.losses, jrep.losses, rtol=LOSS_REL)


def test_launch_train_on_the_cpu_lowers_the_loss(tmp_path, capsys):
    rep = launch_train.main(["--device", "cpu", "--preset", "lm-tiny",
                             "--steps", "12", "--batch", "4", "--seq", "32",
                             "--ckpt-dir", str(tmp_path), "--ckpt-every",
                             "6"])
    assert len(rep.losses) == 12 and rep.restarts == 0
    assert rep.losses[-1] < rep.losses[0]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000006",
                                            "ckpt_00000012"]
    assert "done: 12 steps" in capsys.readouterr().out


def test_entry_points_need_cuda_without_a_device(monkeypatch, tmp_path):
    """``launch.train``, the checkpoint restore and the models default to
    the card, and raise where CUDA is absent instead of moving to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])
    mgr = CheckpointManager(str(tmp_path), async_write=False)
    mgr.save(1, {"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        mgr.restore({"w": torch.zeros(2)})
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tr.Transformer(launch_train.PRESETS["lm-tiny"])


# ---------------------------------------------------------------------------
# the compressed data-parallel step: four gloo ranks against four devices
# ---------------------------------------------------------------------------

DP_COMMON = textwrap.dedent("""
    import sys
    import numpy as np
    z = np.load(sys.argv[1])
    CFG = dict(lr=1e-2, warmup_steps=1, total_steps=10)
""")

DP_JAX = DP_COMMON + textwrap.dedent("""
    import jax, jax.numpy as jnp
    from jax.sharding import Mesh
    from repro.train import optimizer as opt, steps
    assert len(jax.devices()) == 4
    mesh = Mesh(np.array(jax.devices()).reshape(1, 4, 1),
                ("pod", "data", "model"))
    params = {"w1": jnp.asarray(z["w1"]), "w2": jnp.asarray(z["w2"])}

    def loss(p, b):
        h = jax.nn.relu(b["x"] @ p["w1"])
        return jnp.mean((h @ p["w2"] - b["y"]) ** 2)
    step = steps.make_compressed_dp_step(loss, opt.AdamWConfig(**CFG), mesh)
    st, res, out = opt.init_state(params), opt.init_residual(params), {}
    for i in range(2):
        b = {"x": jnp.asarray(z[f"x{i}"]), "y": jnp.asarray(z[f"y{i}"])}
        params, st, res, m = step(params, st, res, b)
        out[f"loss{i}"] = np.asarray(m["loss"])
    for k in params:
        out[f"p.{k}"] = np.asarray(params[k])
        out[f"r.{k}"] = np.asarray(res[k])
        out[f"m.{k}"], out[f"v.{k}"] = np.asarray(st.m[k]), np.asarray(st.v[k])
    np.savez(sys.argv[2], **out)
""")

DP_TORCH = DP_COMMON + textwrap.dedent("""
    import torch
    import torch.distributed as dist
    from torch import nn
    dest, init, rank = sys.argv[2:5]
    dist.init_process_group("gloo", init_method="file://" + init,
                            world_size=4, rank=int(rank))
    try:
        from repro_torch.launch.mesh import Mesh
        from repro_torch.train import optimizer as opt, steps
        mesh = Mesh((1, 4, 1), ("pod", "data", "model"), device="cpu")
        model = nn.Module()
        for k in ("w1", "w2"):
            model.register_parameter(k, nn.Parameter(
                torch.tensor(z[k]), requires_grad=False))

        def loss(m, b):
            h = torch.relu(b["x"] @ m.w1)
            return torch.mean((h @ m.w2 - b["y"]) ** 2)
        step = steps.make_compressed_dp_step(loss, opt.AdamWConfig(**CFG),
                                             mesh)
        st, res, out = opt.init_state(model), opt.init_residual(model), {}
        for i in range(2):
            b = {"x": z[f"x{i}"], "y": z[f"y{i}"]}
            _, _, _, m = step(model, st, res, b)
            out[f"loss{i}"] = m["loss"].numpy()
        for k, p in model.named_parameters():
            out[f"p.{k}"], out[f"r.{k}"] = p.numpy(), res[k].numpy()
            out[f"m.{k}"], out[f"v.{k}"] = st.m[k].numpy(), st.v[k].numpy()
        np.savez(dest, **out)
    finally:
        dist.destroy_process_group()
""")


def test_compressed_dp_step_four_gloo_ranks_match_four_jax_devices(
        tmp_path):
    """Two steps of ``make_compressed_dp_step`` over a (1, 4, 1) mesh:
    four gloo ranks of the port, one process each, against the
    reference's ``shard_map`` step on four virtual host devices; every
    rank ends with the reference's loss, parameters, residuals and
    moments."""
    rng = np.random.default_rng(3)
    arrays = {"w1": rng.normal(size=(6, 12)).astype(np.float32) * 0.4,
              "w2": rng.normal(size=(12, 1)).astype(np.float32) * 0.3}
    for i in range(2):
        x = rng.normal(size=(16, 6)).astype(np.float32)
        arrays[f"x{i}"] = x
        arrays[f"y{i}"] = np.tanh(x.sum(1, keepdims=True)).astype(np.float32)
    np.savez(tmp_path / "in.npz", **arrays)
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               OMP_NUM_THREADS="1")
    jenv = dict(env, XLA_FLAGS="--xla_force_host_platform_device_count=4 "
                "--xla_cpu_multi_thread_eigen=false "
                "intra_op_parallelism_threads=1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", DP_JAX, str(tmp_path / "in.npz"),
         str(tmp_path / "jax.npz")], env=jenv, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)]
    for r in range(4):
        procs.append(subprocess.Popen(
            [sys.executable, "-c", DP_TORCH, str(tmp_path / "in.npz"),
             str(tmp_path / f"rank{r}.npz"), str(tmp_path / "init"),
             str(r)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE))
    try:
        for i, p in enumerate(procs):
            _, err = p.communicate(timeout=300)
            assert p.returncode == 0, (i, err.decode()[-3000:])
    finally:
        for p in procs:
            p.kill()
    ref = dict(np.load(tmp_path / "jax.npz"))
    for r in range(4):
        got = dict(np.load(tmp_path / f"rank{r}.npz"))
        assert set(got) == set(ref)
        for k, w in ref.items():
            if k.startswith("r.") and r:
                # each rank keeps its own quantization error; the
                # reference's replicated out_spec returns device 0's
                continue
            rel = LOSS_REL if k.startswith("loss") else P_REL
            np.testing.assert_allclose(got[k], w, rtol=rel, atol=P_ABS,
                                       err_msg=f"rank {r} {k}")
    assert not np.allclose(np.load(tmp_path / "rank1.npz")["r.w1"],
                           ref["r.w1"])

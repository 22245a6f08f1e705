"""Per-family cell builders (LM / GNN / RecSys): the counterparts of the
reference's ``build_lm``, ``build_gnn`` and ``build_recsys`` in its
``configs/families.py``.

Each returns a ``Cell``: the rank's program and its arguments at the
reference's shapes and layouts (``smoke=True`` swaps in the tiny shapes,
same code path).  Where the reference hands XLA a global function and
shardings, the program here is written per rank: ``models/spmd.py`` for
the LMs, the GAT's edge-parallel ``axis``, and the recsys models through
their one-device forwards with the row-sharded tables as
``layers.RowShard`` and the towers' shards gathered.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict

import torch

from ..launch.mesh import P
from ..models import gnn, recsys, spmd
from ..models import transformer as tr
from ..models.layers import RowShard
from ..train import optimizer as opt
from ..train import steps
from .base import Arg, Cell, dp_axes_for
from .gnn_archs import GNN_SHAPES, GNN_SMOKE_SHAPES
from .recsys_archs import RECSYS_SHAPES, RECSYS_SMOKE_SHAPES
from .training import OPT_CFG

LM_SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, seq_shard=True),
}
LM_SMOKE_SHAPES = {
    "train_4k": dict(kind="train", seq=64, batch=2),
    "prefill_32k": dict(kind="prefill", seq=128, batch=2),
    "decode_32k": dict(kind="decode", seq=128, batch=2),
    "long_500k": dict(kind="decode", seq=256, batch=1, seq_shard=True),
}


def _n(mesh, axes) -> int:
    return mesh.axis_size(mesh.present(axes))


METRICS = {"loss": P(), "grad_norm": P(), "lr": P()}


def _step_out(specs: Dict[str, P]):
    """A train step's output layouts: the parameters and moments by
    ``specs``, the step count and metrics replicated."""
    return (dict(specs), opt.AdamWState(P(), dict(specs), dict(specs)),
            dict(METRICS))


def _opt_args(params: Dict[str, Arg]) -> opt.AdamWState:
    """AdamW's state beside ``params``: f32 moments in their layout."""
    def mom(a: Arg) -> Arg:
        return Arg(a.shape, torch.float32, a.spec, ("zeros",))
    return opt.AdamWState(
        step=Arg((), torch.int32, P(), ("zeros",)),
        m={k: mom(a) for k, a in params.items()},
        v={k: mom(a) for k, a in params.items()})


# ---------------------------------------------------------------------------
# LM family
# ---------------------------------------------------------------------------

def adapt_lm_cfg(cfg: tr.TransformerConfig, mesh) -> tr.TransformerConfig:
    """The reference's ``_adapt_lm_cfg``: the mesh's data axes, and the
    grouped attention when the model axis divides the kv heads or the
    group width."""
    tp = mesh.shape.get(cfg.tp_axis, 1)
    rep = cfg.n_heads // cfg.n_kv_heads
    grouped = (cfg.n_kv_heads % tp == 0) or (rep % tp == 0)
    return dataclasses.replace(cfg, dp_axes=dp_axes_for(mesh),
                               attn_grouped=grouped)


def lm_param_args(cfg: tr.TransformerConfig) -> Dict[str, Arg]:
    """The LM's parameters as ``Arg``s: ``transformer.param_shapes`` laid
    out by ``param_specs``, drawn as ``Transformer`` draws them (std
    ``1/sqrt(fan_in)``, norms at one, biases at zero)."""
    specs = tr.param_specs(cfg)
    out = {}
    for name, shape in tr.param_shapes(cfg).items():
        leaf = name.rsplit(".", 1)[-1]
        if leaf in ("ln1", "ln2", "ln_f"):
            init = ("ones",)
        elif leaf in ("bq", "bk", "bv"):
            init = ("zeros",)
        else:
            fan = shape[1] if name == "embed" or len(shape) == 3 \
                else shape[0]
            init = ("normal", 1.0 / math.sqrt(fan))
        out[name] = Arg(shape, cfg.param_dtype, specs[name], init)
    return out


def build_lm(cfg: tr.TransformerConfig, shape: str, mesh,
             smoke: bool = False, loss_chunk: int = 512,
             microbatches: int = 2, cast_params: bool = True,
             layers: int = None) -> Cell:
    """One rank's LM cell.  ``layers`` cuts the depth (listed in the
    cell's ``reduced``)."""
    sh = dict((LM_SMOKE_SHAPES if smoke else LM_SHAPES)[shape])
    reduced = {}
    if layers is not None and layers != cfg.n_layers:
        reduced["n_layers"] = (cfg.n_layers, layers)
        cfg = dataclasses.replace(cfg, n_layers=layers)
    cfg = adapt_lm_cfg(cfg, mesh)
    dp = cfg.dp_axes
    if smoke and sh["batch"] > 1:
        sh["batch"] = max(sh["batch"], _n(mesh, dp))
    params = lm_param_args(cfg)
    b, s = sh["batch"], sh["seq"]
    tok = ("randint", 0, cfg.vocab_size)

    if sh["kind"] == "train":
        mb = 1 if smoke else microbatches
        cast = cfg.compute_dtype if (
            cast_params and cfg.compute_dtype != cfg.param_dtype) else None
        batch = {"tokens": Arg((b, s), torch.int32, P(dp, None), tok)}
        n_dp = _n(mesh, dp)

        def loss(leaves, part):
            t = part["tokens"]
            return spmd.lm_loss_chunked(leaves, t, cfg, mesh,
                                        n_global=t.shape[0] * n_dp,
                                        chunk=loss_chunk)

        fn = steps.sharded_train_step(loss, OPT_CFG, mesh,
                                      tr.param_specs(cfg), microbatches=mb,
                                      cast_dtype=cast)
        return Cell(fn=fn, args=(params, _opt_args(params), batch),
                    mesh=mesh, donate=(0, 1), reduced=reduced,
                    out_specs=_step_out(tr.param_specs(cfg)), config=cfg,
                    description=f"lm train B={b} S={s} mb={mb}")

    if sh["kind"] == "prefill":
        tokens = Arg((b, s), torch.int32, P(dp, None), tok)
        # the cache holds the kv heads the rank computed (spmd.layout)
        return Cell(fn=lambda p, t: spmd.prefill(p, t, cfg, mesh),
                    args=(params, tokens), mesh=mesh, reduced=reduced,
                    out_specs=(P(dp, cfg.tp_axis), (None, None)),
                    config=cfg, description=f"lm prefill B={b} S={s}")

    # decode (and long_500k): the sequence-sharded cache whenever the kv
    # heads do not divide the model axis, else kv heads over it
    tp_size = mesh.shape[cfg.tp_axis]
    seq_shard = sh.get("seq_shard", False) or (cfg.n_kv_heads % tp_size
                                               != 0)
    cspec = tr.cache_specs(cfg, seq_shard=seq_shard)
    if seq_shard and b == 1:     # batch cannot shard: sequence over all
        cspec = P(None, None, dp + (cfg.tp_axis,), None, None)
    cshape = (cfg.n_layers, b, s, cfg.n_kv_heads, cfg.head_dim)
    cache = Arg(cshape, torch.bfloat16, cspec, ("normal", 1.0))
    bspec = P(dp) if b > 1 else P()
    token = Arg((b,), torch.int32, bspec, tok)
    clen = Arg((b,), torch.int32, bspec, ("randint", 0, s - 1))
    batch_axes = mesh.present(cspec.axes(1))
    seq_axes = mesh.present(cspec.axes(2))

    def fn(p, t, ck, cv, cl):
        return spmd.decode_step(p, t, ck, cv, cl, cfg, mesh, batch_axes,
                                seq_axes)

    return Cell(fn=fn, args=(params, token, cache, cache, clen), mesh=mesh,
                donate=(2, 3), reduced=reduced, config=cfg,
                out_specs=(P(bspec[0] if len(bspec) else None,
                             cfg.tp_axis), (cspec, cspec)),
                description=f"lm decode B={b} ctx={s}"
                            f"{' seq-sharded' if seq_shard else ''}")


# ---------------------------------------------------------------------------
# GNN family (gat-cora)
# ---------------------------------------------------------------------------

def gnn_param_args(cfg: gnn.GATConfig) -> Dict[str, Arg]:
    specs = gnn.param_specs(cfg)
    out, d_in = {}, cfg.d_in
    for i in range(cfg.n_layers):
        last = i == cfg.n_layers - 1
        heads = 1 if last else cfg.n_heads
        d_out = cfg.n_classes if last else cfg.d_hidden
        pre = f"layers.{i}."
        out[pre + "w"] = Arg((d_in, heads, d_out), torch.float32,
                             specs[pre + "w"],
                             ("normal", 1.0 / math.sqrt(d_in)))
        for k in ("a_src", "a_dst"):
            out[pre + k] = Arg((heads, d_out), torch.float32, specs[pre + k],
                               ("normal", 1.0 / math.sqrt(d_out)))
        out[pre + "b"] = Arg((heads, d_out), torch.float32, specs[pre + "b"])
        d_in = d_out * heads
    return out


def build_gnn(cfg: gnn.GATConfig, shape: str, mesh,
              smoke: bool = False) -> Cell:
    sh = (GNN_SMOKE_SHAPES if smoke else GNN_SHAPES)[shape]
    dp = dp_axes_for(mesh)
    cfg = dataclasses.replace(cfg, d_in=sh["d_feat"])
    params = gnn_param_args(cfg)
    n_shards = _n(mesh, dp)
    skeleton = gnn.GAT(cfg, device="meta", init=False)
    if sh["kind"] == "pooled":
        n_nodes = sh["n_graphs"] * sh["n_nodes"]
        n_edges = -(-sh["n_graphs"] * sh["n_edges"] * 2 // n_shards) \
            * n_shards
    else:
        n_nodes = sh["n_nodes"]
        n_edges = -(-sh["n_edges"] // n_shards) * n_shards
    node = ("randint", 0, n_nodes)
    batch = {"src": Arg((n_edges,), torch.int32, P(dp), node),
             "dst": Arg((n_edges,), torch.int32, P(dp), node),
             "feats": Arg((n_nodes, sh["d_feat"]), torch.float32, P(),
                          ("normal", 1.0))}
    if sh["kind"] == "pooled":
        n_graphs = sh["n_graphs"]
        batch["graph_of"] = Arg((n_nodes,), torch.int32, P(),
                                ("randint", 0, n_graphs))
        batch["labels"] = Arg((n_graphs,), torch.int32, P(),
                              ("randint", 0, cfg.n_classes))

        def loss(leaves, b):
            with steps.swapped(skeleton, leaves):
                return gnn.pooled_loss(skeleton, b["feats"], b["src"],
                                       b["dst"], b["graph_of"], b["labels"],
                                       n_graphs, mesh, dp)
    else:
        batch["labels"] = Arg((n_nodes,), torch.int32, P(),
                              ("randint", 0, cfg.n_classes))

        def loss(leaves, b):
            with steps.swapped(skeleton, leaves):
                return gnn.loss_fn(skeleton, b["feats"], b["src"], b["dst"],
                                   b["labels"], mesh=mesh, axis=dp)

    fn = steps.sharded_train_step(loss, OPT_CFG, mesh, gnn.param_specs(cfg))
    return Cell(fn=fn, args=(params, _opt_args(params), batch), mesh=mesh,
                donate=(0, 1), out_specs=_step_out(gnn.param_specs(cfg)),
                config=cfg, description=f"gnn {shape}: {sh}")


# ---------------------------------------------------------------------------
# RecSys family
# ---------------------------------------------------------------------------

def recsys_param_args(model: str, mcfg, tp: str = "model"
                      ) -> Dict[str, Arg]:
    """A recsys model's parameters as ``Arg``s, drawn as the model draws
    them (``_Maker``'s fan-in per tensor)."""
    specs = recsys.SPECS[model](mcfg, tp)
    skel = recsys.MODELS[model][1](mcfg, device="meta", init=False)
    out = {}
    for name, p in skel.named_parameters():
        shape = tuple(p.shape)
        parts = name.split(".")
        leaf = parts[-1]
        if leaf in ("ln1", "ln2", "ln_f"):
            init = ("ones",)
        elif len(parts) > 1 and parts[-2] == "b":       # an MLP's bias
            init = ("zeros",)
        else:
            axis = {"tables": 2, "item_embed": 1, "user_embed": 1,
                    "pos_embed": 1}.get(leaf, 0)
            init = ("normal", 1.0 / math.sqrt(shape[axis]))
        out[name] = Arg(shape, torch.float32, specs[name], init)
    return out


def _recsys_batch(mcfg, batch: int, dp, hist_len: int
                  ) -> Dict[str, Arg]:
    """The reference's ``_recsys_batch_specs``: every key of every model,
    rows over the data axes."""
    n_sparse = getattr(mcfg, "n_sparse", 26)
    vocab = getattr(mcfg, "vocab", None) or getattr(mcfg, "item_vocab")
    b2 = P(dp, None)
    return {
        "dense": Arg((batch, 13), torch.float32, b2, ("normal", 1.0)),
        "sparse": Arg((batch, n_sparse), torch.int32, b2,
                      ("randint", 0, vocab)),
        "history": Arg((batch, hist_len), torch.int32, b2,
                       ("randint", 0, vocab)),
        "history_mask": Arg((batch, hist_len), torch.bool, b2,
                            ("bernoulli", 0.9)),
        "target_item": Arg((batch,), torch.int32, P(dp),
                           ("randint", 0, vocab)),
        "label": Arg((batch,), torch.float32, P(dp), ("randint", 0, 2))}


class _Recsys:
    """A recsys model's per-rank program: its one-device functions on a
    skeleton (the model on ``meta``) whose parameters are swapped for the
    rank's: each table a ``RowShard`` over the model axis, each tower
    weight split over it gathered (its backward keeps the rank's slice:
    the batch is the same along the model axis), every tensor that the
    data axes' rows meet through ``pvary`` over them."""

    def __init__(self, model: str, mcfg, mesh, tp: str, ids_sharded: bool):
        self.model, self.mcfg, self.mesh = model, mcfg, mesh
        self.tp = mesh.present((tp,))
        self.dp = dp_axes_for(mesh)
        self.specs = recsys.SPECS[model](mcfg, tp)
        self.tables = recsys.TABLES[model]
        self.skeleton = recsys.MODELS[model][1](mcfg, device="meta",
                                                init=False)
        self.full = {n: p.shape for n, p in
                     self.skeleton.named_parameters()}
        self.ids_sharded = ids_sharded

    def view(self, params, vary=True) -> Dict[str, object]:
        mesh, dp = self.mesh, (self.dp if vary else ())
        out = {}
        for name, t in params.items():
            spec = self.specs[name]
            if name in self.tables:
                dim = 1 if name == "tables" else 0
                out[name] = RowShard(t, self.full[name][dim], mesh, self.tp,
                                     vary=dp, ids_sharded=self.ids_sharded,
                                     dim=dim)
                continue
            t = mesh.pvary(t, dp)
            for dim in range(len(spec)):
                axes = mesh.present(spec.axes(dim))
                if axes:
                    t = mesh.all_gather(t, axes, dim=dim, invariant=True)
            out[name] = t
        return out

    def loss(self, leaves, b) -> torch.Tensor:
        """The training loss of the rank's rows, summed over the data
        axes into the global mean."""
        mesh, dp = self.mesh, self.dp
        n = mesh.axis_size(dp)
        with steps.swapped(self.skeleton, self.view(leaves)) as m:
            if self.model in ("din", "dlrm-rm2"):
                return mesh.psum(recsys.recsys_loss(m, b), dp) / n
            # in-batch softmax over the global batch's targets
            if self.model == "sasrec":
                u = recsys.sasrec_encode(m, b["history"], b["history_mask"])
                v = recsys.take_fill(m.item_embed, b["target_item"])
                logq = None
            else:
                u = recsys.user_repr(m, b)
                v = recsys.item_repr(m, b["target_item"])
                logq = -torch.log1p(b["target_item"].float())
            v_all = mesh.all_gather(v, dp, dim=0)
            logits = u @ v_all.T
            if logq is not None:
                logits = logits / self.mcfg.temperature \
                    - mesh.all_gather(logq, dp, dim=0)[None, :]
            bl = u.shape[0]
            gold = logits[torch.arange(bl, device=u.device),
                          mesh.index(dp) * bl
                          + torch.arange(bl, device=u.device)]
            nll = torch.logsumexp(logits, dim=-1) - gold
            return mesh.psum(torch.sum(nll), dp) / (bl * n)

    @torch.no_grad()
    def serve(self, params, batch):
        with steps.swapped(self.skeleton, self.view(params, False)) as m:
            return recsys.recsys_serve(m, batch)

    @torch.no_grad()
    def retrieval(self, params, user, cands):
        with steps.swapped(self.skeleton, self.view(params, False)) as m:
            return recsys.recsys_retrieval(m, user, cands)


def build_recsys(model: str, mcfg, shape: str, mesh,
                 smoke: bool = False) -> Cell:
    sh = (RECSYS_SMOKE_SHAPES if smoke else RECSYS_SHAPES)[shape]
    dp = dp_axes_for(mesh)
    params = recsys_param_args(model, mcfg)
    hist_len = recsys.history_len(mcfg)
    prog = _Recsys(model, mcfg, mesh, "model", sh["kind"] == "retrieval")

    if sh["kind"] == "train":
        batch = _recsys_batch(mcfg, sh["batch"], dp, hist_len)
        fn = steps.sharded_train_step(prog.loss, OPT_CFG, mesh,
                                      prog.specs)
        return Cell(fn=fn, args=(params, _opt_args(params), batch),
                    mesh=mesh, donate=(0, 1), config=mcfg,
                    out_specs=_step_out(prog.specs),
                    description=f"{model} train B={sh['batch']}")

    if sh["kind"] == "serve":
        batch = _recsys_batch(mcfg, sh["batch"], dp, hist_len)
        return Cell(fn=prog.serve, args=(params, batch), mesh=mesh,
                    out_specs=P(dp), config=mcfg,
                    description=f"{model} serve B={sh['batch']}")

    # retrieval_cand: one user context against n_cand candidates
    n_shards = _n(mesh, dp + ("model",))
    n_cand = -(-sh["n_cand"] // n_shards) * n_shards
    vocab = getattr(mcfg, "vocab", None) or getattr(mcfg, "item_vocab")
    user = {"history": Arg((1, hist_len), torch.int32, P(),
                           ("randint", 0, vocab)),
            "history_mask": Arg((1, hist_len), torch.bool, P(),
                                ("bernoulli", 0.9)),
            "dense": Arg((1, 13), torch.float32, P(), ("normal", 1.0))}
    cands = Arg((n_cand,), torch.int32, P(dp + ("model",)),
                ("randint", 0, vocab))
    return Cell(fn=prog.retrieval, args=(params, user, cands), mesh=mesh,
                out_specs=P(dp + ("model",)), config=mcfg,
                description=f"{model} retrieval n_cand={n_cand}")


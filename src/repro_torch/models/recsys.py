"""The recsys family's serving path, the JAX package's ``models/recsys.py``
in PyTorch: DIN, SASRec, two-tower retrieval and DLRM RM-2.

Each model is an ``nn.Module`` holding its weights under the reference's
tree names (``attn.w.0``, ``blocks.1.wq``, ``tables``, ...), drawn on one
device from an explicit ``torch.Generator`` with the reference's fan-in
per tensor: embedding tables over axis 1, DLRM's ``(F, V, d)`` tables
over axis 2, ``pos_embed`` over axis 1, MLP weights over axis 0.  The
forward functions keep the reference's names and semantics, including
its gathers: ``embedding_bag`` clips ids into the table, and every other
gather has ``jnp.take``'s default ("fill": -V..-1 wrap, anything else
outside the table reads NaN), ``layers.take_fill``.

The two-tower model is where Quake plugs in: ``item_repr`` encodes the
candidates, ``user_repr`` the queries, and retrieval is a maximum inner
product search over unit-norm embeddings, exact (``retrieval_scores``)
or through ``QuakeIndex(metric="ip")``.  ``recsys_serve`` and
``recsys_retrieval`` are the reference's serve and retrieval adapters
(``configs/families.py``), with an optional chunk of rows.  The training
losses are the reference's: ``din_loss`` and ``dlrm_loss`` (logistic
loss on the click label), ``sasrec_loss`` (in-batch softmax over next
items) and ``twotower_loss`` (in-batch softmax with the logQ
correction).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable, Dict, Optional, Tuple

import torch
from torch import nn

from ..core.device import resolve_device
from .layers import (MLP, apply_mlp, dense_init, embedding_bag, fill_rows,
                     rmsnorm, take_fill)

Tensor = torch.Tensor
Batch = Dict[str, Tensor]
NEG_INF = -1e30


# ---------------------------------------------------------------------------
# Configs: the reference's fields, its ``tp_axis`` mesh field dropped
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class DINConfig:
    vocab: int = 1_000_000
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: Tuple[int, ...] = (80, 40)
    mlp: Tuple[int, ...] = (200, 80)
    n_dense: int = 13


@dataclass(frozen=True)
class SASRecConfig:
    vocab: int = 1_000_000
    embed_dim: int = 50
    n_blocks: int = 2
    n_heads: int = 1
    seq_len: int = 50


@dataclass(frozen=True)
class TwoTowerConfig:
    user_vocab: int = 1_000_000
    item_vocab: int = 1_000_000
    embed_dim: int = 256
    tower_mlp: Tuple[int, ...] = (1024, 512, 256)
    hist_len: int = 50
    temperature: float = 0.05


@dataclass(frozen=True)
class DLRMConfig:
    n_dense: int = 13
    n_sparse: int = 26
    vocab: int = 1_000_000
    embed_dim: int = 64
    bot_mlp: Tuple[int, ...] = (512, 256, 64)
    top_mlp: Tuple[int, ...] = (512, 512, 256, 1)

    @property
    def n_interactions(self) -> int:
        f = self.n_sparse + 1
        return f * (f - 1) // 2


def history_len(cfg) -> int:
    """The history length of a model's batches (``seq_len`` or
    ``hist_len``; 50 for DLRM, which reads none)."""
    return getattr(cfg, "seq_len", getattr(cfg, "hist_len", 50))


# ---------------------------------------------------------------------------
# Weights
# ---------------------------------------------------------------------------

class _Maker:
    """Draws (``init``) or allocates (for loading) the tensors of one
    model on one device."""

    def __init__(self, device, generator: Optional[torch.Generator],
                 init: bool):
        self.device = resolve_device(device)
        if init and generator is None:
            generator = torch.Generator(device=self.device).manual_seed(0)
        self.generator = generator if init else None

    def dense(self, shape, in_axis: int) -> nn.Parameter:
        t = (dense_init(self.generator, shape, in_axis)
             if self.generator is not None
             else torch.empty(shape, device=self.device))
        return nn.Parameter(t, requires_grad=False)

    def ones(self, n: int) -> nn.Parameter:
        return nn.Parameter(torch.ones(n, device=self.device),
                            requires_grad=False)

    def mlp(self, dims) -> MLP:
        return MLP(dims, generator=self.generator, device=self.device)


class _RecsysModel(nn.Module):
    """A model's weights on one device, drawn from ``generator`` (on
    ``device``; a fresh one seeded with 0 by default); ``init=False``
    leaves them unset, for loading (``convert.recsys_params_from_jax``)."""

    def __init__(self, cfg, *, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 init: bool = True):
        super().__init__()
        self.cfg = cfg
        self._build(_Maker(device, generator, init))

    def _build(self, make: _Maker) -> None:
        raise NotImplementedError


class DIN(_RecsysModel):
    """Deep Interest Network (arXiv:1706.06978)."""

    def _build(self, make):
        cfg, d = self.cfg, self.cfg.embed_dim
        self.item_embed = make.dense((cfg.vocab, d), 1)
        # target-attention MLP over [h, t, h-t, h*t]
        self.attn = make.mlp((4 * d,) + cfg.attn_mlp + (1,))
        # final MLP over [pooled, target, dense]
        self.mlp = make.mlp((2 * d + cfg.n_dense,) + cfg.mlp + (1,))


class SASRecBlock(nn.Module):
    def __init__(self, d: int, make: _Maker):
        super().__init__()
        for name in ("wq", "wk", "wv", "wo", "ff1", "ff2"):
            setattr(self, name, make.dense((d, d), 0))
        self.ln1, self.ln2 = make.ones(d), make.ones(d)


class SASRec(_RecsysModel):
    """Self-attentive sequential recommendation (arXiv:1808.09781)."""

    def _build(self, make):
        cfg, d = self.cfg, self.cfg.embed_dim
        self.blocks = nn.ModuleList(SASRecBlock(d, make)
                                    for _ in range(cfg.n_blocks))
        self.item_embed = make.dense((cfg.vocab, d), 1)
        self.pos_embed = make.dense((cfg.seq_len, d), 1)
        self.ln_f = make.ones(d)


class TwoTower(_RecsysModel):
    """Two-tower retrieval (Yi et al., RecSys'19)."""

    def _build(self, make):
        cfg, d = self.cfg, self.cfg.embed_dim
        self.user_embed = make.dense((cfg.user_vocab, d), 1)
        self.item_embed = make.dense((cfg.item_vocab, d), 1)
        self.user_tower = make.mlp((d,) + cfg.tower_mlp)
        self.item_tower = make.mlp((d,) + cfg.tower_mlp)


class DLRM(_RecsysModel):
    """DLRM (arXiv:1906.00091), the RM-2 configuration."""

    def _build(self, make):
        cfg = self.cfg
        self.tables = make.dense((cfg.n_sparse, cfg.vocab, cfg.embed_dim), 2)
        self.bot = make.mlp((cfg.n_dense,) + cfg.bot_mlp)
        self.top = make.mlp((cfg.n_interactions + cfg.embed_dim,)
                            + cfg.top_mlp)


# the reference's model names (its ``ArchSpec`` registry) -> (config, model)
MODELS = {"din": (DINConfig, DIN), "sasrec": (SASRecConfig, SASRec),
          "two-tower-retrieval": (TwoTowerConfig, TwoTower),
          "dlrm-rm2": (DLRMConfig, DLRM)}


def batch_to(batch, device) -> Batch:
    """A batch of numpy arrays (``RecsysPipeline.batch_at``) as tensors on
    ``device``."""
    return {k: torch.as_tensor(v, device=device) for k, v in batch.items()}


# ---------------------------------------------------------------------------
# Forward functions
# ---------------------------------------------------------------------------

def din_forward(model: DIN, batch: Batch) -> Tensor:
    """(B,) click logits: target attention (a sigmoid MLP over [h, t,
    h - t, h * t]) pools the history; masked positions score -1e30, so a
    history with no valid entry pools with uniform weights."""
    hist = take_fill(model.item_embed, batch["history"])
    tgt = take_fill(model.item_embed, batch["target_item"])
    t = tgt[:, None, :].expand_as(hist)
    ai = torch.cat([hist, t, hist - t, hist * t], dim=-1)
    scores = apply_mlp(model.attn, ai, act=torch.sigmoid)[..., 0]
    scores = torch.where(batch["history_mask"], scores, NEG_INF)
    w = torch.softmax(scores, dim=-1)
    pooled = torch.einsum("bt,btd->bd", w, hist)
    x = torch.cat([pooled, tgt, batch["dense"]], dim=-1)
    return apply_mlp(model.mlp, x, act=torch.relu)[..., 0]


def sasrec_encode(model: SASRec, history: Tensor, mask: Tensor) -> Tensor:
    """(B, T) item history -> (B, d) sequence representation, read at the
    last valid position ``max(sum(mask) - 1, 0)``.  One head of width d,
    causal and key-masked, as a plain einsum (the reference uses no
    kernel here)."""
    b, t = history.shape
    d = model.cfg.embed_dim
    x = take_fill(model.item_embed, history)
    x = x + model.pos_embed[None, :t, :]
    causal = torch.tril(torch.ones((t, t), dtype=torch.bool,
                                   device=x.device))
    attn_mask = causal[None, :, :] & mask[:, None, :]
    scale = math.sqrt(float(d))
    for blk in model.blocks:
        h = rmsnorm(x, blk.ln1)
        q, k, v = h @ blk.wq, h @ blk.wk, h @ blk.wv
        s = torch.einsum("bqd,bkd->bqk", q, k) / scale
        s = torch.where(attn_mask, s, NEG_INF)
        a = torch.softmax(s, dim=-1)
        x = x + (torch.einsum("bqk,bkd->bqd", a, v) @ blk.wo)
        h2 = rmsnorm(x, blk.ln2)
        x = x + torch.relu(h2 @ blk.ff1) @ blk.ff2
    x = rmsnorm(x, model.ln_f)
    last = torch.clamp(torch.sum(mask, dim=1) - 1, min=0)
    return x[torch.arange(b, device=x.device), last]


def _unit(x: Tensor) -> Tensor:
    return x / torch.clamp(torch.linalg.norm(x, dim=-1, keepdim=True),
                           min=1e-6)


def user_repr(model: TwoTower, batch: Batch) -> Tensor:
    """(B, d) unit-norm user embeddings: the mean of the valid history
    rows of ``user_embed`` (clipped ids), then the user tower."""
    u = embedding_bag(model.user_embed, batch["history"], mode="mean",
                      valid=batch["history_mask"])
    return _unit(apply_mlp(model.user_tower, u, act=torch.relu))


def item_repr(model: TwoTower, item_ids: Tensor) -> Tensor:
    """(N, d) unit-norm item embeddings of ``item_ids`` (``item_embed``
    rows, then the item tower)."""
    i = take_fill(model.item_embed, item_ids)
    return _unit(apply_mlp(model.item_tower, i, act=torch.relu))


def retrieval_scores(model: TwoTower, batch: Batch,
                     candidates: Tensor) -> Tensor:
    """``retrieval_cand``: (B, n_cand) inner products of the users against
    encoded candidates (N, d): one GEMM.  Quake is the approximate
    alternative."""
    return user_repr(model, batch) @ candidates.T


def _dlrm_lookup(tables: Tensor, sparse: Tensor) -> Tensor:
    """tables (F, V, d), sparse ids (B, F) -> (B, F, d): field f's id
    gathered from table f with ``take_fill``'s semantics."""
    f, v, d = tables.shape
    rows, ok = fill_rows(sparse, v)
    rows = rows + v * torch.arange(f, device=sparse.device)
    out = tables.reshape(f * v, d).index_select(0, rows.reshape(-1))
    return out.reshape(*sparse.shape, d).masked_fill_(~ok[..., None],
                                                      float("nan"))


def dlrm_forward(model: DLRM, batch: Batch) -> Tensor:
    """(B,) click logits: the bottom MLP on the dense features, the 26
    field embeddings, their pairwise dot products read at
    ``triu_indices(F + 1, k=1)`` in row-major order, then the top MLP."""
    dense = apply_mlp(model.bot, batch["dense"], act=torch.relu,
                      final_act=True)                      # (B, d)
    emb = _dlrm_lookup(model.tables, batch["sparse"])
    feats = torch.cat([dense[:, None, :], emb], dim=1)      # (B, F+1, d)
    inter = torch.einsum("bfd,bgd->bfg", feats, feats)
    f = feats.shape[1]
    iu, ju = torch.triu_indices(f, f, 1, device=feats.device)
    x = torch.cat([dense, inter[:, iu, ju]], dim=-1)
    return apply_mlp(model.top, x, act=torch.relu)[..., 0]


# ---------------------------------------------------------------------------
# Training losses
# ---------------------------------------------------------------------------

def _logistic(logit: Tensor, y: Tensor) -> Tensor:
    """The mean of the stable binary cross-entropy ``max(z, 0) - z * y +
    log1p(exp(-|z|))``."""
    return torch.mean(torch.clamp(logit, min=0) - logit * y
                      + torch.log1p(torch.exp(-torch.abs(logit))))


def _in_batch_softmax(logits: Tensor) -> Tensor:
    """Mean cross-entropy of (B, B) logits whose row b's label is b."""
    return torch.mean(torch.logsumexp(logits, dim=-1)
                      - torch.diagonal(logits))


def din_loss(model: DIN, batch: Batch) -> Tensor:
    return _logistic(din_forward(model, batch), batch["label"])


def sasrec_loss(model: SASRec, batch: Batch) -> Tensor:
    """In-batch sampled softmax over next items: each row's target item is
    its positive and the other rows' targets its negatives."""
    h = sasrec_encode(model, batch["history"], batch["history_mask"])
    tgt = take_fill(model.item_embed, batch["target_item"])
    return _in_batch_softmax(h @ tgt.T)


def twotower_loss(model: TwoTower, batch: Batch) -> Tensor:
    """In-batch sampled softmax at ``temperature`` with the logQ
    correction: the in-batch negatives are Zipf-skewed, so each column's
    logit is raised by ``log1p(item id)`` (minus the log of its Zipf
    propensity, up to a constant)."""
    u = user_repr(model, batch)
    v = item_repr(model, batch["target_item"])
    logits = (u @ v.T) / model.cfg.temperature
    logq = -torch.log1p(batch["target_item"].float())
    return _in_batch_softmax(logits - logq[None, :])


def dlrm_loss(model: DLRM, batch: Batch) -> Tensor:
    return _logistic(dlrm_forward(model, batch), batch["label"])


# the losses by model class
LOSSES = {DIN: din_loss, SASRec: sasrec_loss, TwoTower: twotower_loss,
          DLRM: dlrm_loss}


def recsys_loss(model, batch: Batch) -> Tensor:
    """The training loss of ``model``'s family."""
    return LOSSES[type(model)](model, batch)


# ---------------------------------------------------------------------------
# Serve and retrieval (the reference's adapters in configs/families.py)
# ---------------------------------------------------------------------------

def _in_chunks(fn: Callable[[slice], Tensor], n: int,
               chunk: Optional[int]) -> Tensor:
    """``fn(slice(None))``, or ``fn`` over consecutive slices of ``chunk``
    rows, concatenated: every function here treats rows independently."""
    if chunk is None or chunk >= n:
        return fn(slice(None))
    return torch.cat([fn(slice(i, i + chunk)) for i in range(0, n, chunk)])


def _rows(batch: Batch, s: slice) -> Batch:
    return {k: v[s] for k, v in batch.items()}


def recsys_score(model, batch: Batch) -> Tensor:
    """The serve score of the models whose natural serve output is a
    relevance score: SASRec next-item (the sequence representation dotted
    with the target item's embedding) and two-tower user-item."""
    if isinstance(model, SASRec):
        h = sasrec_encode(model, batch["history"], batch["history_mask"])
        tgt = take_fill(model.item_embed, batch["target_item"])
        return torch.sum(h * tgt, dim=-1)
    if isinstance(model, TwoTower):
        u = user_repr(model, batch)
        v = item_repr(model, batch["target_item"])
        return torch.sum(u * v, dim=-1)
    raise TypeError(f"no serve score for {type(model).__name__}")


@torch.no_grad()
def recsys_serve(model, batch: Batch, chunk: Optional[int] = None) -> Tensor:
    """(B,) serve outputs: DIN's and DLRM's forward, SASRec's and the two
    tower's score; ``chunk`` rows at a time."""
    fwd = {DIN: din_forward, DLRM: dlrm_forward}.get(type(model),
                                                     recsys_score)
    n = next(iter(batch.values())).shape[0]
    return _in_chunks(lambda s: fwd(model, _rows(batch, s)), n, chunk)


@torch.no_grad()
def recsys_retrieval(model, user: Batch, cand_ids: Tensor,
                     chunk: Optional[int] = None) -> Tensor:
    """(n_cand,) scores of one user context (``history``,
    ``history_mask``, ``dense``, each with a leading axis of 1) against
    ``cand_ids``, ``chunk`` candidates at a time.  Two-tower: the user
    embedding against the encoded candidates; SASRec: the sequence
    representation against the candidates' embeddings; DIN: the user
    broadcast over the candidates as targets; DLRM: the first sparse
    field set to the candidate, the others to 0."""
    n = cand_ids.shape[0]
    if isinstance(model, TwoTower):
        u = user_repr(model, user)                             # (1, d)
        return _in_chunks(
            lambda s: (u @ item_repr(model, cand_ids[s]).T)[0], n, chunk)
    if isinstance(model, SASRec):
        h = sasrec_encode(model, user["history"], user["history_mask"])
        return _in_chunks(
            lambda s: (h @ take_fill(model.item_embed, cand_ids[s]).T)[0],
            n, chunk)
    if isinstance(model, DIN):
        def din(s):
            c = cand_ids[s]
            m = c.shape[0]
            return din_forward(model, {
                "history": user["history"].expand(m, -1),
                "history_mask": user["history_mask"].expand(m, -1),
                "dense": user["dense"].expand(m, -1),
                "target_item": c})
        return _in_chunks(din, n, chunk)
    if isinstance(model, DLRM):
        cfg = model.cfg

        def dlrm(s):
            c = cand_ids[s]
            m = c.shape[0]
            sparse = torch.zeros((m, cfg.n_sparse), dtype=torch.int32,
                                 device=c.device)
            sparse[:, 0] = c
            return dlrm_forward(model, {
                "dense": user["dense"].expand(m, cfg.n_dense),
                "sparse": sparse})
        return _in_chunks(dlrm, n, chunk)
    raise TypeError(f"no retrieval for {type(model).__name__}")

"""The port's LM serving path (repro_torch.models) against the JAX package.

Every case gives both packages the same numpy inputs: the flash kernel's
plain version against the Pallas kernel in interpret mode (as
tests/test_kernels.py runs it), the layers against ``repro.models.layers``,
and ``prefill``/``decode_step`` of the three dense smoke configs against
the reference's with ``attn_impl="pallas"``, the weights carried over by
``params_from_jax``.  Attention tiles are small (16 x 8 here) so prompts
span several tiles, with a ragged last one.

Tolerances: f32 attention to rtol = atol = 2e-5 (tests/test_kernels.py's
bound for the kernel); bf16 attention to one bf16 ulp of the output,
2^-7 |o|, plus 1e-3 (a score that differs in its last f32 bit can round p
the other way); the layers and whole models to 1e-4 (the bound of
tests/test_kernels.py's prefill test: two frameworks summing in other
orders through two layers).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as jarch
from repro.kernels.flash_attention import flash_attention_pallas
from repro.models import layers as jlayers
from repro.models import transformer as jtr
from repro_torch.configs import lm_archs
from repro_torch.kernels import flash_attention as fa
from repro_torch.models import layers, transformer as tr
from repro_torch.models.convert import config_from_jax, params_from_jax

F32_TOL = 2e-5
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-3
MODEL_TOL = 1e-4
DENSE_SMOKE = ["mistral_large_smoke", "granite_smoke", "qwen25_smoke"]
ARCHS = [("mistral_large_123b", "mistral_large_smoke"),
         ("granite_34b", "granite_smoke"), ("qwen25_14b", "qwen25_smoke"),
         ("qwen3_moe_235b", "qwen3_moe_smoke"),
         ("llama4_scout", "llama4_scout_smoke")]
PROMPT = 40                 # tokens: 3 query tiles of 16, 5 key tiles of 8


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


# ---------------------------------------------------------------------------
# the kernel's plain version against the Pallas kernel
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("b,h,kh,sq,sk,d,causal", [
    (2, 8, 1, 96, 96, 32, True),     # MQA causal
    (1, 8, 2, 128, 128, 64, True),   # GQA
    (2, 4, 4, 100, 120, 32, False),  # MHA cross, unaligned lengths
    (1, 6, 2, 64, 256, 16, True),    # long kv
])
def test_flash_plain_matches_pallas(b, h, kh, sq, sk, d, causal):
    """The four shapes of tests/test_kernels.py, f32, 32 x 32 tiles."""
    rng = np.random.default_rng(b * 100 + h + sq)
    q = rng.normal(size=(b, sq, h, d)).astype(np.float32)
    k = rng.normal(size=(b, sk, kh, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, kh, d)).astype(np.float32)
    ref = flash_attention_pallas(jnp.asarray(q), jnp.asarray(k),
                                 jnp.asarray(v), causal=causal, q_block=32,
                                 k_block=32)
    out = fa.flash_attention_plain(_t(q), _t(k), _t(v), causal=causal,
                                   q_block=32, k_block=32)
    assert out.shape == (b, sq, h, d) and out.dtype == torch.float32
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=F32_TOL,
                               atol=F32_TOL)


def test_flash_plain_matches_pallas_bf16():
    rng = np.random.default_rng(7)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((2, 80, 8, 32), (2, 80, 2, 32), (2, 80, 2, 32)))
    ref = flash_attention_pallas(*(jnp.asarray(x, jnp.bfloat16)
                                   for x in (q, k, v)),
                                 causal=True, q_block=32, k_block=16)
    out = fa.flash_attention_plain(*(_t(x).bfloat16() for x in (q, k, v)),
                                   causal=True, q_block=32, k_block=16)
    assert out.dtype == torch.bfloat16
    ref = np.asarray(ref.astype(jnp.float32))
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=BF16_RTOL,
                               atol=BF16_ATOL)


@pytest.mark.parametrize("b,h,kh,sq,sk,d,causal", [
    (1, 4, 2, 100, 100, 64, True),    # Sq < BQ, Sk not a multiple of BK
    (1, 4, 2, 100, 150, 128, False),  # full, Sq < Sk
    (2, 4, 1, 200, 200, 128, True),   # MQA, a ragged second query tile
    (1, 2, 2, 150, 90, 64, False),    # MHA, Sq > Sk
])
def test_flash_plain_matches_pallas_at_bf16_kernel_tiles(b, h, kh, sq, sk, d,
                                                         causal):
    """bf16 at the tiles of the tensor-core kernel (TILES[bfloat16]),
    where its plain version on the card rounds p."""
    bq, bk = fa.TILES[torch.bfloat16]
    rng = np.random.default_rng(b * 1000 + sq + sk + d)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((b, sq, h, d), (b, sk, kh, d), (b, sk, kh, d)))
    ref = flash_attention_pallas(*(jnp.asarray(x, jnp.bfloat16)
                                   for x in (q, k, v)),
                                 causal=causal, q_block=bq, k_block=bk)
    out = fa.flash_attention_plain(*(_t(x).bfloat16() for x in (q, k, v)),
                                   causal=causal, q_block=bq, k_block=bk)
    assert out.shape == (b, sq, h, d) and out.dtype == torch.bfloat16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(ref.astype(jnp.float32)),
                               rtol=BF16_RTOL, atol=BF16_ATOL)


def test_flash_dispatch_on_cpu_takes_the_plain_version():
    rng = np.random.default_rng(3)
    q = _t(rng.normal(size=(1, 20, 4, 16)).astype(np.float32))
    k = _t(rng.normal(size=(1, 20, 2, 16)).astype(np.float32))
    before = fa.LAUNCHES.count
    out = fa.flash_attention(q, k, k, causal=True, q_block=8, k_block=8)
    assert fa.LAUNCHES.count == before
    assert torch.equal(out, fa.flash_attention_plain(
        q, k, k, causal=True, q_block=8, k_block=8))
    with pytest.raises(ValueError):            # CPU tensors never launch
        fa.flash_attention_cuda(q, k, k, causal=True)
    with pytest.raises(ValueError):            # neither CPU nor CUDA
        fa.flash_attention(q.to("meta"), k.to("meta"), k.to("meta"))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def _layer_case(name, dtype):
    rng = np.random.default_rng(11)
    if name == "rmsnorm":
        x = rng.normal(size=(2, 9, 48)).astype(np.float32)
        s = rng.normal(size=(48,)).astype(np.float32)
        return (jlayers.rmsnorm(jnp.asarray(x, dtype[0]), jnp.asarray(s)),
                layers.rmsnorm(_t(x).to(dtype[1]), _t(s)))
    if name == "apply_rope":
        x = rng.normal(size=(2, 33, 4, 16)).astype(np.float32)
        pos = rng.integers(0, 4096, (2, 33))
        fj = jlayers.rope_frequencies(16, 1e6)
        ft = layers.rope_frequencies(16, 1e6)
        _close(ft.numpy(), np.asarray(fj), 1e-6)
        return (jlayers.apply_rope(jnp.asarray(x, dtype[0]),
                                   jnp.asarray(pos), fj),
                layers.apply_rope(_t(x).to(dtype[1]), _t(pos), ft))
    q = rng.normal(size=(3, 1, 8, 16)).astype(np.float32)
    kc = rng.normal(size=(3, 24, 2, 16)).astype(np.float32)
    vc = rng.normal(size=(3, 24, 2, 16)).astype(np.float32)
    cl = np.array([24, 1, 13])
    return (jlayers.decode_attention(*(jnp.asarray(a, dtype[0])
                                       for a in (q, kc, vc)),
                                     jnp.asarray(cl)),
            layers.decode_attention(*(_t(a).to(dtype[1])
                                      for a in (q, kc, vc)), _t(cl)))


F32 = (jnp.float32, torch.float32)
BF16 = (jnp.bfloat16, torch.bfloat16)


# no bf16 decode_attention: XLA's CPU backend has no bf16 x bf16 -> f32 dot
@pytest.mark.parametrize("name,dtype", [
    ("rmsnorm", F32), ("rmsnorm", BF16), ("apply_rope", F32),
    ("apply_rope", BF16), ("decode_attention", F32)],
    ids=["rmsnorm-f32", "rmsnorm-bf16", "apply_rope-f32", "apply_rope-bf16",
         "decode_attention-f32"])
def test_layer_matches_reference(name, dtype):
    ref, out = _layer_case(name, dtype)
    assert out.dtype == dtype[1] and tuple(out.shape) == ref.shape
    ref = np.asarray(ref.astype(jnp.float32))
    if dtype[1] == torch.float32:
        _close(out.numpy(), ref, MODEL_TOL)
    else:
        np.testing.assert_allclose(out.float().numpy(), ref,
                                   rtol=BF16_RTOL, atol=BF16_ATOL)


# ---------------------------------------------------------------------------
# configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("size", ["full", "smoke"])
@pytest.mark.parametrize("arch", ARCHS, ids=[a[0] for a in ARCHS])
def test_config_matches_reference(arch, size):
    fn = arch[0] if size == "full" else arch[1]
    jcfg = getattr(jarch, fn)()
    cfg = getattr(lm_archs, fn)()
    assert config_from_jax(dataclasses.asdict(jcfg)) == cfg
    assert tr.param_count(cfg) == jtr.param_count(jcfg)
    assert tr.active_param_count(cfg) == jtr.active_param_count(jcfg)


@pytest.mark.parametrize("fn", ["qwen3_moe_smoke", "llama4_scout_smoke"])
def test_moe_config_raises(fn):
    """An MoE config builds (tests/test_torch_moe.py holds it against the
    reference); one that routes to more experts than it has raises."""
    cfg = getattr(lm_archs, fn)()
    assert len(tr.Transformer(cfg, device="cpu").blocks) == cfg.n_layers
    bad = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, top_k=cfg.moe.n_experts + 1))
    with pytest.raises(ValueError, match="top_k"):
        tr.Transformer(bad, device="cpu")


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=DENSE_SMOKE)
def served(request):
    """One smoke config in both packages: the reference's params (biases
    drawn nonzero, so the QKV bias is exercised), its prefill of a 40-token
    prompt through the Pallas kernel, and the port's model from the same
    weights."""
    jcfg = dataclasses.replace(getattr(jarch, request.param)(),
                               attn_impl="pallas", q_block=16, k_block=8)
    params = jtr.init_params(jax.random.PRNGKey(0), jcfg)
    rng = np.random.default_rng(1)
    if jcfg.qkv_bias:
        params["attn"] = {**params["attn"], **{
            n: jnp.asarray(rng.normal(size=params["attn"][n].shape)
                           .astype(np.float32) * 0.1)
            for n in ("bq", "bk", "bv")}}
    params = jax.tree.map(np.asarray, params)
    toks = rng.integers(0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    ref = jtr.prefill(params, jnp.asarray(toks), jcfg)
    cfg = config_from_jax(dataclasses.asdict(jcfg))
    model = params_from_jax(params, cfg, device="cpu")
    return dict(jcfg=jcfg, params=params, toks=toks, ref=ref, model=model)


def test_prefill_matches_reference(served):
    lg_ref, (ck_ref, cv_ref) = served["ref"]
    lg, (ck, cv) = served["model"].prefill(_t(served["toks"]))
    cfg = served["model"].cfg
    assert ck.shape == (cfg.n_layers, 2, PROMPT, cfg.n_kv_heads,
                        cfg.head_dim)
    for a, b in ((lg, lg_ref), (ck, ck_ref), (cv, cv_ref)):
        _close(a.numpy(), np.asarray(b), MODEL_TOL)


def test_decode_step_matches_reference(served):
    """One step from the same padded cache (two rows at different
    lengths): logits and both updated caches."""
    _, (ck, cv) = served["ref"]
    pad = ((0, 0), (0, 0), (0, 8), (0, 0), (0, 0))
    ckp, cvp = np.pad(np.asarray(ck), pad), np.pad(np.asarray(cv), pad)
    tok, cl = np.array([3, 7], np.int32), np.array([PROMPT, PROMPT - 3])
    lg_ref, (ck_ref, cv_ref) = jtr.decode_step(
        served["params"], jnp.asarray(tok), jnp.asarray(ckp),
        jnp.asarray(cvp), jnp.asarray(cl), served["jcfg"])
    lg, (ck2, cv2) = served["model"].decode_step(_t(tok), _t(ckp), _t(cvp),
                                                 _t(cl))
    for a, b in ((lg, lg_ref), (ck2, ck_ref), (cv2, cv_ref)):
        _close(a.numpy(), np.asarray(b), MODEL_TOL)


def test_decode_matches_reprefill():
    """In the port alone (f32): decode at position t gives the logits a
    prefill over the t + 1 tokens gives, for three steps."""
    cfg = dataclasses.replace(lm_archs.qwen25_smoke(), q_block=16,
                              k_block=8)
    model = tr.Transformer(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(4))
    toks = _t(np.random.default_rng(5).integers(0, 512, (2, PROMPT + 3)))
    _, (ck, cv) = model.prefill(toks[:, :PROMPT])
    pad = (0, 0, 0, 0, 0, 3)
    ck, cv = torch.nn.functional.pad(ck, pad), torch.nn.functional.pad(cv,
                                                                       pad)
    for t in range(PROMPT, PROMPT + 3):
        lg, (ck, cv) = model.decode_step(toks[:, t], ck, cv,
                                         torch.full((2,), t))
        ref, _ = model.prefill(toks[:, :t + 1])
        _close(lg.numpy(), ref.numpy(), MODEL_TOL)


def test_prefill_takes_the_attention_it_is_given():
    """``prefill(attention=...)`` calls that function once per layer, in
    place of the flash dispatch, with the config's tiles."""
    cfg = dataclasses.replace(lm_archs.granite_smoke(), q_block=16,
                              k_block=8)
    model = tr.Transformer(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(8))
    toks = _t(np.random.default_rng(9).integers(0, 512, (2, PROMPT)))
    seen = []

    def attention(q, k, v, **kw):
        seen.append(kw)
        return fa.flash_attention_plain(q, k, v, **kw)

    lg, (ck, cv) = model.prefill(toks, attention=attention)
    assert seen == [dict(causal=True, q_block=16, k_block=8)] * 2
    lg0, (ck0, cv0) = model.prefill(toks)
    for a, b in ((lg, lg0), (ck, ck0), (cv, cv0)):
        assert torch.equal(a, b)


def test_bf16_storage_matches_f32_storage_under_bf16_compute():
    """Every use casts a weight to the compute dtype first, so weights
    stored in bf16 give the logits and caches of the same weights kept in
    f32, bit for bit, when both compute in bf16."""
    jcfg = jarch.qwen25_smoke()
    params = jax.tree.map(np.asarray,
                          jtr.init_params(jax.random.PRNGKey(2), jcfg))
    cfg = dataclasses.replace(config_from_jax(dataclasses.asdict(jcfg)),
                              compute_dtype=torch.bfloat16, q_block=16,
                              k_block=8)
    m32 = params_from_jax(params, cfg, device="cpu")
    m16 = params_from_jax(params, cfg, device="cpu", dtype=torch.bfloat16)
    assert m16.cfg.param_dtype == torch.bfloat16
    assert m16.blocks[0].wq.dtype == torch.bfloat16
    toks = _t(np.random.default_rng(6).integers(0, 512, (2, 24)))
    lg32, (k32, v32) = m32.prefill(toks)
    lg16, (k16, v16) = m16.prefill(toks)
    assert k16.dtype == torch.bfloat16
    for a, b in ((lg32, lg16), (k32, k16), (v32, v16)):
        assert torch.equal(a, b)

"""The port's MoE FFN and MoE serving (repro_torch.models.transformer)
against the JAX package.

``moe_ffn`` gets the reference's layer-0 weights (through
``params_from_jax``) and the same numpy input, at both smoke configs
(``group_size`` 64) and at capacity factors that keep and drop tokens,
with a zero router (uniform probabilities: every token ties, and all
route to the same k experts), with router logits tied by construction
(values exact in binary, so both frameworks see the same ties), and with
``B*S`` not a multiple of the group.  The tokens that get an all-zero
output (every choice past capacity) must be the same in both.  Then
``prefill`` and ``decode_step`` of both smoke configs, attention through
the Pallas kernel in interpret mode (16 x 8 tiles), as
tests/test_torch_lm.py runs the dense configs.

Tolerances: ``moe_ffn`` alone to 1e-5 * |x| + 1e-5 (one layer of f32
products summed in other orders); the models to 1e-4 * |x| + 1e-4, the
dense models' bound.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as jarch
from repro.models import transformer as jtr
from repro_torch.configs import lm_archs
from repro_torch.models import transformer as tr
from repro_torch.models.convert import config_from_jax, params_from_jax

FFN_TOL = 1e-5
MODEL_TOL = 1e-4
MOE_SMOKE = ["qwen3_moe_smoke", "llama4_scout_smoke"]
PROMPT = 40


def _t(a):
    return torch.from_numpy(np.array(a))


def _close(a, b, tol):
    np.testing.assert_allclose(np.asarray(a, np.float32),
                               np.asarray(b, np.float32), rtol=tol, atol=tol)


def _both(name, cf=None, seed=0):
    """The reference config (``capacity_factor`` set to ``cf``), its
    params as numpy, and the port's model from them."""
    jcfg = getattr(jarch, name)()
    if cf is not None:
        jcfg = dataclasses.replace(
            jcfg, moe=dataclasses.replace(jcfg.moe, capacity_factor=cf))
    params = jax.tree.map(np.asarray,
                          jtr.init_params(jax.random.PRNGKey(seed), jcfg))
    model = params_from_jax(params, config_from_jax(dataclasses.asdict(jcfg)),
                            device="cpu")
    return jcfg, params, model


def _layer0(params):
    return {k: jnp.asarray(v[0]) for k, v in params["moe"].items()}


def _ffn_pair(jcfg, params, model, x):
    """(reference (out, aux), port (out, aux)) of layer 0's MoE on x."""
    ref = jtr.moe_ffn(_layer0(params), jnp.asarray(x), jcfg, None)
    out = tr.moe_ffn(model.blocks[0].moe, _t(x), model.cfg)
    return ref, out


def _check_ffn(ref, out):
    (o_ref, a_ref), (o, a) = ref, out
    o_ref = np.asarray(o_ref)
    assert tuple(o.shape) == o_ref.shape and o.dtype == torch.float32
    _close(o.numpy(), o_ref, FFN_TOL)
    _close(a.numpy(), np.asarray(a_ref), FFN_TOL)
    zero_ref = ~np.abs(o_ref).reshape(-1, o_ref.shape[-1]).any(-1)
    zero = ~o.reshape(-1, o.shape[-1]).abs().numpy().any(-1)
    np.testing.assert_array_equal(zero, zero_ref)
    return int(zero.sum())


@pytest.mark.parametrize("cf", [1.25, 0.5])
@pytest.mark.parametrize("name", MOE_SMOKE)
def test_moe_ffn_matches_reference(name, cf):
    """(2, 40, d) tokens: two groups of 64, the second padded.  At 1.25
    few tokens lose every choice; at 0.5 a quarter or more do."""
    jcfg, params, model = _both(name, cf)
    x = np.random.default_rng(3).normal(
        size=(2, PROMPT, jcfg.d_model)).astype(np.float32)
    dropped = _check_ffn(*_ffn_pair(jcfg, params, model, x))
    if cf < 1:
        assert dropped >= 2 * PROMPT // 4
    else:
        assert dropped < 2 * PROMPT // 8


@pytest.mark.parametrize("name", MOE_SMOKE)
def test_moe_ffn_zero_router_ties_and_drops(name):
    """A zero router gives every token uniform probabilities: each sends
    its k choices to experts 0..k-1 (the lower expert wins every tie), so
    only the first ``cap`` tokens of a group keep them."""
    jcfg, params, model = _both(name)
    params["moe"]["router"] = np.zeros_like(params["moe"]["router"])
    with torch.no_grad():
        model.blocks[0].moe.router.zero_()
    x = np.random.default_rng(4).normal(
        size=(2, PROMPT, jcfg.d_model)).astype(np.float32)
    dropped = _check_ffn(*_ffn_pair(jcfg, params, model, x))
    r = tr.route(model.blocks[0].moe, _t(x), model.cfg.moe)
    k = jcfg.moe.top_k
    assert torch.equal(r.top_e, torch.arange(k).expand_as(r.top_e))
    g = r.xg.shape[1]
    assert dropped == 2 * PROMPT - min(g, r.cap) - min(2 * PROMPT - g, r.cap)


@pytest.mark.parametrize("name", MOE_SMOKE)
def test_moe_ffn_tied_logits(name):
    """Router columns repeated and every operand a small multiple of a
    power of two, so the logits are exact and tie exactly in both
    frameworks: the experts chosen are ``lax.top_k``'s, lower expert
    first, and the outputs match."""
    jcfg, params, model = _both(name)
    rng = np.random.default_rng(5)
    d, e = jcfg.d_model, jcfg.moe.n_experts
    cols = rng.integers(-2, 3, size=(d, 3)) * 0.25
    router = cols[:, rng.integers(0, 3, size=e)].astype(np.float32)
    params["moe"]["router"] = np.broadcast_to(
        router, params["moe"]["router"].shape).copy()
    with torch.no_grad():
        model.blocks[0].moe.router.copy_(_t(router))
    x = (rng.integers(-2, 3, size=(2, PROMPT, d)) * 0.5).astype(np.float32)
    _check_ffn(*_ffn_pair(jcfg, params, model, x))
    r = tr.route(model.blocks[0].moe, _t(x), model.cfg.moe)
    logits = jnp.einsum("gtd,de->gte", jnp.asarray(r.xg.numpy()),
                        jnp.asarray(router))
    _, top_e = jax.lax.top_k(jax.nn.softmax(logits, axis=-1),
                             jcfg.moe.top_k)
    np.testing.assert_array_equal(r.top_e.numpy(), np.asarray(top_e))
    if jcfg.moe.top_k > 1:      # ties decided inside some token's top k
        probs = torch.softmax(r.xg @ _t(router), -1)
        top2 = torch.sort(probs, -1, descending=True).values[..., :2]
        assert bool((top2[..., 0] == top2[..., 1]).any())


@pytest.mark.parametrize("shape", [(3, 25), (1, 7)], ids=["75-tokens",
                                                          "under-a-group"])
@pytest.mark.parametrize("name", MOE_SMOKE)
def test_moe_ffn_ragged_groups(name, shape):
    """75 tokens: a group of 64 and one of 11 real tokens padded with 53
    zero rows, at a dropping capacity; 7 tokens: one group of 7."""
    jcfg, params, model = _both(name, 0.5)
    x = np.random.default_rng(6).normal(
        size=shape + (jcfg.d_model,)).astype(np.float32)
    _check_ffn(*_ffn_pair(jcfg, params, model, x))


def test_moe_route_slots_are_token_major():
    """Each pair's slot counts the earlier pairs (in token-major order)
    sent to its expert in its group; the padding's pairs come after every
    real token's."""
    _, _, model = _both("qwen3_moe_smoke")
    x = _t(np.random.default_rng(7).normal(size=(1, 70, 64))
           .astype(np.float32))
    r = tr.route(model.blocks[0].moe, x, model.cfg.moe)
    ng, g, k = r.top_e.shape
    assert (ng, g, k) == (2, 64, 2)
    for grp in range(ng):
        e = r.top_e[grp].reshape(-1).tolist()
        want = [e[:i].count(v) for i, v in enumerate(e)]
        assert r.slot[grp].reshape(-1).tolist() == want
    assert not r.xg[1, 6:].any()


# ---------------------------------------------------------------------------
# prefill and decode against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module", params=MOE_SMOKE)
def served(request):
    """One MoE smoke config in both packages: the reference's params, its
    prefill of a (2, 40) prompt through the Pallas kernel (80 tokens: two
    groups of 64), and the port's model from the same weights."""
    jcfg = dataclasses.replace(getattr(jarch, request.param)(),
                               attn_impl="pallas", q_block=16, k_block=8)
    params = jax.tree.map(np.asarray,
                          jtr.init_params(jax.random.PRNGKey(1), jcfg))
    toks = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (2, PROMPT)).astype(np.int32)
    ref = jtr.prefill(params, jnp.asarray(toks), jcfg)
    model = params_from_jax(params, config_from_jax(dataclasses.asdict(jcfg)),
                            device="cpu")
    return dict(jcfg=jcfg, params=params, toks=toks, ref=ref, model=model)


def test_moe_prefill_matches_reference(served):
    lg_ref, (ck_ref, cv_ref) = served["ref"]
    lg, (ck, cv) = served["model"].prefill(_t(served["toks"]))
    for a, b in ((lg, lg_ref), (ck, ck_ref), (cv, cv_ref)):
        _close(a.numpy(), np.asarray(b), MODEL_TOL)


def test_moe_decode_step_matches_reference(served):
    """One step of two rows at different lengths from the same padded
    cache: one group of two tokens."""
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


@pytest.mark.parametrize("name", MOE_SMOKE)
def test_moe_decode_matches_reprefill_without_drops(name):
    """In the port alone: at ``capacity_factor = E / top_k`` no pair is
    dropped (cap >= g), so an MoE token's output depends on that token
    alone and decode at t gives a prefill's logits over t + 1 tokens."""
    base = getattr(lm_archs, name)()
    moe = dataclasses.replace(
        base.moe, capacity_factor=base.moe.n_experts / base.moe.top_k)
    cfg = dataclasses.replace(base, moe=moe, q_block=16, k_block=8)
    model = tr.Transformer(cfg, device="cpu",
                           generator=torch.Generator().manual_seed(4))
    toks = _t(np.random.default_rng(5).integers(0, 512, (2, PROMPT + 3)))
    _, (ck, cv) = model.prefill(toks[:, :PROMPT])
    pad = (0, 0, 0, 0, 0, 3)
    ck = torch.nn.functional.pad(ck, pad)
    cv = torch.nn.functional.pad(cv, pad)
    for t in range(PROMPT, PROMPT + 3):
        lg, (ck, cv) = model.decode_step(toks[:, t], ck, cv,
                                         torch.full((2,), t))
        ref, _ = model.prefill(toks[:, :t + 1])
        _close(lg.numpy(), ref.numpy(), MODEL_TOL)


@pytest.mark.parametrize("name", MOE_SMOKE)
def test_moe_bf16_storage_matches_f32_storage_under_bf16_compute(name):
    """Every MoE weight is cast to the compute dtype before use (the
    router then widened to f32), so bf16 storage gives f32 storage's
    logits bit for bit under bf16 compute."""
    jcfg = getattr(jarch, name)()
    params = jax.tree.map(np.asarray,
                          jtr.init_params(jax.random.PRNGKey(2), jcfg))
    cfg = dataclasses.replace(config_from_jax(dataclasses.asdict(jcfg)),
                              compute_dtype=torch.bfloat16, q_block=16,
                              k_block=8)
    m32 = params_from_jax(params, cfg, device="cpu")
    m16 = params_from_jax(params, cfg, device="cpu", dtype=torch.bfloat16)
    assert m16.blocks[0].moe.w_up.dtype == torch.bfloat16
    toks = _t(np.random.default_rng(6).integers(0, 512, (2, 24)))
    lg32, (k32, _) = m32.prefill(toks)
    lg16, (k16, _) = m16.prefill(toks)
    assert torch.equal(lg32, lg16) and torch.equal(k32, k16)
    assert bool(torch.isfinite(lg16).all())


def test_moe_params_match_reference_layout():
    """The port draws the reference's shapes with its fan-in stds: the
    experts' from d (gate, up) and d_ff (down), the router's from d."""
    cfg = lm_archs.qwen3_moe_smoke()
    model = tr.Transformer(cfg, device="cpu")
    jparams = jax.eval_shape(lambda k: jtr.init_params(k, jarch.qwen3_moe_smoke()),
                             jax.random.PRNGKey(0))
    moe = model.blocks[0].moe
    for name in ("router", "w_gate", "w_up", "w_down"):
        assert tuple(getattr(moe, name).shape) == \
            jparams["moe"][name].shape[1:]
    d, fe = cfg.d_model, cfg.moe.d_ff
    for w, fan in ((moe.w_gate, d), (moe.w_down, fe), (moe.router, d)):
        assert abs(float(w.std()) * fan ** 0.5 - 1.0) < 0.1
    shared = tr.Transformer(lm_archs.llama4_scout_smoke(),
                            device="cpu").blocks[0].shared_mlp
    assert tuple(shared.w_down.shape) == (64, 64)

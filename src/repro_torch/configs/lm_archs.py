"""The five LM architectures of the JAX package's ``configs/lm_archs.py``
(the published configs) and their reduced smoke configs, as plain data.
The reference's ``ArchSpec`` registry and ``build_lm`` lowerings are JAX
compile machinery and are not ported."""
from __future__ import annotations

import torch

from ..models.transformer import MoEConfig, TransformerConfig


# -- mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407] ----------

def mistral_large_123b() -> TransformerConfig:
    return TransformerConfig(
        n_layers=88, d_model=12288, n_heads=96, n_kv_heads=8, d_head=128,
        d_ff=28672, vocab_size=32768)


def mistral_large_smoke() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=128, n_heads=8, n_kv_heads=2, d_head=16,
        d_ff=256, vocab_size=512,
        compute_dtype=torch.float32, remat=False)


# -- granite-34b [arXiv:2405.04324] — llama-arch code model, MQA ------------

def granite_34b() -> TransformerConfig:
    return TransformerConfig(
        n_layers=88, d_model=6144, n_heads=48, n_kv_heads=1, d_head=128,
        d_ff=24576, vocab_size=49152)


def granite_smoke() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=96, n_heads=6, n_kv_heads=1, d_head=16,
        d_ff=192, vocab_size=512,
        compute_dtype=torch.float32, remat=False)


# -- qwen2.5-14b [hf:Qwen/Qwen2.5-14B] — GQA + QKV bias ---------------------

def qwen25_14b() -> TransformerConfig:
    return TransformerConfig(
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
        d_ff=13824, vocab_size=152064, qkv_bias=True)


def qwen25_smoke() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=80, n_heads=5, n_kv_heads=1, d_head=16,
        d_ff=160, vocab_size=512, qkv_bias=True,
        compute_dtype=torch.float32, remat=False)


# -- qwen3-moe-235b-a22b [hf:Qwen/Qwen3-235B-A22B] — 128e top-8 -------------

def qwen3_moe_235b() -> TransformerConfig:
    return TransformerConfig(
        n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
        d_ff=0, vocab_size=151936,
        moe=MoEConfig(n_experts=128, top_k=8, d_ff=1536))


def qwen3_moe_smoke() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=0, vocab_size=512,
        compute_dtype=torch.float32, remat=False,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff=32, group_size=64))


# -- llama4-scout-17b-16e [hf:meta-llama/Llama-4-Scout-17B-16E] -------------
# MoE 16 routed experts top-1 + 1 shared expert (text backbone only).

def llama4_scout() -> TransformerConfig:
    return TransformerConfig(
        n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8, d_head=128,
        d_ff=0, vocab_size=202048,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff=8192, n_shared=1))


def llama4_scout_smoke() -> TransformerConfig:
    return TransformerConfig(
        n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, d_head=16,
        d_ff=0, vocab_size=512,
        compute_dtype=torch.float32, remat=False,
        moe=MoEConfig(n_experts=4, top_k=1, d_ff=64, n_shared=1,
                      group_size=64))

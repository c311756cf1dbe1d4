"""Assigned architecture pool: exact configs from public literature.

Sources per the assignment sheet; shapes verified against HF configs /
papers where available.  Each entry also carries numerics choices scaled to
its size (bf16 params+moments for >=30B total params, fp32 otherwise).
"""
from __future__ import annotations

import dataclasses

from ..models.config import (
    ModelConfig,
    dense_pattern,
    jamba_pattern,
    mamba_pattern,
    moe_pattern,
)

_BIG = dict(
    param_dtype="bfloat16",
    moment_dtype="bfloat16",
    accum_dtype="bfloat16",
    seq_shard_carry=True,
)
_SMALL = dict(param_dtype="float32", moment_dtype="float32", accum_dtype="float32")


INTERNLM2_1_8B = ModelConfig(
    name="internlm2-1.8b",            # arXiv:2403.17297 [dense, GQA]
    n_layers=24, d_model=2048, n_heads=16, n_kv_heads=8,
    d_ff=8192, vocab=92544, head_dim=128,
    pattern=dense_pattern(), act="swiglu", rope_theta=1e6, **_SMALL,
)

QWEN3_14B = ModelConfig(
    name="qwen3-14b",                 # hf:Qwen/Qwen3-14B [dense, GQA, qk_norm]
    n_layers=40, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=17408, vocab=151936, head_dim=128,
    pattern=dense_pattern(), act="swiglu", qk_norm=True, rope_theta=1e6, **_SMALL,
)

YI_34B = ModelConfig(
    name="yi-34b",                    # arXiv:2403.04652 [dense, llama-arch GQA]
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000, head_dim=128,
    pattern=dense_pattern(), act="swiglu", rope_theta=5e6, **_BIG,
)

NEMOTRON_4_340B = ModelConfig(
    name="nemotron-4-340b",           # arXiv:2402.16819 [dense, squared-ReLU]
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab=256000, head_dim=192,
    pattern=dense_pattern(), act="squared_relu", **_BIG,
)

MAMBA2_130M = ModelConfig(
    name="mamba2-130m",               # arXiv:2405.21060 [ssm, SSD]
    n_layers=24, d_model=768, n_heads=12, n_kv_heads=12,  # heads unused (attn-free)
    d_ff=0, vocab=50280, head_dim=64,
    pattern=mamba_pattern(),
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, **_SMALL,
)

LLAMA4_SCOUT_17B_A16E = ModelConfig(
    name="llama4-scout-17b-a16e",     # hf:meta-llama/Llama-4-Scout [moe 16e top-1]
    n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
    d_ff=8192, vocab=202048, head_dim=128,
    pattern=moe_pattern(every=1), act="swiglu",
    n_experts=16, top_k=1, n_shared_experts=1, rope_theta=5e5, **_BIG,
)

QWEN3_MOE_235B_A22B = ModelConfig(
    name="qwen3-moe-235b-a22b",       # hf:Qwen/Qwen3-235B-A22B [moe 128e top-8]
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4,
    d_ff=1536, vocab=151936, head_dim=128,
    pattern=moe_pattern(every=1), act="swiglu", qk_norm=True,
    n_experts=128, top_k=8, rope_theta=1e6, **_BIG,
)

JAMBA_V01_52B = ModelConfig(
    name="jamba-v0.1-52b",            # arXiv:2403.19887 [hybrid 1:7 + MoE 16e top-2]
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536, head_dim=128,
    pattern=jamba_pattern(),
    n_experts=16, top_k=2,
    ssm_state=128, ssm_expand=2, ssm_head_dim=64, **_BIG,
)

INTERNVL2_76B = ModelConfig(
    name="internvl2-76b",             # arXiv:2404.16821 [vlm backbone: llama3-70b]
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab=128256, head_dim=128,
    pattern=dense_pattern(), act="swiglu", rope_theta=5e5,
    frontend="vit", frontend_len=256, **_BIG,
)

MUSICGEN_LARGE = ModelConfig(
    name="musicgen-large",            # arXiv:2306.05284 [audio decoder over EnCodec]
    n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=8192, vocab=2048, head_dim=64,
    pattern=dense_pattern(), act="gelu", **_SMALL,
)

ALL = (
    INTERNLM2_1_8B,
    QWEN3_14B,
    YI_34B,
    NEMOTRON_4_340B,
    MAMBA2_130M,
    LLAMA4_SCOUT_17B_A16E,
    QWEN3_MOE_235B_A22B,
    JAMBA_V01_52B,
    INTERNVL2_76B,
    MUSICGEN_LARGE,
)


def smoke_variant(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config: small width/depth, few experts, tiny
    vocab — used by CPU smoke tests; the full configs are exercised only via
    the dry-run (ShapeDtypeStruct, no allocation)."""
    n_layers = len(cfg.pattern)  # one super-block
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=n_layers,
        d_model=64,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        head_dim=16,
        d_ff=0 if cfg.d_ff == 0 else 96,
        vocab=256,
        n_experts=min(cfg.n_experts, 4),
        top_k=min(cfg.top_k, 2),
        # drop-free routing so prefill/decode consistency is exact in tests
        capacity_factor=8.0 if cfg.n_experts else cfg.capacity_factor,
        ssm_state=16 if cfg.ssm_state else 0,
        ssm_head_dim=16 if cfg.ssm_state else 64,
        ssm_chunk=8,
        frontend_len=8 if cfg.frontend_len else 0,
        q_chunk=16,
        kv_chunk=16,
        param_dtype="float32",
        moment_dtype="float32",
        accum_dtype="float32",
    )

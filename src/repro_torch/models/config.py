"""Unified model configuration for the assigned architecture pool (the
reference's ``repro.models.config``, copied: the port imports nothing of it).

One ModelConfig describes every family: dense GQA transformers, MoE,
Mamba-2 (SSD), hybrid interleaves, and modality-frontend backbones.  Layers
are grouped into *super-blocks* (the repeating ``pattern``) so heterogeneous
stacks (Jamba's 1-attn:7-mamba, MoE-every-2) scan cleanly with stacked
parameters: n_layers == len(pattern) * n_super.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One layer inside the repeating super-block pattern."""

    mixer: str = "attn"      # "attn" | "mamba"
    ffn: str = "dense"       # "dense" | "moe" | "none"


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads
    pattern: Tuple[BlockSpec, ...] = (BlockSpec(),)

    # attention features
    qk_norm: bool = False
    rope_theta: float = 1e4

    # FFN
    act: str = "swiglu"          # "swiglu" | "squared_relu"

    # MoE
    n_experts: int = 0
    top_k: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    moe_impl: str = "gather"     # "gather" (pjit scatter/gather baseline) |
    #   "a2a" (shard_map all-to-all dispatch, §Perf optimized path)

    # SSM (Mamba-2 / SSD)
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_head_dim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 256

    # modality frontend stub: extra precomputed embeddings prepended
    frontend: str | None = None   # None | "vit" | "audio"
    frontend_len: int = 0         # patches/frames provided by input_specs()

    # numerics / memory
    param_dtype: str = "float32"
    moment_dtype: str = "float32"
    accum_dtype: str = "float32"
    remat: str = "full"           # "full" | "dots" | "none"
    seq_shard_carry: bool = False  # Megatron-style sequence parallelism for
    #   the residual stream between blocks: the layer-scan carry (saved for
    #   backward) is sharded over `model` along the sequence axis.  Required
    #   to fit >=30B archs at 4k tokens/device; ablated in §Perf.
    scan_levels: int = 1          # 2 = sqrt-remat: two-level layer scan
    #   saving only ~2*sqrt(n_super) residual carries for backward instead
    #   of n_super (§Perf, deep-stack memory lever).

    # attention chunking (flash-style scan)
    q_chunk: int = 1024
    kv_chunk: int = 1024
    causal_skip: bool = False    # §Perf: skip fully-masked causal tiles via
    #   a static lower-triangle (q,kv)-pair scan — halves attention
    #   compute + score traffic at equal semantics.

    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: n_layers {self.n_layers} not divisible by "
            f"pattern length {len(self.pattern)}"
        )
        if self.head_dim == 0:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)
        assert self.n_heads % max(self.n_kv_heads, 1) == 0

    @property
    def n_super(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def d_inner(self) -> int:
        return self.ssm_expand * self.d_model

    @property
    def ssm_heads(self) -> int:
        return self.d_inner // self.ssm_head_dim

    @property
    def attention_free(self) -> bool:
        return all(b.mixer != "attn" for b in self.pattern)

    @property
    def sub_quadratic(self) -> bool:
        """Serves 500k-token contexts without O(L^2) prefill state blowup:
        SSM/hybrid families (constant or dominated-by-SSM state)."""
        return any(b.mixer == "mamba" for b in self.pattern)

    def param_count(self) -> int:
        """Total parameters (exact, matches init_params)."""
        from . import model  # local import to avoid cycle

        return model.count_params(self)

    def active_param_count(self) -> int:
        from . import model

        return model.count_params(self, active_only=True)


def dense_pattern() -> Tuple[BlockSpec, ...]:
    return (BlockSpec(mixer="attn", ffn="dense"),)


def moe_pattern(every: int = 1) -> Tuple[BlockSpec, ...]:
    """MoE every `every` layers (dense otherwise)."""
    if every == 1:
        return (BlockSpec(mixer="attn", ffn="moe"),)
    return tuple(
        BlockSpec(mixer="attn", ffn="moe" if (i % every == every - 1) else "dense")
        for i in range(every)
    )


def mamba_pattern() -> Tuple[BlockSpec, ...]:
    return (BlockSpec(mixer="mamba", ffn="none"),)


def jamba_pattern() -> Tuple[BlockSpec, ...]:
    """Jamba super-block: 8 layers, attention at index 4 (1:7 ratio), MoE on
    every other layer (odd indices) — arXiv:2403.19887."""
    return tuple(
        BlockSpec(
            mixer="attn" if i == 4 else "mamba",
            ffn="moe" if i % 2 == 1 else "dense",
        )
        for i in range(8)
    )

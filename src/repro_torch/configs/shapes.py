"""Assigned input-shape set (the 4 LM-transformer shape cells per arch).

train_*   lower ``train_step``; decode_* / long_* lower ``serve_step``
(one new token against a seq_len KV cache); prefill_* lowers the batched
prompt-ingestion step.  ``long_500k`` requires sub-quadratic sequence
handling and is SKIPped for pure full-attention archs (DESIGN.md
§Arch-applicability) — the skip is recorded, not silently dropped.
"""
from __future__ import annotations

import dataclasses

from ..models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    name: str
    kind: str          # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = (
    ShapeCell("train_4k", "train", 4_096, 256),
    ShapeCell("prefill_32k", "prefill", 32_768, 32),
    ShapeCell("decode_32k", "decode", 32_768, 128),
    ShapeCell("long_500k", "decode", 524_288, 1),
)

SHAPES_BY_NAME = {s.name: s for s in SHAPES}


def applicable(cfg: ModelConfig, cell: ShapeCell) -> tuple[bool, str]:
    """(runs?, reason).  long_500k only for SSM/hybrid (sub-quadratic)."""
    if cell.name == "long_500k" and not cfg.sub_quadratic:
        return False, (
            "SKIP: pure full-attention arch at 500k decode (O(L) KV per token "
            "with quadratic-prefill family; spec directs skip; see DESIGN.md)"
        )
    return True, ""


def microbatches_for(cfg: ModelConfig, cell: ShapeCell, n_data_shards: int) -> int:
    """Gradient-accumulation split for train cells: keep per-device live
    activation footprint bounded.  Tuned per size class (see §Perf)."""
    if cell.kind != "train":
        return 1
    per_shard = cell.global_batch // n_data_shards
    # target <= 1 sequence per device per microbatch for >=30B, <= 4 for small
    big = cfg.d_model >= 7000 or cfg.n_layers >= 60
    target = 1 if big else 4
    return max(1, per_shard // target)

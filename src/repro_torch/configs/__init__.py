"""Named configurations: the DWDM systems (``wdm``), the fabrics (``fabric``)
and the LM architectures (``archs``, with the input-shape cells of
``shapes``), with their registries at package level as in the reference:
``--arch <id>`` resolution for launchers and tests.
"""
from __future__ import annotations

from ..models.config import ModelConfig

from . import archs
from .archs import ALL, smoke_variant  # noqa: F401
from .shapes import SHAPES, SHAPES_BY_NAME, ShapeCell, applicable, microbatches_for  # noqa: F401
from .fabric import FABRIC_CONFIGS  # noqa: F401
from .wdm import WDM_CONFIGS  # noqa: F401

REGISTRY = {cfg.name: cfg for cfg in ALL}
ARCH_IDS = tuple(REGISTRY)


def get_config(arch_id: str) -> ModelConfig:
    try:
        return REGISTRY[arch_id]
    except KeyError:
        raise KeyError(f"unknown arch {arch_id!r}; known: {sorted(REGISTRY)}") from None


def get_smoke(arch_id: str) -> ModelConfig:
    return smoke_variant(get_config(arch_id))

"""Named configurations: the DWDM systems (``wdm``) and the fabrics
(``fabric``), with their registries at package level as in the reference.

The reference's LM registry (``ALL``, ``REGISTRY``, ``ARCH_IDS``,
``get_config``, ``get_smoke``, ``SHAPES``, ...) belongs to its LM-era
scaffolding and is not ported with it yet.
"""
from .fabric import FABRIC_CONFIGS  # noqa: F401
from .wdm import WDM_CONFIGS  # noqa: F401

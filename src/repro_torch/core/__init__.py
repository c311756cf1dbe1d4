"""Core wavelength-arbitration library: the paper's main path and the sweep
engine over it.

The sweep engine's names are exported here, as the reference exports them
from ``repro.core``; the other modules are imported by name
(``repro_torch.core.api``, ``repro_torch.core.temporal``, ...).
"""
from .sweep import (  # noqa: F401
    SweepRequest,
    SweepResult,
    sweep,
    sweep_grid,
    sweep_grid_reference,
    sweep_min_tr,
    sweep_policy,
    sweep_reference,
    sweep_scheme,
)

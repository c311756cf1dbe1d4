"""PyTorch port of the wavelength-arbitration simulator (``repro``).

The modules mirror ``repro``'s layout and names.  Tensors follow the
reference layouts: core data is (T, N) or (T, N, E) with trials first.
Entry points run on CUDA unless the caller asks for ``device="cpu"``; the
hand-written CUDA kernels (``kernels.feasibility``, ``kernels.table_build``,
the ``match`` and ``bottleneck`` kernels of ``kernels.bitmask_match`` and the
``probe`` kernel of ``kernels.probe``) launch for CUDA tensors, and their
plain PyTorch versions run for CPU tensors.  The protocol engine
(``core.protocol``) carries the ``protocol_*`` schemes and temporal
re-arbitration (``core.temporal.run_timeline``); ``fabric`` composes
per-link arbitration into fabrics of links, with chaos timelines of faults;
``obs`` instruments them (flight recorder, health matrix, phase telemetry,
failure taxonomy, run manifests), off by default.
"""

# The core package first: its sweep exports import the kernel wrappers, and
# the wrappers import core helpers, so core must start initializing first.
from . import core  # noqa: E402,F401
# The fabric layer after core: it reads the sweep engine and the temporal
# engine, and registers the ``comb_coupling`` axis.
from .fabric import (  # noqa: E402,F401
    FabricChaosStats,
    FabricResult,
    FabricSpec,
    FabricStats,
    FabricTimeline,
    FabricUnits,
    LinkEval,
    aggregate_stats,
    auto_link_chunk,
    bringup,
    fabric_stats_impl,
    instantiate_links,
    link_record,
    make_fabric_timeline,
    make_fabric_units,
    run_fabric_timeline,
    run_fabric_timeline_impl,
    state_from_assignment,
    summarize_chaos,
)

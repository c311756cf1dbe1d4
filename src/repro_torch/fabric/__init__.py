"""Fabric-scale arbitration: per-link schemes + network-level constraints.

See ``spec`` (topology, routes + fallbacks), ``sampling`` (per-link draws,
comb coupling), ``bringup`` (link-chunked bring-up, ``FabricStats``) and
``chaos`` (fault-injection timelines + warm re-lock across the fabric).
Sweep whole fabrics over variation grids with ``SweepRequest(fabric=...)``;
compose drift/fault timelines with ``SweepRequest(fabric=..., timeline=...)``.

The reference's per-link ``instantiate_link`` is here too; the engines use
``instantiate_links``: every link at once, as one flat batch of 2 trials a
link.
"""
from .bringup import (
    FabricResult,
    FabricStats,
    LinkEval,
    aggregate_stats,
    auto_link_chunk,
    bringup,
    fabric_stats_impl,
    link_record,
    state_from_assignment,
)
from .chaos import (
    FabricChaosStats,
    FabricTimeline,
    make_fabric_timeline,
    run_fabric_timeline,
    run_fabric_timeline_impl,
    summarize_chaos,
)
from .sampling import FabricUnits, instantiate_link, instantiate_links, make_fabric_units
from .spec import FabricSpec

__all__ = [
    "FabricChaosStats",
    "FabricResult",
    "FabricSpec",
    "FabricStats",
    "FabricTimeline",
    "FabricUnits",
    "LinkEval",
    "aggregate_stats",
    "auto_link_chunk",
    "bringup",
    "fabric_stats_impl",
    "instantiate_link",
    "instantiate_links",
    "link_record",
    "make_fabric_timeline",
    "make_fabric_units",
    "run_fabric_timeline",
    "run_fabric_timeline_impl",
    "state_from_assignment",
    "summarize_chaos",
]

"""Carry the reference package's inputs across as plain numbers.

The parity tests can hand the reference's unit samples (the port also draws
them itself: ``core.prng``), search tables, protocol states, flight-recorder
buffers, timelines, fabric units, fabric timelines and the interconnect's
live fabric states to both packages as the same numpy arrays, so that
arbiters, warm starts, traces, timelines and warm repairs are compared on
identical inputs.
"""
from __future__ import annotations

from typing import Mapping, Sequence

import numpy as np
import torch

from .core.grid import ArbitrationConfig, DWDMGrid, VariationModel
from .core.protocol import ProtocolState
from .core.sampling import SystemBatch, UnitSamples, resolve_device
from .core.search_table import SearchTables
from .core.temporal import Timeline
from .fabric.chaos import FabricTimeline
from .fabric.sampling import FabricUnits
from .fabric.spec import FabricSpec
from .obs.trace import TraceBuffer
from .optics.interconnect import FabricHandle, FabricState, LinkHealth


def units_from_numpy(u_go, u_llv, u_rlv, u_fsr, u_tr, device=None) -> UnitSamples:
    """``UnitSamples`` from the reference's fields as numpy arrays (float32)."""
    dev = resolve_device(device)
    return UnitSamples(*(
        torch.tensor(np.asarray(a, dtype=np.float32)).to(dev)
        for a in (u_go, u_llv, u_rlv, u_fsr, u_tr)
    ))


def config_from_fields(grid: Mapping, var: Mapping, r_order: Sequence[int],
                       s_order: Sequence[int], max_fsr_alias: int = 8
                       ) -> ArbitrationConfig:
    """Rebuild an ``ArbitrationConfig`` from the plain fields of the
    reference's config (``dataclasses.asdict(cfg)`` gives exactly these)."""
    return ArbitrationConfig(
        grid=DWDMGrid(**dict(grid)),
        var=VariationModel(**dict(var)),
        r_order=tuple(int(v) for v in r_order),
        s_order=tuple(int(v) for v in s_order),
        max_fsr_alias=int(max_fsr_alias),
    )


def tables_from_numpy(delta, wl, n_valid, device=None) -> SearchTables:
    """``SearchTables`` from the reference's (delta, wl, n_valid) arrays, so
    both packages' arbiters can read the same tables."""
    dev = resolve_device(device)
    return SearchTables(
        delta=torch.tensor(np.asarray(delta, dtype=np.float32)).to(dev),
        wl=torch.tensor(np.asarray(wl, dtype=np.int32)).to(dev),
        n_valid=torch.tensor(np.asarray(n_valid, dtype=np.int32)).to(dev),
    )


def state_from_numpy(lock, entry, cursor, probes, device=None) -> ProtocolState:
    """``ProtocolState`` from the reference's (lock, entry, cursor, probes)
    arrays (int32), so both engines can resume the same warm state."""
    dev = resolve_device(device)
    return ProtocolState(*(
        torch.tensor(np.asarray(a, dtype=np.int32)).to(dev)
        for a in (lock, entry, cursor, probes)
    ))


def trace_from_numpy(ev, n, counts, device=None) -> TraceBuffer:
    """``TraceBuffer`` from the reference's (ev, n, counts) arrays (int32)."""
    dev = resolve_device(device)
    return TraceBuffer(*(
        torch.tensor(np.asarray(a, dtype=np.int32)).to(dev) for a in (ev, n, counts)
    ))


def timeline_from_numpy(ring_drift, laser_drift, lane_alive, ring_alive,
                        device=None) -> Timeline:
    """``Timeline`` from the reference's (S, N) fields: drifts as float32,
    liveness as bool."""
    dev = resolve_device(device)
    return Timeline(
        ring_drift=torch.tensor(np.asarray(ring_drift, dtype=np.float32)).to(dev),
        laser_drift=torch.tensor(np.asarray(laser_drift, dtype=np.float32)).to(dev),
        lane_alive=torch.tensor(np.asarray(lane_alive, dtype=bool)).to(dev),
        ring_alive=torch.tensor(np.asarray(ring_alive, dtype=bool)).to(dev),
    )


def fabric_units_from_numpy(go, llv, g_go, g_llv, rlv, fsr, tr, device=None) -> FabricUnits:
    """``FabricUnits`` from the reference's fields as numpy arrays (float32)."""
    dev = resolve_device(device)
    return FabricUnits(*(
        torch.tensor(np.asarray(a, dtype=np.float32)).to(dev)
        for a in (go, llv, g_go, g_llv, rlv, fsr, tr)
    ))


def fabric_timeline_from_numpy(ring_drift, laser_drift, lane_alive, ring_alive, link_alive,
                               disturbed, device=None) -> FabricTimeline:
    """``FabricTimeline`` from the reference's fields: drifts as float32,
    liveness and disturbance as bool."""
    dev = resolve_device(device)
    f32 = lambda a: torch.tensor(np.asarray(a, dtype=np.float32)).to(dev)  # noqa: E731
    flag = lambda a: torch.tensor(np.asarray(a, dtype=bool)).to(dev)  # noqa: E731
    return FabricTimeline(
        ring_drift=f32(ring_drift), laser_drift=f32(laser_drift),
        lane_alive=flag(lane_alive), ring_alive=flag(ring_alive),
        link_alive=flag(link_alive), disturbed=flag(disturbed),
    )


def fabric_state_from_fields(links: Sequence[Mapping], scheme: str, tr_mean: float,
                             spec: Mapping, system: Sequence, state: Sequence,
                             link_alive=None, device=None) -> FabricState:
    """The interconnect's ``FabricState`` from the reference's as plain
    fields: each link's ``LinkHealth`` fields (``dataclasses.asdict``), the
    scheme, ``tr_mean``, the handle's ``FabricSpec`` fields, its system's
    (laser, ring, fsr, tr_unit) float32 arrays, its state's (lock, entry,
    cursor, probes) int32 arrays and its ``link_alive`` (None = all up)."""
    dev = resolve_device(device)
    handle = FabricHandle(
        spec=FabricSpec(**dict(spec)),
        system=SystemBatch(*(torch.tensor(np.asarray(a, dtype=np.float32)).to(dev)
                             for a in system)),
        state=state_from_numpy(*state, device=dev),
        tr_mean=tr_mean,
        link_alive=None if link_alive is None else np.array(link_alive, dtype=bool),
    )
    return FabricState(links=[LinkHealth(**dict(l)) for l in links], scheme=scheme,
                       tr_mean=tr_mean, handle=handle)

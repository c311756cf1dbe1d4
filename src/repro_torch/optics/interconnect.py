"""Optical interconnect runtime: wavelength arbitration as the
link-initialization feature of a multi-pod fabric.

Every inter-pod edge of the fabric is a bundle of microring DWDM
transceivers.  This module is a thin runtime wrapper over the fabric layer
(``repro_torch.fabric``): ``bringup`` arbitrates every link in one fabric
bring-up (per-link draws independent, ``comb_group="link"``), and the
outcomes become ``LinkHealth`` records:

  * usable lanes  (zero/dup-locked channels are dead lanes)
  * spectral ordering + the barrel-shift remap cost (LtC) feeding the
    port-remapper config
  * effective per-link bandwidth

Failures do not kill the fabric: ``rearbitrate`` *warm-restarts* the
protocol engine from the live lock state carried in the bring-up handle
(``run_protocol(init_state=revalidate_state(...), transactional=True)``):
surviving locks are kept, starved rings re-seek, and a transactional round
can only improve a link.  ``inject_link_failure`` marks links dead; warm
repair masks their lines out of the rebuilt tables, so they never re-lock.

The records stay on the host as the reference has them (``LinkHealth``
fields are Python ints and strings, ``FabricHandle.link_alive`` a numpy
bool array or None); the handle's ``system`` and ``state`` stay tensors on
the device of the bring-up, which selects the kernels' path.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.api import evaluate_scheme, make_units, scheme_spec
from ..core.grid import ArbitrationConfig
from ..core.protocol import ProtocolState, revalidate_state, run_protocol
from ..core.relation import chain_spec
from ..core.sampling import SystemBatch
from ..core.search_table import build_search_tables
from ..fabric import FabricSpec
from ..fabric import bringup as fabric_bringup
from ..fabric.bringup import link_record

LINK_GBPS_PER_LANE = 6.25  # 50 Gb/s/lane optical -> 6.25 GB/s

#: ``_link_summaries``' failure codes, in the reference's precedence.
_FAILURES = (None, "zero_lock", "dup_lock", "order_err")


@dataclasses.dataclass
class LinkHealth:
    src_pod: int
    dst_pod: int
    transceiver: int
    lanes_total: int
    lanes_up: int
    spectral_shift: int          # LtC barrel shift c (remap cost metric)
    failure: Optional[str]       # None | zero_lock | dup_lock | order_err | link_down

    @property
    def bandwidth_gbps(self) -> float:
        return self.lanes_up * LINK_GBPS_PER_LANE

    @property
    def degraded(self) -> bool:
        return self.lanes_up < self.lanes_total


@dataclasses.dataclass
class FabricHandle:
    """Live physical state carried from bring-up for warm re-arbitration.

    ``system`` holds the instantiated optics (row 2k = link k's tx end,
    2k+1 rx) and ``state`` the dup-sanitized endpoint lock state: enough
    to rebuild search tables and resume the protocol engine without
    re-drawing thermals (re-arbitration happens on the SAME hardware).
    ``link_alive`` (None = all up) marks links whose fiber/port is dead
    (``inject_link_failure``): warm repair masks them out of the rebuilt
    tables, so their locks break and are never re-locked.
    """

    spec: FabricSpec
    system: SystemBatch
    state: ProtocolState
    tr_mean: float
    link_alive: Optional[np.ndarray] = None


@dataclasses.dataclass
class FabricState:
    links: List[LinkHealth]
    scheme: str
    tr_mean: float
    handle: Optional[FabricHandle] = None

    @property
    def min_link_bandwidth(self) -> float:
        return min(l.bandwidth_gbps for l in self.links) if self.links else 0.0

    @property
    def bandwidth_fraction(self) -> float:
        """Worst-link usable-lane fraction: scales the collective term for
        cross-pod traffic."""
        if not self.links:
            return 1.0
        return min(l.lanes_up / l.lanes_total for l in self.links)

    def degraded_links(self) -> List[LinkHealth]:
        return [l for l in self.links if l.degraded]


def _link_summaries(cfg: ArbitrationConfig, wl: torch.Tensor, policy: str) -> tuple:
    """(K, 2, N) locked lines -> per-link (ok, lanes, shift, failure) on the
    host: numpy arrays and a list of failure names.

    The fabric layer's lane accounting (``fabric.bringup.link_record``, on
    the device): a lane carries data when its ring locked a unique line
    (every dup costs one extra lane), an order error is a crossbar remap
    with no lane loss, and a link is up only when BOTH ends succeed under
    the scheme's policy.  The shift is the rx end's.
    """
    k, _, n = wl.shape
    flat = wl.reshape(2 * k, n).to(torch.int32)
    ev = link_record(cfg, policy, flat, torch.zeros_like(flat),
                     torch.zeros((2 * k,), dtype=torch.bool, device=flat.device))
    code = torch.where(ev.alg, 0, torch.where(
        ev.zero.any(dim=1), 1, torch.where(
            ev.dup.any(dim=1), 2, torch.where(ev.order.any(dim=1), 3, 0))))
    host = torch.stack([ev.alg.to(torch.int32), ev.lanes, ev.shift[:, 1],
                        code.to(torch.int32)]).cpu().numpy()
    return (host[0].astype(bool), host[1], host[2],
            [_FAILURES[c] for c in host[3].tolist()])


def bringup(
    pods: int,
    links_per_pod_pair: int,
    cfg: ArbitrationConfig,
    *,
    tr_mean: float = 8.96,
    scheme: str = "vtrs_ssm",
    seed: int = 0,
    device=None,
) -> FabricState:
    """Arbitrate every inter-pod transceiver; returns fabric health.

    One fabric-layer bring-up on ``device`` (CUDA unless named); per-link
    comb and ring draws are independent (``comb_group="link"``: the runtime
    models per-link comb sources; couple them via ``repro_torch.fabric``
    directly).  The returned state carries a ``FabricHandle`` so
    ``rearbitrate`` can warm-restart the protocol engine on the same
    physical draws.
    """
    spec = FabricSpec(pods=pods, links_per_pair=links_per_pod_pair, comb_group="link")
    res = fabric_bringup(cfg, spec, tr_mean=tr_mean, scheme=scheme, seed=seed,
                         device=device)
    n = cfg.grid.n_ch
    _, lanes, shift, failure = _link_summaries(cfg, res.ev.wl, scheme_spec(scheme).policy)
    src, dst = spec.link_pods()
    tix = spec.link_in_pair()
    links = [
        LinkHealth(
            src_pod=int(src[k]), dst_pod=int(dst[k]), transceiver=int(tix[k]),
            lanes_total=n, lanes_up=int(lanes[k]),
            spectral_shift=int(shift[k]), failure=failure[k],
        )
        for k in range(spec.n_links)
    ]
    handle = FabricHandle(spec=spec, system=res.system, state=res.state, tr_mean=tr_mean)
    return FabricState(links=links, scheme=scheme, tr_mean=tr_mean, handle=handle)


def _warm_repair(cfg: ArbitrationConfig, system: SystemBatch, tr_mean,
                 state: ProtocolState, visible=None):
    """One warm protocol pass on the live fabric state; returns
    ``(assign, state)``.

    Tables are rebuilt from the stored optics (drift-free here; the
    temporal layer owns drifting tables), carried locks are revalidated
    and re-anchored, and a transactional protocol run repairs starved
    rings, committing per trial only if it strictly improves the lock
    count, so link health is monotone under repair.  ``visible`` ((2K, N)
    bool, None = all) masks dead links' lines out of the rebuilt tables:
    their locks break at revalidation and an empty table never re-locks.
    ``tr_mean`` meets the tables as float32, as the reference's traced
    scalar does.
    """
    tables = build_search_tables(system, tr_mean, visible=visible,
                                 max_alias=cfg.max_fsr_alias)
    st, _ = revalidate_state(tables, state)
    return run_protocol(
        tables, chain_spec(cfg.s),
        init_state=st, with_state=True, transactional=True, patience=4,
    )


def inject_link_failure(state: FabricState, links) -> FabricState:
    """Mark links as hard-down (fiber cut / port death) in a handle-carrying
    fabric state.

    The returned state records zero lanes and ``failure="link_down"`` for
    each killed link, and the handle's ``link_alive`` mask makes every
    subsequent ``rearbitrate`` treat their buses as empty: killed links
    are never re-locked, and surviving links repair exactly as before.
    Idempotent; a fresh ``bringup`` clears it.
    """
    if state.handle is None:
        raise ValueError("inject_link_failure needs a handle-carrying state "
                         "(bringup output), not a legacy record-only state")
    ids = [int(i) for i in np.atleast_1d(np.asarray(links, np.int64))]
    n_links = len(state.links)
    for i in ids:
        if not 0 <= i < n_links:
            raise ValueError(f"link {i} outside 0..{n_links - 1}")
    alive = (np.ones(n_links, bool) if state.handle.link_alive is None
             else state.handle.link_alive.copy())
    alive[ids] = False
    new_links = list(state.links)
    for i in ids:
        new_links[i] = dataclasses.replace(new_links[i], lanes_up=0, failure="link_down")
    handle = dataclasses.replace(state.handle, link_alive=alive)
    return FabricState(links=new_links, scheme=state.scheme, tr_mean=state.tr_mean,
                       handle=handle)


def rearbitrate(state: FabricState, cfg: ArbitrationConfig, *, seed: int = 0,
                max_rounds: int = 3, device=None) -> Tuple[FabricState, int]:
    """Warm re-arbitration of degraded links from live lock state.

    Runs the protocol engine with ``init_state=`` the handle's carried
    locks (revalidated against rebuilt tables) instead of a cold re-draw:
    healthy lanes keep their locks (no spectral churn), starved rings
    re-seek with multi-hop augmenting, and transactional commits make
    every round monotone.  Degraded ``LinkHealth`` records are re-derived
    from the post-repair state; rounds stop early once a pass changes
    nothing (the warm repair is deterministic).  Returns
    ``(new_state, rounds_used)``.

    The warm path runs on the handle's device and does not use ``seed``;
    only a handle-less state does (``_cold_rearbitrate``: a cold re-draw of
    the degraded links on ``device``, CUDA unless named).
    """
    if state.handle is None:
        return _cold_rearbitrate(state, cfg, seed=seed, max_rounds=max_rounds,
                                 device=device)

    handle = state.handle
    links = list(state.links)
    n = cfg.grid.n_ch
    policy = scheme_spec(state.scheme).policy
    proto = handle.state
    rounds = 0
    alive = handle.link_alive
    visible = None
    if alive is not None and not alive.all():
        rows = torch.from_numpy(np.repeat(alive, 2)).to(handle.system.laser.device)
        visible = rows[:, None].expand(-1, n).contiguous()
    dead = set() if alive is None else {int(i) for i in np.flatnonzero(~alive)}
    for _ in range(max_rounds):
        degraded = [i for i, l in enumerate(links) if l.degraded and i not in dead]
        if not degraded:
            break
        rounds += 1
        _, proto = _warm_repair(cfg, handle.system, handle.tr_mean, proto, visible)
        _, lanes, shift, failure = _link_summaries(cfg, proto.lock.reshape(-1, 2, n), policy)
        changed = False
        for i in degraded:
            l = links[i]
            new_lanes = max(int(lanes[i]), l.lanes_up)  # monotone guard
            new_fail = failure[i] if new_lanes < l.lanes_total else None
            if (new_lanes, new_fail, int(shift[i])) != (l.lanes_up, l.failure,
                                                         l.spectral_shift):
                links[i] = dataclasses.replace(
                    l, lanes_up=new_lanes, spectral_shift=int(shift[i]), failure=new_fail)
                changed = True
        if not changed:
            break
    new_handle = dataclasses.replace(handle, state=proto)
    return (
        FabricState(links=links, scheme=state.scheme, tr_mean=state.tr_mean,
                    handle=new_handle),
        rounds,
    )


def _cold_rearbitrate(state: FabricState, cfg: ArbitrationConfig, *, seed: int,
                      max_rounds: int, device=None) -> Tuple[FabricState, int]:
    """Legacy path for handle-less states: fresh independent draws for the
    degraded links (a 2-pod fabric bring-up of exactly the degraded count
    at ``seed + 31 r`` in round r, on ``device``), committing successes
    only."""
    rounds = 0
    links = list(state.links)
    policy = scheme_spec(state.scheme).policy
    for r in range(max_rounds):
        degraded = [i for i, l in enumerate(links) if l.degraded]
        if not degraded:
            break
        rounds += 1
        spec = FabricSpec(pods=2, links_per_pair=len(degraded), comb_group="link")
        res = fabric_bringup(cfg, spec, tr_mean=state.tr_mean, scheme=state.scheme,
                             seed=seed + 31 * r, device=device)
        ok, _, shift, _ = _link_summaries(cfg, res.ev.wl, policy)
        for j, i in enumerate(degraded):
            if ok[j]:
                l = links[i]
                links[i] = dataclasses.replace(
                    l, lanes_up=l.lanes_total, spectral_shift=int(shift[j]), failure=None)
    return FabricState(links=links, scheme=state.scheme, tr_mean=state.tr_mean), rounds


def expected_failure_rates(cfg: ArbitrationConfig, tr_mean: float,
                           scheme: str = "vtrs_ssm", seed: int = 0,
                           n: int = 64, device=None) -> Dict[str, float]:
    """Fleet-planning numbers: AFP (policy yield) and CAFP (algorithmic) at
    the deployed operating point, on n x n trials on ``device`` (CUDA
    unless named)."""
    units = make_units(cfg, seed=seed, n_laser=n, n_ring=n, device=device)
    r = evaluate_scheme(cfg, units, scheme, tr_mean)
    return {
        "afp": float(r.afp),
        "cafp": float(r.cafp),
        "total_failure": float(r.afp + r.cafp),
    }

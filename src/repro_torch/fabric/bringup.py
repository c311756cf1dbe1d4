"""Fabric bring-up: per-link arbitration composed with network constraints.

Every link is two N-ring transceivers sharing one comb's light: bring-up
runs the chosen arbitration scheme on both endpoints, then composes the
per-link outcomes with the network-level wavelength-assignment constraints
of the RWA-style related work (PAPERS.md):

  * **endpoint-matched spectral orderings**: a link is *up* only when both
    ends arbitrate successfully; among up links, ends whose lane -> line
    maps are LtC-clean either already agree on the barrel shift
    (``matched``) or need a one-time electrical remap at one end
    (``reconciled``);
  * **shared-comb coupling**: links in one comb group draw correlated
    laser variations (``comb_coupling`` axis; ``fabric.sampling``), so a
    bad comb draw degrades a whole bundle together;
  * **per-route wavelength continuity**: a route (pod sequence) is *up*
    when every hop's bundle has a fully-arbitrated link, and *continuous*
    when one wavelength channel is captured at both ends of a usable link
    on every hop (the Multi-Path-RWA continuity constraint, any-link-per-
    bundle form).

The reference's ``vmap`` over links is a flat batch here: a chunk of links
is one batch of 2 trials a link (row 2k = link k's tx end, 2k + 1 its rx
end), run through the kernels at once; every per-trial path is
batch-independent, so the batch is exact per link.  ``chunked_map`` bounds
the link axis by the sweep engine's memory budget.

``fabric_stats_impl`` is the sweep engine's body for
``SweepRequest(fabric=...)``; ``bringup`` is the standalone entry that also
returns per-link records and the live endpoint lock state for warm
re-arbitration.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from ..core import ideal
from ..core.api import oblivious_arbitrate, scheme_spec
from ..core.grid import ArbitrationConfig
from ..core.outcomes import classify
from ..core.protocol import ProtocolState
from ..core.sampling import SystemBatch, per_trial
from ..core.ssm import Assignment
from ..core.sweep import _CHUNK_BUDGET, chunked_map, scheme_point_bytes
from ..core.variations import Variations, as_variations, is_per_point
from ..launch.mesh import check_mesh
from ..obs.phase import current_recorder, measured_call
from .sampling import FabricUnits, instantiate_links, make_fabric_units
from .spec import FabricSpec


class LinkEval(NamedTuple):
    """Per-link bring-up records, stacked over K links.  (The reference's
    ``system`` field is ``FabricResult.system`` here: the flat batch.)"""

    alg: torch.Tensor      # (K,)       bool: both ends arbitrated successfully
    ideal: torch.Tensor    # (K,)       bool: ideal policy succeeds at both ends
    lanes: torch.Tensor    # (K,)       int32 usable lanes (N when ``alg``)
    zero: torch.Tensor     # (K, 2)     bool per-end zero-lock
    dup: torch.Tensor      # (K, 2)     bool per-end dup-lock
    order: torch.Tensor    # (K, 2)     bool per-end order error (scheme policy)
    ltc_ok: torch.Tensor   # (K, 2)     bool per-end LtC-clean (uniform barrel shift)
    shift: torch.Tensor    # (K, 2)     int32 per-end barrel shift (ring 0's line)
    ch_up: torch.Tensor    # (K, N)     bool: channel captured at BOTH ends
    wl: torch.Tensor       # (K, 2, N)  int32 per-end locked line ids (-1 starved)
    entry: torch.Tensor    # (K, 2, N)  int32 per-end locked table entries


class FabricStats(NamedTuple):
    """Fabric-level yield metrics (scalars; grids under the sweep engine).

    Route metrics are 1.0 when the spec declares no routes (vacuously
    satisfied constraints).  ``route_up``/``route_cont`` score the primary
    routes only; the ``*_served`` / ``route_bandwidth`` degraded-mode
    metrics score each route by its best alternative (primary or declared
    fallback), so a comb/link failure reports a bandwidth floor instead of
    a binary fabric death.
    """

    link_up: torch.Tensor     # fraction of links with both ends arbitrated
    afp: torch.Tensor         # fabric AFP: P(ideal fails on either end)
    cafp: torch.Tensor        # P(link fails & ideal fine on both ends) (Eq. 6)
    matched: torch.Tensor     # up links whose ends agree on the barrel shift
    reconciled: torch.Tensor  # up links needing a one-time shift reconciliation
    bandwidth: torch.Tensor   # mean usable-lane fraction over links
    route_up: torch.Tensor    # routes with >= 1 fully-up link on every hop
    route_cont: torch.Tensor  # routes with a continuity wavelength on every hop
    route_served: torch.Tensor       # routes with ANY alternative fully up
    route_cont_served: torch.Tensor  # ... with a continuity wavelength on any alt
    route_bandwidth: torch.Tensor    # mean over routes of best-alt bottleneck
                                     # usable-lane fraction (max link per hop)


def link_record(
    cfg: ArbitrationConfig,
    policy: str,
    wl: torch.Tensor,
    entry: torch.Tensor,
    ideal_ok: torch.Tensor,
) -> LinkEval:
    """Classify (2K, N) locked-line maps (rows 2k and 2k + 1 are link k's
    ends) into ``LinkEval`` records stacked over the K links.

    Shared by one-shot bring-up and the chaos timeline (``fabric.chaos``),
    which re-derives records from the live protocol state each step: the
    same lane accounting, bit for bit.
    """
    n = cfg.grid.n_ch
    t = wl.shape[0]
    k = t // 2
    dev = wl.device
    s = torch.as_tensor(cfg.s, dtype=torch.int32, device=dev)
    asg = Assignment(entry=entry, wl=wl, delta=torch.zeros(wl.shape, device=dev))
    out = classify(asg, cfg.s, policy=policy)
    # LtC-cleanliness is reported for every scheme (LtA fabrics still need
    # it for the spectral-ordering metrics); for ltc-policy schemes it
    # coincides with ``out.success``.
    ltc = classify(asg, cfg.s, policy="ltc")
    # A floor mod, as the reference's ``%``: a starved ring 0 (wl = -1)
    # gives (-1 - s0) mod N.
    shift = torch.remainder(wl[:, 0] - s[0], n)

    held = wl >= 0
    counts = torch.zeros((t, n + 1), dtype=torch.int32, device=dev)
    counts.scatter_add_(1, torch.where(held, wl, n).long(), torch.ones_like(wl, dtype=torch.int32))
    counts = counts[:, :n]                                        # (2K, N) locks per line
    distinct = (counts > 0).sum(dim=1, dtype=torch.int32)
    locked = held.sum(dim=1, dtype=torch.int32)
    # A lane carries data when its ring locked a *unique* line: every dup
    # costs one extra lane beyond the distinct count; an order error is a
    # crossbar remap, no lane loss.
    end_lanes = (2 * distinct - locked).clamp(0, n).view(k, 2)

    pair = lambda x: x.view(k, 2)  # noqa: E731
    success = pair(out.success)
    link_alg = success[:, 0] & success[:, 1]
    ok = pair(ideal_ok)
    lanes = torch.where(link_alg, n, torch.minimum(end_lanes[:, 0], end_lanes[:, 1]))
    ends = counts.view(k, 2, n) > 0
    return LinkEval(
        alg=link_alg,
        ideal=ok[:, 0] & ok[:, 1],
        lanes=lanes.to(torch.int32),
        zero=pair(out.zero_lock),
        dup=pair(out.dup_lock),
        order=pair(out.order_err),
        ltc_ok=pair(ltc.success),
        shift=pair(shift.to(torch.int32)),
        ch_up=ends[:, 0] & ends[:, 1],
        wl=wl.to(torch.int32).view(k, 2, n),
        entry=entry.to(torch.int32).view(k, 2, n),
    )


def _eval_links(cfg: ArbitrationConfig, spec: FabricSpec, scheme: str,
                variations: Variations, units: FabricUnits) -> LinkEval:
    """Arbitrate both endpoints of every link in ``units`` as one batch of 2
    trials a link, and classify the outcomes."""
    sspec = scheme_spec(scheme)
    sys = instantiate_links(cfg, spec, units, variations)
    tr = per_trial(variations.resolve("tr_mean", cfg), units.n_links, sys.n_trials,
                   sys.laser.device)
    assign = oblivious_arbitrate(cfg, sys, tr, scheme)
    ideal_ok = ideal.success(sys, sspec.policy, cfg.s, tr)
    return link_record(cfg, sspec.policy, assign.wl, assign.entry, ideal_ok)


def _mean(x: torch.Tensor) -> torch.Tensor:
    """float32 mean over the last axis: the sum over it divided by its length
    in float32 (a true division: a CUDA division by a host scalar would
    multiply by its reciprocal)."""
    count = torch.tensor(float(x.shape[-1]), dtype=torch.float32, device=x.device)
    return x.to(torch.float32).sum(dim=-1) / count


def aggregate_stats(cfg: ArbitrationConfig, spec: FabricSpec, ev: LinkEval) -> FabricStats:
    """Reduce stacked per-link records to fabric-level ``FabricStats``.

    ``ev`` holds the K links of the spec on its leading axis, or on the axis
    after any leading batch axes (grid points: (P, K, ...) gives (P,)
    stats)."""
    n = cfg.grid.n_ch
    k = spec.n_links
    lead = ev.alg.shape[:-1]
    b = int(np.prod(lead, dtype=np.int64))
    alg = ev.alg.reshape(b, k)
    ideal_ok = ev.ideal.reshape(b, k)
    lanes = ev.lanes.reshape(b, k)
    ltc_ok = ev.ltc_ok.reshape(b, k, 2)
    shift = ev.shift.reshape(b, k, 2)
    ch_up = ev.ch_up.reshape(b, k, n)
    dev = alg.device
    ltc_both = ltc_ok[..., 0] & ltc_ok[..., 1]
    shift_eq = shift[..., 0] == shift[..., 1]
    # a true float32 division (see ``_mean``), as the reference's lanes / N
    lane_frac = lanes.to(torch.float32) / torch.tensor(float(n), dtype=torch.float32, device=dev)

    if spec.routes:
        link_pair = torch.from_numpy(spec.link_pair()).to(dev)
        pair_up = torch.zeros((b, spec.n_pairs), dtype=torch.int32, device=dev).index_add_(
            1, link_pair, alg.to(torch.int32)) > 0
        usable = lanes > 0
        avail = torch.zeros((b, spec.n_pairs, n), dtype=torch.int32, device=dev).index_add_(
            1, link_pair, (ch_up & usable[..., None]).to(torch.int32)) > 0
        hops = spec.route_hops()                                   # (R, H) host-side
        valid = torch.from_numpy(hops >= 0).to(dev)
        safe = torch.from_numpy(np.clip(hops, 0, None)).to(dev)
        r_up = torch.where(valid, pair_up[:, safe], True).all(dim=2)          # (B, R)
        cont_c = torch.where(valid[:, :, None], avail[:, safe], True).all(dim=2)  # (B, R, N)
        route_up = _mean(r_up)
        route_cont = _mean(cont_c.any(dim=2))

        # Degraded-mode scoring: every route over its alternative set
        # (primary + declared fallbacks), scored by its best survivor.  The
        # primary-only metrics above are untouched, so fabrics without
        # fallbacks report route_served == route_up bit for bit.
        a_hops, a_valid = spec.route_alternatives()               # (R, A, H), (R, A)
        av = torch.from_numpy(a_valid).to(dev)
        vh = torch.from_numpy(a_hops >= 0).to(dev)
        sh = torch.from_numpy(np.clip(a_hops, 0, None)).to(dev)
        pair_bw = torch.zeros((b, spec.n_pairs), dtype=torch.float32, device=dev).scatter_reduce(
            1, link_pair.expand(b, k), lane_frac, "amax", include_self=True)  # best link
        a_up = torch.where(vh, pair_up[:, sh], True).all(dim=3)              # (B, R, A)
        a_cont = torch.where(vh[..., None], avail[:, sh], True).all(dim=3).any(dim=3)
        a_bw = torch.where(vh, pair_bw[:, sh], torch.inf).amin(dim=3)        # hop bottleneck
        route_served = _mean((a_up & av).any(dim=2))
        route_cont_served = _mean((a_cont & av).any(dim=2))
        route_bandwidth = _mean(torch.where(av, a_bw, 0.0).amax(dim=2))
    else:
        one = torch.ones((b,), dtype=torch.float32, device=dev)
        route_up = route_cont = route_served = route_cont_served = route_bandwidth = one

    stats = FabricStats(
        link_up=_mean(alg),
        afp=1.0 - _mean(ideal_ok),
        cafp=_mean(~alg & ideal_ok),
        matched=_mean(alg & ltc_both & shift_eq),
        reconciled=_mean(alg & ltc_both & ~shift_eq),
        bandwidth=_mean(lane_frac),
        route_up=route_up,
        route_cont=route_cont,
        route_served=route_served,
        route_cont_served=route_cont_served,
        route_bandwidth=route_bandwidth,
    )
    return FabricStats(*(x.reshape(lead) for x in stats))


def auto_link_chunk(cfg: ArbitrationConfig, n_links: int, budget: int = _CHUNK_BUDGET) -> int:
    """Largest link chunk whose 2 * chunk-trial working set fits ``budget``.

    Uses the sweep engine's own ``scheme_point_bytes`` accounting (a chunk
    of K links is one 2K-trial scheme evaluation), so fabric memory follows
    the engine's budget.
    """
    if n_links < 1:
        raise ValueError(f"n_links must be >= 1, got {n_links}")
    if scheme_point_bytes(cfg, 2 * n_links) <= budget:
        return n_links
    if scheme_point_bytes(cfg, 2) > budget:
        # Degenerate floor: even a single link overflows the budget.  One
        # link per chunk is the smallest unit the engine can evaluate.
        return 1
    lo, hi = 1, n_links  # n_links >= 2 here: the full fabric did not fit
    while hi - lo > 1:  # invariant: lo fits, hi does not
        mid = (lo + hi) // 2
        if scheme_point_bytes(cfg, 2 * mid) <= budget:
            lo = mid
        else:
            hi = mid
    return lo


def _per_link_names(variations: Variations) -> tuple:
    """The axes overridden with one value per link (1-D tensors)."""
    return tuple(name for name, v in variations.items() if is_per_point(v))


def _map_links(cfg, spec, scheme, variations: Variations, units: FabricUnits,
               link_chunk: int, tag: str = "fabric_links", mesh=None) -> LinkEval:
    """``_eval_links`` over ``link_chunk`` links a batch, the per-link
    overrides sliced with their links (``tag`` names the chunk-plan note;
    ``mesh`` splits the link chunks over its devices)."""
    names = _per_link_names(variations)

    def run(item):
        u, values = item
        return _eval_links(cfg, spec, scheme, variations.replace(**dict(zip(names, values))), u)

    values = tuple(torch.as_tensor(variations.get(name)) for name in names)
    return chunked_map(run, (units, values), chunk=link_chunk, mesh=mesh, tag=tag)


def fabric_stats_impl(
    cfg: ArbitrationConfig,
    units: FabricUnits,
    spec: FabricSpec,
    variations: Variations,
    *,
    scheme: str,
    link_chunk: int,
) -> FabricStats:
    """Fabric evaluation body: the sweep engine's primitive for
    ``SweepRequest(fabric=...)``.  ``chunked_map`` runs ``link_chunk`` links
    (2 * link_chunk trials) a batch.

    ``units`` may hold P copies of the fabric's K links (P * K, point-major)
    with per-link overrides, as the sweep engine gives a chunk of P grid
    points; the stats then have a leading (P,) axis (also for P = 1 when an
    override is per link).
    """
    var = as_variations(variations)
    ev = _map_links(cfg, spec, scheme, var, units, link_chunk)
    if units.n_links == spec.n_links and not _per_link_names(var):
        return aggregate_stats(cfg, spec, ev)
    p = units.n_links // spec.n_links
    return aggregate_stats(cfg, spec, LinkEval(*(
        a.reshape((p, spec.n_links) + a.shape[1:]) for a in ev)))


def state_from_assignment(wl, entry) -> ProtocolState:
    """One-shot ``Assignment`` fields -> a protocol-invariant-safe state.

    The protocol engine requires dup-lock freedom (``_line_holder`` assumes
    at most one holder per line), but one-shot schemes can emit duplicate
    locks on failed trials.  Sanitize: per duplicated line the lowest-
    indexed ring keeps the lock, later claimants are starved (their warm
    re-arbitration relocks them red-ward).  Probes start at zero.
    """
    wl = torch.as_tensor(wl, dtype=torch.int32)
    entry = torch.as_tensor(entry, dtype=torch.int32, device=wl.device)
    t, n = wl.shape
    dev = wl.device
    held = wl >= 0
    lines = torch.arange(n, dtype=torch.int32, device=dev)
    eq = (wl[:, :, None] == lines[None, None, :]) & held[:, :, None]   # (T, ring, line)
    # The lowest-indexed holder of each line (N where none holds it).
    first_holder = torch.where(eq, lines[None, :, None], n).amin(dim=1)  # (T, L)
    mine = torch.gather(first_holder, 1, wl.clamp(0, n - 1).long())
    keep = held & (mine == lines[None, :])
    lock = torch.where(keep, wl, -1)
    ent = torch.where(keep, entry, -1)
    return ProtocolState(
        lock=lock,
        entry=ent,
        cursor=ent.clamp(min=0),
        probes=torch.zeros((t,), dtype=torch.int32, device=dev),
    )


@dataclasses.dataclass
class FabricResult:
    """Standalone bring-up output: per-link records + warm-restart state.

    ``ev`` fields are stacked over links; ``system`` is the flat (2K, N)
    instantiated batch (row 2k = link k's tx end, 2k + 1 rx) and ``state``
    the matching live, dup-sanitized endpoint lock state: together what a
    warm restart of the protocol engine needs instead of re-drawing
    thermals.
    """

    spec: FabricSpec
    scheme: str
    variations: Variations
    units: FabricUnits
    ev: LinkEval
    stats: FabricStats
    system: SystemBatch
    state: ProtocolState


def bringup(
    cfg: ArbitrationConfig,
    spec: FabricSpec,
    *,
    tr_mean: float | None = None,
    scheme: str = "vtrs_ssm",
    seed: int = 0,
    variations=None,
    mesh=None,
    link_chunk: int | None = None,
    device=None,
    partitionable: bool = True,
) -> FabricResult:
    """Arbitrate a whole fabric: every link's two ends in batches of
    ``link_chunk`` links (default: the largest that fits the sweep engine's
    memory budget).  Units are drawn by ``make_fabric_units`` on ``device``
    (CUDA unless named).  Under an installed ``repro_torch.obs.phase``
    recorder the link plan is noted (``bringup.plan``) and the links run
    through ``measured_call``.  ``mesh`` (a 1-D
    ``repro_torch.launch.SweepMesh``) splits the link-chunk axis over its
    devices, bit-identical to the unsharded path; the results come back to
    the units' device.
    """
    mesh = check_mesh(mesh)
    var = as_variations(variations)
    if tr_mean is not None:
        var = var.replace(tr_mean=tr_mean)
    units = make_fabric_units(cfg, spec, seed, device, partitionable=partitionable)
    chunk = link_chunk or auto_link_chunk(cfg, spec.n_links)
    rec = current_recorder()
    if rec is not None:
        rec.note(
            "bringup.plan", links=int(spec.n_links), link_chunk=int(chunk),
            n_chunks=-(-int(spec.n_links) // int(chunk)), scheme=scheme,
            per_chunk_bytes=int(scheme_point_bytes(cfg, 2 * chunk)),
            budget=_CHUNK_BUDGET,
        )
    ev = measured_call("bringup", _map_links,
                       (cfg, spec, scheme, var, units, chunk, "bringup_links", mesh), {},
                       budget=_CHUNK_BUDGET)
    stats = aggregate_stats(cfg, spec, ev)
    k, n = spec.n_links, cfg.grid.n_ch
    system = instantiate_links(cfg, spec, units, var)
    state = state_from_assignment(ev.wl.reshape(2 * k, n), ev.entry.reshape(2 * k, n))
    return FabricResult(spec=spec, scheme=scheme, variations=var, units=units, ev=ev,
                        stats=stats, system=system, state=state)

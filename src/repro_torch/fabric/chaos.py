"""Fabric-scale fault injection: chaos timelines + warm re-lock at 1000 links.

A ``FabricTimeline`` carries *fabric-scoped* drift and fault events: per-pod
thermal ramps, comb-group-correlated laser wander, link kill/flap,
comb-source failure (every link drawing that comb's light loses its lines
together), and ring death on a chosen endpoint.  ``run_fabric_timeline``
steps every link's ``ProtocolState`` through it with the temporal engine's
machinery:

1. per step, every link's drifted optics rebuild their search tables
   against the *live* bus (dead lanes/rings/links masked through the
   tables' ``visible`` mask),
2. carried locks revalidate with hysteresis (``protocol.revalidate_state``),
3. *disturbed* links warm-restart the protocol engine (transactional
   make-before-break commits, cold escalation: ``core.temporal.protocol_relock``,
   the escalation the single-transceiver timeline runs); undisturbed links
   keep their carried state verbatim and spend nothing,
4. per-step ``FabricStats`` aggregate the re-derived link records,
   including the degraded-mode route metrics (``route_served`` /
   ``route_bandwidth``).

Step 0 is the bring-up: the scheme's own arbiter runs on the step-0 bus as
``fabric.bringup`` does, so with zero drift and no events the step-0
records equal a single-shot ``bringup`` bit for bit (an all-True visibility
mask is ``ok & True`` in the table builder).  Steps >= 1 re-lock with the
protocol engine in both modes (warm resumes carried state; cold
re-arbitrates from scratch, the baseline): the scheme governs bring-up, the
protocol engine governs repair.

The reference's ``lax.scan`` over steps is a host loop that carries one
flat ``ProtocolState`` of 2 rows a link (row 2k = link k's tx end, 2k + 1
its rx end); each step runs ``chunked_map`` over link chunks, a chunk one
batch of trials through the kernels.  Link-level decisions (a link with no
surviving lock restarts cold; a disturbed link, or one with a broken lock,
re-locks) reduce over both rows of the link.  Warm mode re-locks every
link and keeps the result only on the active ones, with the cold
escalation of ``protocol_relock`` over all of them, as the reference does.
``SweepRequest(fabric=..., timeline=...)`` maps whole chaos timelines over
variation grids.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence

import numpy as np
import torch

from ..core import ideal
from ..core.api import oblivious_arbitrate, scheme_spec
from ..core.grid import ArbitrationConfig
from ..core.matching import adjacency_bitmask, max_matching
from ..core.protocol import ProtocolState, cold_state, revalidate_state
from ..core.reach import reach_matrix, trial_value
from ..core.relation import chain_spec
from ..core.sampling import SystemBatch, resolve_device
from ..core.search_table import build_search_tables
from ..core.sweep import chunked_map
from ..core.temporal import _protocol_kwargs, _ramp, _where_trials, protocol_relock
from ..core.variations import Variations, apply_axis_transforms, as_variations, is_per_point
from ..launch.mesh import check_mesh
from ..obs.health import health_codes
from .bringup import (
    FabricStats,
    LinkEval,
    _mean,
    aggregate_stats,
    auto_link_chunk,
    link_record,
    state_from_assignment,
)
from .sampling import FabricUnits, instantiate_links
from .spec import FabricSpec


class FabricTimeline(NamedTuple):
    """A fabric-scoped drift/event trajectory over S steps and K links.

    Drift offsets are in nm and *absolute* relative to the undrifted
    system (not per-step increments); liveness is per step.  ``disturbed``
    is host-precomputed: a link is disturbed at step s when any of its
    drift or liveness fields changed vs step s-1 (step 0 compares against
    the pristine zero-drift, all-alive fabric); the warm loop restarts
    only disturbed links.
    """

    ring_drift: torch.Tensor   # (S, K, 2, N) per-endpoint ring offsets
    laser_drift: torch.Tensor  # (S, K, N) per-link comb-line offsets
    lane_alive: torch.Tensor   # (S, K, N) bool: laser line on the link's bus
    ring_alive: torch.Tensor   # (S, K, 2, N) bool: ring controller powered
    link_alive: torch.Tensor   # (S, K) bool: link (fiber/port) administratively up
    disturbed: torch.Tensor    # (S, K) bool: anything above changed this step

    @property
    def n_steps(self) -> int:
        return self.ring_drift.shape[0]

    @property
    def n_links(self) -> int:
        return self.ring_drift.shape[1]

    @property
    def n_ch(self) -> int:
        return self.ring_drift.shape[3]


_EVENT_ARITY = {
    "link_kill": 1, "link_heal": 1, "link_flap": 2,
    "comb_kill": 1, "comb_heal": 1,
    "lane_kill": 2, "lane_heal": 2,
    "ring_kill": 3, "ring_heal": 3,
}


def _check_index(kind: str, what: str, v: int, hi: int) -> int:
    v = int(v)
    if not 0 <= v < hi:
        raise ValueError(
            f"event {kind!r} references {what} {v}, outside 0..{hi - 1} "
            f"for this fabric"
        )
    return v


def make_fabric_timeline(
    spec: FabricSpec,
    n_steps: int,
    n_ch: int,
    *,
    thermal=None,
    pod_thermal=None,
    comb=None,
    events: Sequence[tuple] = (),
    device=None,
) -> FabricTimeline:
    """Deterministic fabric timeline builder (numpy on the host, then
    ``device``, CUDA unless named).

    thermal:     fabric-wide ring red-shift profile [nm]: scalar (linear
                 ramp to that value), (K, 2) ``(step, value)`` breakpoints,
                 or (S,), applied to every endpoint (``core.temporal._ramp``
                 forms).
    pod_thermal: mapping pod id -> profile (same forms); each endpoint
                 follows its *own* pod's ramp (link k's end 0 sits in the
                 lower-numbered pod), added on top of ``thermal``: every
                 link touching a hot pod drifts together.
    comb:        laser-line wander [nm]: ``(amplitude, period)`` for a
                 sinusoid phase-staggered per comb *group* (links sharing a
                 comb wander identically; distinct groups are offset by
                 1/n_groups of a period), or the ``_ramp`` forms (uniform
                 across groups).
    events:      fault events ``(step, kind, *args)``; liveness changes
                 persist from ``step`` onward and later events override
                 earlier ones (kill then heal is an outage window):

                   ("link_kill", link) / ("link_heal", link)
                   ("link_flap", link, down_steps)  (kill + auto-heal)
                   ("comb_kill", group) / ("comb_heal", group): every link
                       in comb group ``group`` loses/regains ALL laser lines
                   ("lane_kill", link, ch) / ("lane_heal", link, ch)
                   ("ring_kill", link, end, ch) / ("ring_heal", ...)

                 Out-of-range links/groups/endpoints/channels raise
                 ``ValueError``.
    """
    dev = resolve_device(device)
    if n_steps < 1:
        raise ValueError(f"a timeline needs >= 1 step, got {n_steps}")
    k = spec.n_links
    group = spec.link_group()
    src, dst = spec.link_pods()

    # ------------------------------------------------------------- drift
    base = _ramp(n_steps, thermal)                        # (S,)
    pod_t = np.zeros((n_steps, spec.pods), np.float32)
    for pod, prof in dict(pod_thermal or {}).items():
        pod = int(pod)
        if not 0 <= pod < spec.pods:
            raise ValueError(
                f"pod_thermal names pod {pod}, outside 0..{spec.pods - 1}"
            )
        pod_t[:, pod] = _ramp(n_steps, prof)
    end_pods = np.stack([src, dst], axis=1)               # (K, 2)
    ring_drift = np.broadcast_to(
        (base[:, None, None] + pod_t[:, end_pods])[..., None],
        (n_steps, k, 2, n_ch),
    ).astype(np.float32).copy()

    if isinstance(comb, tuple) and len(comb) == 2 and np.ndim(comb[0]) == 0:
        amp, period = comb
        steps = np.arange(n_steps, dtype=np.float32)
        phase = (
            np.arange(spec.n_groups, dtype=np.float32) / max(1, spec.n_groups)
        )
        g_t = np.float32(amp) * np.sin(
            2.0 * np.pi * (steps[:, None] / np.float32(period) + phase[None, :])
        ).astype(np.float32)                              # (S, G)
    else:
        g_t = np.broadcast_to(
            _ramp(n_steps, comb)[:, None], (n_steps, spec.n_groups)
        )
    laser_drift = np.broadcast_to(
        g_t[:, group][..., None], (n_steps, k, n_ch)
    ).astype(np.float32).copy()

    # ------------------------------------------------------------ events
    lane = np.ones((n_steps, k, n_ch), bool)
    ring = np.ones((n_steps, k, 2, n_ch), bool)
    link = np.ones((n_steps, k), bool)
    for ev in events:
        step, kind, *args = ev
        if kind not in _EVENT_ARITY:
            raise ValueError(
                f"unknown event kind {kind!r}; valid: "
                f"{tuple(_EVENT_ARITY)}"
            )
        if len(args) != _EVENT_ARITY[kind]:
            raise ValueError(
                f"event {kind!r} takes {_EVENT_ARITY[kind]} argument(s), "
                f"got {args}"
            )
        step = int(step)
        if not 0 <= step < n_steps:
            raise ValueError(
                f"event {ev} at step {step}, outside 0..{n_steps - 1}"
            )
        if kind in ("link_kill", "link_heal"):
            l = _check_index(kind, "link", args[0], k)  # noqa: E741
            link[step:, l] = kind.endswith("heal")
        elif kind == "link_flap":
            l = _check_index(kind, "link", args[0], k)  # noqa: E741
            down = int(args[1])
            if down < 1:
                raise ValueError(f"link_flap needs down_steps >= 1, got {down}")
            link[step:step + down, l] = False
        elif kind in ("comb_kill", "comb_heal"):
            g = _check_index(kind, "comb group", args[0], spec.n_groups)
            lane[step:, group == g, :] = kind.endswith("heal")
        elif kind in ("lane_kill", "lane_heal"):
            l = _check_index(kind, "link", args[0], k)  # noqa: E741
            ch = _check_index(kind, "channel", args[1], n_ch)
            lane[step:, l, ch] = kind.endswith("heal")
        else:  # ring_kill / ring_heal
            l = _check_index(kind, "link", args[0], k)  # noqa: E741
            end = _check_index(kind, "endpoint", args[1], 2)
            ch = _check_index(kind, "channel", args[2], n_ch)
            ring[step:, l, end, ch] = kind.endswith("heal")

    # --------------------------------------------------------- disturbed
    def changed(arr, pristine) -> np.ndarray:
        flat = arr.reshape(n_steps, k, -1)
        prev = np.concatenate(
            [np.full_like(flat[:1], pristine), flat[:-1]], axis=0
        )
        return (flat != prev).any(axis=2)

    disturbed = (
        changed(ring_drift, 0.0) | changed(laser_drift, 0.0)
        | changed(lane, True) | changed(ring, True) | changed(link, True)
    )
    return FabricTimeline(*(torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in (
        ring_drift, laser_drift, lane, ring, link, disturbed)))


class FabricChaosStats(NamedTuple):
    """Per-step output of one ``run_fabric_timeline`` call.

    ``fabric`` leaves are (S,) scalars-per-step (incl. the degraded-mode
    route metrics); per-link fields are (S, K).  ``probes``/``rounds``
    count only each step's incremental spend (step 0 is bring-up: zero;
    one-shot arbiters do not report probes, and both warm and cold modes
    share it).  ``feasible`` marks links whose live bus still admits a
    complete matching at both ends (dead rings exempt, dead lanes/links
    gone).
    """

    fabric: FabricStats     # (S,) leaves
    wl: torch.Tensor        # (S, K, 2, N) int32 committed locks per step
    probes: torch.Tensor    # (S, K) int32, summed over both endpoints
    rounds: torch.Tensor    # (S, K) int32, max over both endpoints
    locked: torch.Tensor    # (S, K) int32 locked rings (0..2N)
    broken: torch.Tensor    # (S, K) int32 locks broken at revalidation
    churn: torch.Tensor     # (S, K) int32 surviving locks that moved anyway
    feasible: torch.Tensor  # (S, K) bool
    #: (S, K) int8 ``repro_torch.obs.health`` codes, only with ``health=True``
    health: Any = None


class _LinkStep(NamedTuple):
    """Per-link scalar accounting for one step (stacked to (K,) / (S, K))."""

    probes: torch.Tensor
    rounds: torch.Tensor
    locked: torch.Tensor
    broken: torch.Tensor
    churn: torch.Tensor
    feasible: torch.Tensor


def _rows(x: torch.Tensor) -> torch.Tensor:
    """Link-major (Lc, 2, ...) -> flat rows (2 * Lc, ...)."""
    return x.reshape((-1,) + tuple(x.shape[2:]))


def _pairs(x: torch.Tensor) -> torch.Tensor:
    """Flat rows (2 * Lc, ...) -> link-major (Lc, 2, ...)."""
    return x.reshape((-1, 2) + tuple(x.shape[1:]))


def _per_link(x: torch.Tensor) -> torch.Tensor:
    """A per-row (2 * Lc, ...) tensor -> (Lc, everything else) per link."""
    return x.reshape(x.shape[0] // 2, -1)


def _link_rows(x: torch.Tensor) -> torch.Tensor:
    """A per-link (Lc,) value repeated over the link's two rows."""
    return x.repeat_interleave(2)


def _drifted(cfg, sys: SystemBatch, tl) -> SystemBatch:
    """The step's drift offsets through the registered variation transforms
    (the same hooks static sweeps use), rings per endpoint, comb lines per
    link on both of its rows."""
    return apply_axis_transforms(
        sys, {"thermal_drift": _rows(tl.ring_drift),
              "comb_wander": tl.laser_drift.repeat_interleave(2, dim=0)}, cfg)


def _visibility(tl, n: int) -> torch.Tensor:
    """(2 * Lc, N_ring, N_wl) bool: line visible to ring = lane alive & ring
    alive & link alive (a dead link sees an empty bus: all locks break and
    empty tables never spend probes; killed links are not re-locked)."""
    vis = (tl.lane_alive[:, None, None, :] & tl.ring_alive[:, :, :, None]
           & tl.link_alive[:, None, None, None])
    return vis.expand(-1, 2, n, n).reshape(-1, n, n).contiguous()


def _link_feasible(sys: SystemBatch, tr, tl) -> torch.Tensor:
    """(Lc,) live-bus feasibility: every live ring on BOTH endpoints
    matchable to a distinct live line within TR, and the link itself up."""
    lane = tl.lane_alive.repeat_interleave(2, dim=0)             # (2Lc, N)
    ring = _rows(tl.ring_alive)                                  # (2Lc, N)
    reach = reach_matrix(sys, tr) & lane[:, None, :] & ring[:, :, None]
    match_wl, _ = max_matching(adjacency_bitmask(reach))
    n_live = ring.sum(dim=1, dtype=torch.int32)
    end_ok = (match_wl >= 0).sum(dim=1, dtype=torch.int32) >= n_live
    return _pairs(end_ok).all(dim=1) & tl.link_alive


def _tr_rows(tr, tr_links: tuple):
    """The operating point per row: the scalar, or the chunk's per-link
    values over both rows of each link."""
    return _link_rows(tr_links[0]) if tr_links else tr


def _bringup_step(cfg, scheme, tr, item):
    """Step-0 bring-up of a link chunk: the scheme's own arbiter on the
    step-0 bus.  With zero drift and no events this is ``bringup``'s
    evaluation bit for bit (zero drift offsets add +0.0; the all-True
    visibility mask is ``ok & True`` in the table builder)."""
    sys_links, tl, tr_links = item
    n = cfg.grid.n_ch
    policy = scheme_spec(scheme).policy
    tr = _tr_rows(tr, tr_links)
    sys = _drifted(cfg, SystemBatch(*(_rows(x) for x in sys_links)), tl)
    assign = oblivious_arbitrate(cfg, sys, tr, scheme, visible=_visibility(tl, n))
    ideal_ok = ideal.success(sys, policy, cfg.s, tr)
    rec = link_record(cfg, policy, assign.wl, assign.entry, ideal_ok)
    state = state_from_assignment(assign.wl, assign.entry)
    return (ProtocolState(*(_pairs(x) for x in state)), rec,
            _link_feasible(sys, tr, tl))


def _relock_step(cfg, scheme, tr, warm, transactional, patience, hysteresis, item):
    """One step of a link chunk: rebuild tables on the live drifted bus,
    revalidate carried locks, re-lock with the protocol engine.

    Warm mode resumes the carried state and gates on disturbance: an
    undisturbed link's tables are identical to the previous step's, so its
    carried state is already a fixed point; it is kept verbatim with zero
    spend.  Cold mode re-arbitrates every link from scratch each step (the
    baseline).  Both modes run the protocol engine, for one-shot bring-up
    schemes too.  Decisions per link reduce over both of its rows.
    """
    sys_links, tl, st_links, tr_links = item
    n = cfg.grid.n_ch
    policy = scheme_spec(scheme).policy
    kw = _protocol_kwargs(scheme) or {}
    tr = _tr_rows(tr, tr_links)
    sys = _drifted(cfg, SystemBatch(*(_rows(x) for x in sys_links)), tl)
    st = ProtocolState(*(_rows(x) for x in st_links))
    t, dev = st.lock.shape[0], st.lock.device
    tables = build_search_tables(sys, tr, visible=_visibility(tl, n),
                                 max_alias=cfg.max_fsr_alias)
    prev_lock = st.lock
    reval, kept = revalidate_state(tables, st, tr=trial_value(tr, dev, 2) * sys.tr_unit,
                                   hysteresis=hysteresis)
    broken_e = (prev_lock >= 0) & (reval.lock < 0)
    cold0 = cold_state(t, n, dev)
    if warm:
        # A link with no surviving locks has nothing warm to resume: its
        # stale red-ward cursors would re-lock a shifted arrangement after
        # a full outage (e.g. comb heal).  Resume survivors, else restart.
        none_kept = ~_per_link(reval.lock >= 0).any(dim=1)
        start = _where_trials(_link_rows(none_kept), cold0, reval)
    else:
        start = cold0
    start = start._replace(probes=torch.zeros((t,), dtype=torch.int32, device=dev))
    new, probes, rounds = protocol_relock(
        tables, chain_spec(cfg.s), start, warm=warm, transactional=transactional,
        patience=patience, kw=kw)
    if warm:
        act = _link_rows(tl.disturbed | _per_link(broken_e).any(dim=1))
        sel = _where_trials(act, new, st)
        probes = torch.where(act, probes, 0)
        rounds = torch.where(act, rounds, 0)
    else:
        sel = new
    ideal_ok = ideal.success(sys, policy, cfg.s, tr)
    rec = link_record(cfg, policy, sel.lock, sel.entry, ideal_ok)
    per = _LinkStep(
        probes=_per_link(probes).sum(dim=1, dtype=torch.int32),
        rounds=_per_link(rounds).amax(dim=1).to(torch.int32),
        locked=_per_link(sel.lock >= 0).sum(dim=1, dtype=torch.int32),
        broken=_per_link(broken_e).sum(dim=1, dtype=torch.int32),
        churn=_per_link(kept & (sel.lock != prev_lock)).sum(dim=1, dtype=torch.int32),
        feasible=_link_feasible(sys, tr, tl),
    )
    return ProtocolState(*(_pairs(x) for x in sel)), rec, per


def _run_chaos(cfg, units: FabricUnits, spec: FabricSpec, timeline: FabricTimeline,
               var: Variations, *, n_points: int | None, scheme: str, warm: bool,
               transactional: bool, patience, hysteresis, link_chunk: int, mesh=None):
    """The chaos loop over ``units.n_links`` links: the fabric's K links, or
    ``n_points`` copies of them (point-major, with per-link overrides and a
    timeline tiled to match) whose stats get a (P,) axis after the step
    axis (per-link fields (S, P, K))."""
    n = cfg.grid.n_ch
    k_all = units.n_links
    sys_links = SystemBatch(*(x.view(k_all, 2, n) for x in
                              instantiate_links(cfg, spec, units, var)))
    tr = var.resolve("tr_mean", cfg)
    tr_links = (torch.as_tensor(tr, dtype=torch.float32, device=units.go.device),) \
        if is_per_point(tr) else ()

    def by_point(x):
        return x if n_points is None else x.reshape((n_points, spec.n_links) + x.shape[1:])

    def step_stats(rec: LinkEval):
        return aggregate_stats(cfg, spec, LinkEval(*(by_point(a) for a in rec)))

    tl0 = FabricTimeline(*(a[0] for a in timeline))
    st, ev0, feas0 = chunked_map(lambda item: _bringup_step(cfg, scheme, tr, item),
                                 (sys_links, tl0, tr_links), chunk=link_chunk, mesh=mesh)
    zeros = torch.zeros((k_all,), dtype=torch.int32, device=st.lock.device)
    stats = [step_stats(ev0)]
    wls = [ev0.wl]
    per = [_LinkStep(probes=zeros, rounds=zeros,
                     locked=(st.lock >= 0).sum(dim=(1, 2), dtype=torch.int32),
                     broken=zeros, churn=zeros, feasible=feas0)]
    for s_idx in range(1, timeline.n_steps):
        tl_s = FabricTimeline(*(a[s_idx] for a in timeline))
        st, rec, per_s = chunked_map(
            lambda item: _relock_step(cfg, scheme, tr, warm, transactional, patience,
                                      hysteresis, item),
            (sys_links, tl_s, st, tr_links), chunk=link_chunk, mesh=mesh)
        stats.append(step_stats(rec))
        wls.append(rec.wl)
        per.append(per_s)

    stack = lambda xs: torch.stack([by_point(x) for x in xs])  # noqa: E731
    chaos = FabricChaosStats(
        fabric=FabricStats(*(torch.stack(f) for f in zip(*stats))),
        wl=stack(wls),
        **{f: stack(xs) for f, xs in zip(_LinkStep._fields, zip(*per))},
    )
    state = ProtocolState(*(_rows(x) for x in st))
    return state, chaos


def run_fabric_timeline_impl(
    cfg: ArbitrationConfig,
    units: FabricUnits,
    spec: FabricSpec,
    timeline: FabricTimeline,
    variations=None,
    *,
    scheme: str = "vtrs_ssm",
    warm: bool = True,
    transactional: bool = True,
    patience: int | None = 4,
    hysteresis=0.0,
    link_chunk: int = 0,
    mesh=None,
    health: bool = False,
) -> tuple[ProtocolState, FabricChaosStats]:
    """Drive every link of a fabric along a chaos timeline.

    Step 0 brings the fabric up with ``scheme``'s arbiter on the step-0
    bus; steps >= 1 are a host loop carrying the flat (2K, N)
    ``ProtocolState``, each step one ``chunked_map`` over link chunks
    (``link_chunk=0`` auto-fits the sweep engine's memory budget).  Returns
    ``(final_state, FabricChaosStats)`` with the state in the (2K, N)
    layout (row 2k = link k's tx end).

    ``health=True`` also fills ``FabricChaosStats.health``, the (S, K) int8
    post-mortem matrix of ``repro_torch.obs.health`` codes (down / hopeless
    / degraded / relocking / healthy), folded from the per-step per-link
    stats above, so it never changes the arbitration outcome.  ``mesh`` (a
    1-D ``repro_torch.launch.SweepMesh``) splits each step's link chunks
    over its devices; the carried state comes back to the units' device
    every step, so the result is bit-identical to the unsharded path.
    """
    mesh = check_mesh(mesh)
    var = as_variations(variations)
    k, n = spec.n_links, cfg.grid.n_ch
    if timeline.n_links != k or timeline.n_ch != n:
        raise ValueError(
            f"timeline is ({timeline.n_links} links, {timeline.n_ch} ch) "
            f"but the fabric needs ({k}, {n})"
        )
    state, chaos = _run_chaos(
        cfg, units, spec, timeline, var, n_points=None, scheme=scheme, warm=warm,
        transactional=transactional, patience=patience, hysteresis=hysteresis,
        link_chunk=link_chunk or auto_link_chunk(cfg, k), mesh=mesh)
    if health:
        chaos = chaos._replace(health=health_codes(
            chaos.locked, chaos.probes, chaos.feasible, timeline.link_alive, n))
    return state, chaos


#: The reference jit-compiles ``run_fabric_timeline_impl``; the port runs it
#: eagerly.
run_fabric_timeline = run_fabric_timeline_impl


def summarize_chaos(cs: FabricChaosStats) -> FabricChaosStats:
    """Reduce per-link fields to link means: the form a chaos grid point
    returns under ``SweepRequest(fabric=..., timeline=...)`` (``wl`` is
    dropped: per-step lock maps do not aggregate).  Means are float32
    counts over the links divided by K."""
    return cs._replace(
        wl=None, health=None,
        probes=_mean(cs.probes), rounds=_mean(cs.rounds),
        locked=_mean(cs.locked), broken=_mean(cs.broken),
        churn=_mean(cs.churn), feasible=_mean(cs.feasible),
    )

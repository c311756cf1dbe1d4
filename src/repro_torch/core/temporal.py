"""Temporal re-arbitration: time as a simulation axis.

A locked system has to survive thermal ramps, comb wander, ring aging and
lane failure.  A drift/event ``Timeline`` drives the protocol engine, whose
live ``ProtocolState`` is carried from step to step.  Each step:

1. applies the step's drift offsets through the registered variation axes
   (``thermal_drift`` for the rings, ``comb_wander`` for the comb),
2. rebuilds the search tables against the live bus (dead lanes and dead
   rings masked through the tables' ``visible`` mask),
3. revalidates the carried locks (``protocol.revalidate_state``): a held line
   missing from the rebuilt table is a *broken* lock; an optional
   ``hysteresis`` margin breaks locks before drift pushes them out,
4. re-arbitrates with ``run_protocol`` from the carried state (warm,
   incremental, transactional) or from scratch (cold, the baseline).

The reference's ``lax.scan`` over steps is a host loop that stacks each
step's stats.  Timeline sweeps (``SweepRequest(timeline=...)``) pass
per-point variations: the batch then holds every point's trials, each point
under its own values.  A campaign is checkpointed after a step with
``save_campaign`` and resumed with ``restore_campaign`` (through
``checkpoint.store``, in the reference's on-disk layout).
"""
from __future__ import annotations

from typing import NamedTuple, Sequence

import numpy as np
import torch

from ..checkpoint import store
from ..obs.trace import TraceBuffer, merge_traces, trace_buffer
from .matching import adjacency_bitmask, max_matching
from .protocol import ProtocolState, cold_state, revalidate_state, run_protocol
from .reach import reach_matrix, trial_value
from .relation import chain_spec
from .sampling import UnitSamples, instantiate, per_trial, resolve_device
from .search_table import build_search_tables
from .variations import Variations, apply_axis_transforms, as_variations, point_count


class Timeline(NamedTuple):
    """A drift/event trajectory: per-step offsets and liveness, all (S, N).

    Offsets are in nm and absolute relative to the undrifted system (not
    per-step increments), so a timeline slice replays identically from a
    carried state.
    """

    ring_drift: torch.Tensor   # (S, N) added to every trial's ring resonances
    laser_drift: torch.Tensor  # (S, N) added to every trial's laser lines
    lane_alive: torch.Tensor   # (S, N) bool: laser line present on the bus
    ring_alive: torch.Tensor   # (S, N) bool: ring controller powered

    @property
    def n_steps(self) -> int:
        return self.ring_drift.shape[0]

    @property
    def n_ch(self) -> int:
        return self.ring_drift.shape[1]


class TemporalStats(NamedTuple):
    """Per-step accounting of one ``run_timeline`` call, all (S, T).

    ``probes``/``rounds`` count each step's own spend; ``broken`` counts locks
    invalidated at the step's revalidation gate; ``churn`` counts rings whose
    lock survived revalidation but ended the step on another line;
    ``feasible`` marks trials whose live bus still admits a perfect matching
    of live rings onto live lines.
    """

    probes: torch.Tensor    # (S, T) int32
    rounds: torch.Tensor    # (S, T) int32
    locked: torch.Tensor    # (S, T) int32
    broken: torch.Tensor    # (S, T) int32
    churn: torch.Tensor     # (S, T) int32
    feasible: torch.Tensor  # (S, T) bool


def _ramp(n_steps: int, spec) -> np.ndarray:
    """Resolve a drift spec to a (S,) float32 profile: a scalar (linear ramp
    0 -> spec), (K, 2) ``(step, value)`` breakpoints, or a (S,) array."""
    steps = np.arange(n_steps, dtype=np.float32)
    if spec is None:
        return np.zeros(n_steps, np.float32)
    arr = np.asarray(spec, np.float32)
    if arr.ndim == 0:
        last = max(1, n_steps - 1)
        return arr * steps / last
    if arr.ndim == 2 and arr.shape[1] == 2:
        return np.interp(steps, arr[:, 0], arr[:, 1]).astype(np.float32)
    if arr.shape != (n_steps,):
        raise ValueError(
            f"drift spec must be scalar, (K, 2) breakpoints or ({n_steps},); "
            f"got shape {arr.shape}"
        )
    return arr


_EVENT_KINDS = ("lane_kill", "lane_swap", "ring_kill", "ring_swap")


def make_timeline(
    n_steps: int,
    n_ch: int,
    *,
    thermal=None,
    aging=None,
    comb=None,
    events: Sequence[tuple] = (),
    device=None,
) -> Timeline:
    """Deterministic timeline builder (numpy on the host, then ``device``,
    CUDA unless named).

    thermal: uniform ring red-shift profile [nm]: a scalar (linear ramp to
             that value), (K, 2) ``(step, value)`` breakpoints, or (S,).
    aging:   differential aging: ring i accumulates ``profile * i/(N-1)``.
    comb:    uniform laser-line wander [nm]: ``(amplitude, period)`` for a
             sinusoid, or the same forms as thermal.
    events:  ``(step, kind, channel)``, kind one of lane_kill / lane_swap /
             ring_kill / ring_swap; liveness changes persist from ``step``.
    """
    dev = resolve_device(device)
    thermal_t = _ramp(n_steps, thermal)
    aging_t = _ramp(n_steps, aging)
    if isinstance(comb, tuple) and len(comb) == 2 and np.ndim(comb[0]) == 0:
        amp, period = comb
        comb_t = np.float32(amp) * np.sin(
            2.0 * np.pi * np.arange(n_steps) / float(period)
        ).astype(np.float32)
    else:
        comb_t = _ramp(n_steps, comb)

    tilt = np.arange(n_ch, dtype=np.float32) / max(1, n_ch - 1)
    ring_drift = thermal_t[:, None] + aging_t[:, None] * tilt[None, :]
    laser_drift = np.broadcast_to(comb_t[:, None], (n_steps, n_ch)).copy()

    lane = np.ones((n_steps, n_ch), bool)
    ring = np.ones((n_steps, n_ch), bool)
    for step, kind, ch in events:
        if kind not in _EVENT_KINDS:
            raise ValueError(f"unknown event kind {kind!r}; valid: {_EVENT_KINDS}")
        target = lane if kind.startswith("lane") else ring
        target[step:, ch] = kind.endswith("swap")
    return Timeline(
        ring_drift=torch.from_numpy(np.asarray(ring_drift, np.float32)).to(dev),
        laser_drift=torch.from_numpy(np.asarray(laser_drift, np.float32)).to(dev),
        lane_alive=torch.from_numpy(lane).to(dev),
        ring_alive=torch.from_numpy(ring).to(dev),
    )


def slice_timeline(tl: Timeline, start: int, stop: int | None = None) -> Timeline:
    """Steps ``[start, stop)`` of a timeline (offsets are absolute, so a
    slice resumes identically from a carried state)."""
    return Timeline(*(a[start:stop] for a in tl))


def _protocol_kwargs(scheme: str) -> dict | None:
    """``run_protocol`` kwargs of a registered protocol scheme (the settings
    ``api.make_protocol`` baked into its arbiter), or None for one-shot
    schemes (cold-only re-arbitration, no probe stats)."""
    from .api import scheme_spec  # local: api imports this module's deps

    kw = getattr(scheme_spec(scheme).arbiter, "protocol_kwargs", None)
    return None if kw is None else dict(kw)


def _where_trials(mask: torch.Tensor, a: ProtocolState, b: ProtocolState) -> ProtocolState:
    """Per trial: ``a`` where ``mask`` (T,) else ``b``."""
    return ProtocolState(*(
        torch.where(mask.reshape((-1,) + (1,) * (x.dim() - 1)), x, y)
        for x, y in zip(a, b)
    ))


def protocol_relock(tables, spec, start: ProtocolState, *, warm: bool,
                    transactional: bool = True, patience: int | None = 4,
                    kw: dict | None = None, trace: int | None = None):
    """One re-lock pass of the protocol engine from ``start``.

    Returns ``(new_state, probes, rounds)``.  With ``warm=True`` the pass
    includes the cold escalation: trials the warm pass left unresolved (a
    starved ring with peaks remains, and the warm start held some lock) rerun
    from scratch and pay both passes' probes and rounds; the cold result is
    taken where it locked more rings.  With ``trace`` (a flight-recorder
    capacity, see ``run_protocol``) both passes are traced and the merged
    ``TraceBuffer`` is appended: a trial that takes the cold result carries
    the cold pass's trace.
    """
    t, n = start.lock.shape
    kw = kw or {}
    out = run_protocol(
        tables, spec, with_stats=True, with_state=True, init_state=start,
        transactional=transactional, patience=patience, trace=trace, **kw,
    )
    _, stats, new = out[:3]
    probes, rounds = stats.probes, stats.worked
    if warm:
        unresolved = (((new.lock < 0) & (tables.n_valid > 0)).any(dim=1)
                      & (start.lock >= 0).any(dim=1))
        cout = run_protocol(
            tables, spec, with_stats=True, with_state=True,
            init_state=cold_state(t, n, start.lock.device),
            transactional=transactional, patience=patience, trace=trace, **kw,
        )
        _, cstats, cnew = cout[:3]
        use_cold = unresolved & (cstats.locked > stats.locked)
        new = _where_trials(use_cold, cnew, new)
        probes = probes + torch.where(unresolved, cstats.probes, 0)
        rounds = rounds + torch.where(unresolved, cstats.worked, 0)
        if trace is not None:
            return new, probes, rounds, merge_traces(use_cold, cout[3], out[3])
    return (new, probes, rounds) + out[3:]


def run_timeline_impl(
    cfg,
    units: UnitSamples,
    timeline: Timeline,
    variations=None,
    *,
    scheme: str = "protocol_lta",
    warm: bool = True,
    transactional: bool = True,
    patience: int | None = 4,
    hysteresis=0.0,
    init_state: ProtocolState | None = None,
    trace: int | None = None,
):
    """Drive the protocol engine along a drift/event timeline.

    warm=True re-arbitrates incrementally from the carried lock state;
    warm=False is the cold baseline (full re-arbitration every step; the
    carried state still gives broken/churn step over step).  Both run the
    engine with the same ``transactional``/``patience`` settings.  Returns
    ``(final_state, TemporalStats)``; the state resumes a later call through
    ``init_state`` with ``slice_timeline``.  Per-point variations (1-D
    tensors, see ``sampling.instantiate``) run every point's trials in one
    batch, point-major.

    ``trace``: flight-recorder ring capacity per step (see ``run_protocol``);
    the return gains a third element, a ``TraceBuffer`` with a leading (S,)
    step axis ((S, T, cap, 4) events).  Only protocol schemes record
    (one-shot arbiters run no engine).
    """
    from .api import scheme_spec  # local: api imports this module's deps

    kw = _protocol_kwargs(scheme)
    if kw is None and warm:
        raise ValueError(
            f"scheme {scheme!r} is one-shot: it carries no protocol state, "
            "so only cold (warm=False) re-arbitration is defined"
        )
    if kw is None and trace is not None:
        raise ValueError(
            f"scheme {scheme!r} is one-shot: it never runs the protocol "
            "engine, so there is no flight recorder to enable (trace=None)"
        )
    over = as_variations(variations)
    sys = instantiate(cfg, units, over)
    spec = chain_spec(cfg.s)
    t, n = sys.laser.shape
    dev = sys.laser.device
    tr = per_trial(over.resolve("tr_mean", cfg), point_count(over), t, dev)
    arbiter = scheme_spec(scheme).arbiter
    state = cold_state(t, n, dev) if init_state is None else init_state
    zeros = torch.zeros((t,), dtype=torch.int32, device=dev)
    steps, bufs = [], []
    for s_idx in range(timeline.n_steps):
        ring_drift, laser_drift, lane_alive, ring_alive = (a[s_idx] for a in timeline)
        sys_s = apply_axis_transforms(
            sys, Variations(thermal_drift=ring_drift, comb_wander=laser_drift), cfg)
        alive = lane_alive[None, :] & ring_alive[:, None]             # (N, N)
        vis = alive.expand(t, n, n).contiguous()
        tables = build_search_tables(sys_s, tr, visible=vis,
                                     max_alias=cfg.max_fsr_alias)
        prev_lock = state.lock
        reval, kept = revalidate_state(
            tables, state, tr=trial_value(tr, dev, 2) * sys_s.tr_unit, hysteresis=hysteresis)
        broken = ((prev_lock >= 0) & (reval.lock < 0)).sum(dim=1, dtype=torch.int32)
        if kw is None:
            asg = arbiter(cfg, tables, spec)
            entry = asg.entry.to(torch.int32)
            new = ProtocolState(lock=asg.wl.to(torch.int32), entry=entry,
                                cursor=entry.clamp(min=0), probes=zeros)
            probes, rounds = zeros, zeros
        else:
            start = (reval if warm else cold_state(t, n, dev))._replace(probes=zeros)
            new, probes, rounds, *buf = protocol_relock(
                tables, spec, start, warm=warm, transactional=transactional,
                patience=patience, kw=kw, trace=trace)
            bufs += buf
        churn = (kept & (new.lock != prev_lock)).sum(dim=1, dtype=torch.int32)
        # Feasibility of the live bus: every live ring matchable to a
        # distinct live line within TR (dead rings exempt, dead lanes gone).
        reach = reach_matrix(sys_s, tr) & alive[None]
        match_wl, _ = max_matching(adjacency_bitmask(reach))
        n_live = ring_alive.sum(dtype=torch.int32)
        feasible = (match_wl >= 0).sum(dim=1, dtype=torch.int32) >= n_live
        steps.append(TemporalStats(
            probes=probes, rounds=rounds, locked=(new.lock >= 0).sum(dim=1, dtype=torch.int32),
            broken=broken, churn=churn, feasible=feasible,
        ))
        state = new
    if not steps:
        empty = torch.zeros((0, t), dtype=torch.int32, device=dev)
        out = state, TemporalStats(empty, empty, empty, empty, empty,
                                   empty.to(torch.bool))
        if trace is None:
            return out
        return out + (TraceBuffer(*(x[None][:0] for x in trace_buffer(t, trace, dev))),)
    out = state, TemporalStats(*(torch.stack(f) for f in zip(*steps)))
    if trace is None:
        return out
    return out + (TraceBuffer(*(torch.stack(f) for f in zip(*bufs))),)


#: The reference jit-compiles ``run_timeline_impl``; the port runs it eagerly.
run_timeline = run_timeline_impl


def save_campaign(ckpt_dir, step: int, state: ProtocolState) -> None:
    """Checkpoint a timeline campaign's carry state after ``step`` steps
    (``checkpoint/store.py`` is the carrier; atomic, latest-k retained)."""
    store.save(ckpt_dir, step, state)


def restore_campaign(ckpt_dir, n_trials: int, n_ch: int, step: int | None = None,
                     *, device=None) -> tuple[int, ProtocolState]:
    """Load ``(step, state)`` onto ``device`` (CUDA unless named) to resume a
    campaign: continue with ``run_timeline(..., timeline=slice_timeline(tl,
    step), init_state=state)``.  ``step=None`` takes the latest checkpoint;
    with none, ``FileNotFoundError``."""
    target = cold_state(n_trials, n_ch, device)
    if step is None:
        step = store.latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no campaign checkpoint under {ckpt_dir}")
    return step, store.restore(ckpt_dir, step, target)

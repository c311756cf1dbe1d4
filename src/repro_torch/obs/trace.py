"""Protocol flight recorder: a fixed-size per-trial event ring buffer.

``ProtocolStats`` says how many probes a trial spent, never which ring
probed what, when, and why it lost.  ``run_protocol(..., trace=cap)``
carries a ``TraceBuffer`` through the engine's round loop, and every phase
appends typed events

    (round, ring, kind, entry)    kind in EVENT_KINDS

into a per-trial ring of capacity ``cap``.  An append is a conditional
write gated on a per-trial ``fire`` mask, so the recorder follows the
engine's batching exactly like the state it observes.  Tracing is off by
default, and the disabled path runs no recorder code at all.

Ring semantics: the write head is ``n % cap`` (``n`` counts every fired
event, so ``n > cap`` means the oldest events were overwritten; the most
recent ``cap`` always survive).  Per-kind totals in ``counts`` are not
subject to wraparound, which keeps the failure taxonomy
(``repro_torch.obs.taxonomy``) exact on long-running trials.

Event vocabulary (one entry per protocol transaction):

  probe      a starved ring re-searched the masked bus (entry = its cursor)
  lock       a ring captured a line (entry = the locked table entry)
  displace   a donor relocked red-ward to free its line (entry = new entry)
  surrender  a donor gave up its line and became a seeker (entry = old)
  release    a starved ring reset its tuner sweep (entry = old cursor)
  halt       the trial sticky-halted: fixed point or plateau (ring = -1)

The buffer lives on the device of the engine's tensors; the host-side
decoders (``trace_events``, ``trace_summary``, ``format_events``) copy it
to numpy.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


EV_PROBE = 0
EV_LOCK = 1
EV_DISPLACE = 2
EV_SURRENDER = 3
EV_RELEASE = 4
EV_HALT = 5

#: kind code -> name; the order is the on-buffer integer encoding.
EVENT_KINDS = ("probe", "lock", "displace", "surrender", "release", "halt")

#: columns of one ``TraceBuffer.ev`` row.
EVENT_FIELDS = ("round", "ring", "kind", "entry")


class TraceBuffer(NamedTuple):
    """Per-trial event ring.

    ``ev`` rows are valid only below ``min(n, cap)``; ``counts`` accumulate
    per-kind totals independent of ring wraparound.
    """

    ev: torch.Tensor      # (T, cap, 4) int32 [round, ring, kind, entry]
    n: torch.Tensor       # (T,) int32 total events fired (may exceed cap)
    counts: torch.Tensor  # (T, len(EVENT_KINDS)) int32 per-kind totals


def trace_buffer(n_trials: int, cap: int, device=None) -> TraceBuffer:
    """An empty recorder for ``n_trials`` trials of ring capacity ``cap``,
    on ``device`` (CUDA unless named)."""
    if cap < 1:
        raise ValueError(f"trace capacity must be >= 1, got {cap}")
    from ..core.sampling import resolve_device  # local: core.sampling imports obs.phase

    kw = dict(dtype=torch.int32, device=resolve_device(device))
    return TraceBuffer(
        ev=torch.full((n_trials, cap, 4), -1, **kw),
        n=torch.zeros((n_trials,), **kw),
        counts=torch.zeros((n_trials, len(EVENT_KINDS)), **kw),
    )


def clone_trace(buf: TraceBuffer) -> TraceBuffer:
    return TraceBuffer(*(x.clone() for x in buf))


def trace_append(buf: TraceBuffer, fire, rnd, ring, kind: int, entry) -> TraceBuffer:
    """Conditionally append one event per trial, in place; returns ``buf``.

    fire:  (T,) bool, trials that record this event;
    rnd:   int or (T,) round index;
    ring:  int or (T,) acting ring (-1 for trial-level events);
    kind:  an EV_* code;
    entry: int or (T,) table-entry payload.

    A trial that does not fire rewrites its slot at the head with its own
    value, so every row is written once and rows never collide.
    """
    t, cap, _ = buf.ev.shape
    dev = buf.ev.device
    rows = torch.arange(t, device=dev)
    rec = torch.empty((t, 4), dtype=torch.int32, device=dev)
    rec[:, 0] = rnd
    rec[:, 1] = ring
    rec[:, 2] = kind
    rec[:, 3] = entry
    idx = (buf.n % cap).long()
    buf.ev[rows, idx] = torch.where(fire[:, None], rec, buf.ev[rows, idx])
    fired = fire.to(torch.int32)
    buf.n.add_(fired)
    buf.counts[:, kind] += fired
    return buf


def merge_traces(select: torch.Tensor, a: TraceBuffer, b: TraceBuffer) -> TraceBuffer:
    """Per-trial select: trial i takes ``a``'s trace where ``select[i]``.

    The warm/cold escalation of ``core.temporal.protocol_relock`` merges
    states with exactly this pattern; the recorder follows its state.
    """
    return TraceBuffer(*(
        torch.where(select.reshape((-1,) + (1,) * (y.dim() - 1)), x, y)
        for x, y in zip(a, b)
    ))


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def trace_events(buf: TraceBuffer, trial: int | None = None):
    """Host-side decode: per-trial event arrays, oldest -> newest.

    Returns a list of (k, 4) int32 numpy arrays (columns = EVENT_FIELDS),
    or a single array when ``trial`` is given.  Wrapped rings are unrolled
    so row order is chronological; overwritten events are gone (``n`` vs
    ``cap`` tells how many).
    """
    ev = _host(buf.ev)
    n = _host(buf.n)
    cap = ev.shape[1]

    def one(i: int) -> np.ndarray:
        k = int(n[i])
        if k <= cap:
            return ev[i, :k]
        head = k % cap  # oldest surviving event sits at the write head
        return np.concatenate([ev[i, head:], ev[i, :head]], axis=0)

    if trial is not None:
        return one(int(trial))
    return [one(i) for i in range(ev.shape[0])]


def trace_summary(buf: TraceBuffer) -> dict:
    """Aggregate host-side view of a recorder (manifest/report payload)."""
    n = _host(buf.n)
    counts = _host(buf.counts)
    cap = int(buf.ev.shape[1])
    return {
        "trials": int(n.shape[0]),
        "capacity": cap,
        "events_total": int(n.sum()),
        "events_max_trial": int(n.max()) if n.size else 0,
        "overflowed_trials": int((n > cap).sum()),
        "by_kind": {
            kind: int(counts[:, i].sum())
            for i, kind in enumerate(EVENT_KINDS)
        },
    }


def format_events(events: np.ndarray, limit: int | None = None) -> str:
    """Render one trial's decoded events as aligned text lines."""
    rows = events if limit is None else events[-limit:]
    lines = []
    for rnd, ring, kind, entry in np.asarray(rows):
        name = EVENT_KINDS[int(kind)] if 0 <= kind < len(EVENT_KINDS) else "?"
        lines.append(
            f"  round {int(rnd):3d}  ring {int(ring):3d}  "
            f"{name:<9s} entry {int(entry)}"
        )
    if limit is not None and len(events) > limit:
        lines.insert(0, f"  ... ({len(events) - limit} earlier events)")
    return "\n".join(lines)

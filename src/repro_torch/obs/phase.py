"""Phase telemetry: timing spans, counters and device-memory watermarks.

A ``PhaseRecorder`` collects named ``Span``s (segments tagged ``host`` or
``execute``), counters and free-form notes (chunk plans, memory watermarks
against the sweep engine's chunk budget).  It is installed per scope through
a contextvar (``use_recorder``); the instrumented call sites use the
module-level ``span``, ``count`` and ``note``, which do nothing when none is
installed (``span`` hands back one shared ``nullcontext``), so the
uninstrumented path runs the plain code with one contextvar read a site.

Spans name the port's layer they time, ``<layer>.<what>`` (``sweep.request``,
``sampling.instantiate``, ``arbiters.tables``, ``protocol.round``, ...); a
name with no dot (``sweep``, ``bringup``: the ``measured_call`` spans) is its
own layer.  Each span holds its start and end on the clock of
``torch.profiler``'s events (``time.time_ns()``: CLOCK_REALTIME, in ns), so a
span can be laid beside the device's intervals of a profiled run; its id; the
id of the span open around it (``parent_id``, -1 for none); and the id of the
outermost open span (``root_id``), which ties every span of one request
together.

``measured_call`` times one call.  The reference splits a jitted call into
an ahead-of-time compile span and an execute span and reads the compiled
program's memory analysis; the port runs eagerly, so there is nothing to
compile and it records one ``execute`` span.  On CUDA it records a pair of
CUDA events on the current stream at the span's ends and waits for nothing:
the span's ``ms`` is the device time between them, resolved when it is
first read (``Span.ms``, ``phase_fields()``).  Under ``measure_memory`` the
call's device watermark (``torch.cuda.max_memory_allocated`` above its
start, the caching allocator's host-side accounting) is noted as
``memory.<label>.temp`` against the budget, under the reference's note name
so that the report renders it unchanged.  A call on the CPU records no
watermark.
"""
from __future__ import annotations

import contextlib
import contextvars
import time
from dataclasses import dataclass, field
from typing import Any

import torch

__all__ = [
    "PhaseRecorder",
    "Span",
    "count",
    "current_recorder",
    "measured_call",
    "note",
    "span",
    "use_recorder",
]


@dataclass(eq=False, slots=True)
class Span:
    """One timed segment: ``kind`` is ``host`` or ``execute``.  ``start_ns``
    and ``end_ns`` are ``time.time_ns()`` stamps (``end_ns`` is -1 while the
    span is open); ``ms`` is the host time between them, or for a CUDA
    ``measured_call`` the device time between its events."""

    name: str
    kind: str
    span_id: int
    parent_id: int
    root_id: int
    start_ns: int
    end_ns: int = -1
    extra: dict = field(default_factory=dict)
    _ms: float | None = field(default=None, repr=False)
    _events: tuple | None = field(default=None, repr=False)

    @property
    def ms(self) -> float:
        if self._events is not None:
            start, end = self._events
            end.synchronize()
            self._ms, self._events = float(start.elapsed_time(end)), None
        if self._ms is None:
            return (self.end_ns - self.start_ns) / 1e6
        return self._ms


class _Opened:
    """The context manager of one recorder span (a class, not a generator:
    it is entered at every layer boundary of a traced run)."""

    __slots__ = ("rec", "name", "kind", "extra", "span")

    def __init__(self, rec: "PhaseRecorder", name: str, kind: str, extra: dict):
        self.rec, self.name, self.kind, self.extra = rec, name, kind, extra

    def __enter__(self) -> Span:
        rec = self.rec
        outer = rec._open[-1] if rec._open else None
        sid = rec._next_id
        rec._next_id += 1
        self.span = s = Span(self.name, self.kind, sid,
                             -1 if outer is None else outer.span_id,
                             sid if outer is None else outer.root_id,
                             time.time_ns(), extra=self.extra)
        rec._open.append(s)
        return s

    def __exit__(self, *exc) -> bool:
        s = self.span
        s.end_ns = time.time_ns()
        self.rec._open.pop()
        self.rec.spans.append(s)
        return False


class PhaseRecorder:
    """Collects spans, counters and notes for one run scope (a smoke run, a
    test, a benchmark's traced window).  Not thread-safe; one recorder per
    scope.  ``spans`` are appended as they close, inner before outer.

    measure_memory: have ``measured_call`` record each CUDA call's device
    watermark (it resets the device's peak-memory statistics, so a caller
    that reads them itself keeps it off).
    """

    def __init__(self, *, measure_memory: bool = False):
        self.spans: list[Span] = []
        self.notes: list[dict] = []
        self.counters: dict[str, int] = {}
        self.measure_memory = bool(measure_memory)
        self._open: list[Span] = []
        self._next_id = 0

    # -- spans and counters -----------------------------------------------
    def span(self, name: str, kind: str = "host", **extra) -> _Opened:
        return _Opened(self, name, kind, extra)

    def count(self, name: str, n: int = 1):
        self.counters[name] = self.counters.get(name, 0) + int(n)

    # -- notes ------------------------------------------------------------
    def note(self, name: str, **fields):
        self.notes.append({"name": name, **fields})

    def memory(self, name: str, nbytes: int, budget: int | None = None):
        """Record a memory watermark, optionally against a budget."""
        rec: dict[str, Any] = {"bytes": int(nbytes)}
        if budget:
            rec["budget"] = int(budget)
            rec["frac"] = float(nbytes) / float(budget)
        self.note(f"memory.{name}", **rec)

    # -- aggregation ------------------------------------------------------
    def phase_fields(self) -> dict[str, dict]:
        """Aggregate spans by name -> {kind, ms, count} (stable keys,
        summed durations)."""
        out: dict[str, dict] = {}
        for s in self.spans:
            slot = out.setdefault(s.name, {"kind": s.kind, "ms": 0.0, "count": 0})
            slot["ms"] += s.ms
            slot["count"] += 1
        for slot in out.values():
            slot["ms"] = round(slot["ms"], 3)
        return out

    def memory_fields(self) -> list[dict]:
        return [n for n in self.notes if n["name"].startswith("memory.")]


_CURRENT: contextvars.ContextVar[PhaseRecorder | None] = contextvars.ContextVar(
    "repro_torch_obs_phase_recorder", default=None
)

#: What ``span`` hands back with no recorder installed (it holds no state,
#: so one instance serves every site, nested or not).
_NULL = contextlib.nullcontext()


def current_recorder() -> PhaseRecorder | None:
    return _CURRENT.get()


@contextlib.contextmanager
def use_recorder(rec: PhaseRecorder):
    tok = _CURRENT.set(rec)
    try:
        yield rec
    finally:
        _CURRENT.reset(tok)


def span(name: str, kind: str = "host", **extra):
    """Module-level span: records into the installed recorder, or no-ops."""
    rec = _CURRENT.get()
    return _NULL if rec is None else _Opened(rec, name, kind, extra)


def count(name: str, n: int = 1):
    """Module-level counter: adds ``n`` in the installed recorder, or no-ops."""
    rec = _CURRENT.get()
    if rec is not None:
        rec.count(name, n)


def note(name: str, **fields):
    """Module-level note: records into the installed recorder, or no-ops."""
    rec = _CURRENT.get()
    if rec is not None:
        rec.note(name, **fields)


def _first_tensor(tree):
    """The first tensor of a (named, nested) tuple or list, or None."""
    if isinstance(tree, torch.Tensor):
        return tree
    if isinstance(tree, (tuple, list)):
        for leaf in tree:
            found = _first_tensor(leaf)
            if found is not None:
                return found
    return None


def measured_call(label: str, fn, args: tuple, kwargs: dict, *,
                  budget: int | None = None):
    """Call ``fn(*args, **kwargs)`` under an ``execute`` span named ``label``.

    Without an installed recorder this is exactly ``fn(*args, **kwargs)``.
    With one, when CUDA is initialised a timing event is recorded on the
    current stream before the call, and when the result (a tensor or a tuple
    of them) is on that device another after it; the span's ``ms`` is the
    device time between them, waited for only when it is read.  The call
    itself waits for nothing it would not wait for bare.  Under
    ``measure_memory`` a CUDA result adds the watermark note
    ``memory.<label>.temp``: ``max_memory_allocated`` above the allocation
    at the start, against ``budget``.  A result on the CPU records no
    watermark (the CPU allocator keeps no peak statistics) and its span's
    ``ms`` is host time.
    """
    rec = _CURRENT.get()
    if rec is None:
        return fn(*args, **kwargs)
    start = None
    base = 0
    if torch.cuda.is_initialized():
        if rec.measure_memory:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
        device = torch.cuda.current_device()
        start = torch.cuda.Event(enable_timing=True)
    with rec.span(label, kind="execute") as s:
        if start is not None:
            start.record()
        out = fn(*args, **kwargs)
        leaf = _first_tensor(out)
        on_cuda = leaf is not None and leaf.device.type == "cuda"
        if on_cuda and start is not None and leaf.device.index == device:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(leaf.device))
            s._events = (start, end)
    if on_cuda and rec.measure_memory:
        rec.memory(f"{label}.temp", torch.cuda.max_memory_allocated(leaf.device) - base,
                   budget=budget)
    return out

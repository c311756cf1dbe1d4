"""Phase telemetry: timing spans and device-memory watermarks.

A ``PhaseRecorder`` collects named ``Span``s (wall-clock segments tagged
``host`` or ``execute``) and free-form notes (chunk plans, memory
watermarks against the sweep engine's chunk budget).  It is installed per
scope through a contextvar (``use_recorder``); the instrumented call sites,
``core.sweep`` and ``fabric.bringup``, look it up with ``current_recorder()``
and do nothing when none is installed, so the uninstrumented path stays a
plain function call with no behaviour change.

``measured_call`` times one call.  The reference splits a jitted call into
an ahead-of-time compile span and an execute span and reads the compiled
program's memory analysis; the port runs eagerly, so there is nothing to
compile and it records one ``execute`` span.  On CUDA the span is
synchronised on both ends, and under ``measure_memory`` the call's device
watermark (``torch.cuda.max_memory_allocated`` above its start) is noted as
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
    "current_recorder",
    "measured_call",
    "note",
    "span",
    "use_recorder",
]


@dataclass
class Span:
    """One timed segment: ``kind`` is ``host`` or ``execute``."""

    name: str
    kind: str
    ms: float
    extra: dict = field(default_factory=dict)


class PhaseRecorder:
    """Collects spans and notes for one run scope (a smoke run, a test).
    Not thread-safe; one recorder per scope.

    measure_memory: have ``measured_call`` record each CUDA call's device
    watermark (it resets the device's peak-memory statistics, so a caller
    that reads them itself keeps it off).
    """

    def __init__(self, *, measure_memory: bool = False):
        self.spans: list[Span] = []
        self.notes: list[dict] = []
        self.measure_memory = bool(measure_memory)
        self._open: list[str] = []

    # -- spans ------------------------------------------------------------
    @contextlib.contextmanager
    def span(self, name: str, kind: str = "host", **extra):
        self._open.append(name)
        t0 = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - t0) * 1e3
            self._open.pop()
            self.spans.append(Span(name=name, kind=kind, ms=ms, extra=extra))

    @property
    def current(self) -> str | None:
        """Innermost open span name (what was executing right now)."""
        return self._open[-1] if self._open else None

    def current_path(self) -> str | None:
        """Full open-span stack as ``outer/inner`` (None when idle)."""
        return "/".join(self._open) if self._open else None

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


def current_recorder() -> PhaseRecorder | None:
    return _CURRENT.get()


@contextlib.contextmanager
def use_recorder(rec: PhaseRecorder):
    tok = _CURRENT.set(rec)
    try:
        yield rec
    finally:
        _CURRENT.reset(tok)


@contextlib.contextmanager
def span(name: str, kind: str = "host", **extra):
    """Module-level span: records into the installed recorder, or no-ops."""
    rec = _CURRENT.get()
    if rec is None:
        yield
    else:
        with rec.span(name, kind, **extra):
            yield


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
    With one, CUDA work queued before the call is waited for when CUDA is
    initialised, and the call is waited for after it when its result (a
    tensor or a tuple of them) is on CUDA, so the span holds the device
    time.  Under ``measure_memory`` a CUDA result adds the watermark note
    ``memory.<label>.temp``: ``max_memory_allocated`` above the allocation
    at the start, against ``budget``.  A result on the CPU records no
    watermark (the CPU allocator keeps no peak statistics).
    """
    rec = _CURRENT.get()
    if rec is None:
        return fn(*args, **kwargs)
    base = 0
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
        if rec.measure_memory:
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
    with rec.span(label, kind="execute"):
        out = fn(*args, **kwargs)
        leaf = _first_tensor(out)
        on_cuda = leaf is not None and leaf.device.type == "cuda"
        if on_cuda:
            torch.cuda.synchronize(leaf.device)
    if on_cuda and rec.measure_memory:
        rec.memory(f"{label}.temp", torch.cuda.max_memory_allocated(leaf.device) - base,
                   budget=budget)
    return out

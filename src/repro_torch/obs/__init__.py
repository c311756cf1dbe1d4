"""Observability layer: flight recorder, phase telemetry, health matrix.

Three instruments threaded through the stack, all off by default, with the
disabled paths running exactly the uninstrumented code:

- ``repro_torch.obs.trace``    per-trial protocol event rings
                               (``run_protocol(trace=)``)
- ``repro_torch.obs.phase``    timing spans, counters + device-memory
                               watermarks (contextvar recorder picked up
                               at the port's layer boundaries)
- ``repro_torch.obs.health``   per-step x per-link chaos health codes
                               (``run_fabric_timeline(health=True)``)
- ``repro_torch.obs.taxonomy`` post-hoc failure classifier over traces
- ``repro_torch.obs.manifest`` JSONL run-manifest writer
- ``repro_torch.obs.report``   terminal report CLI
                               (``python -m repro_torch.obs.report``)

``trace``/``phase``/``health`` are dependency-light and re-exported eagerly;
``taxonomy``/``manifest``/``report`` load lazily (taxonomy imports
``repro_torch.core``, whose protocol engine imports this package).
"""
from __future__ import annotations

from .health import HEALTH_CODES, health_codes, health_matrix_summary
from .phase import (
    PhaseRecorder,
    Span,
    count,
    current_recorder,
    measured_call,
    note,
    span,
    use_recorder,
)
from .trace import (
    EVENT_FIELDS,
    EVENT_KINDS,
    TraceBuffer,
    format_events,
    merge_traces,
    trace_append,
    trace_buffer,
    trace_events,
    trace_summary,
)

_LAZY = {
    "classify_trials": "repro_torch.obs.taxonomy",
    "explain_residuals": "repro_torch.obs.taxonomy",
    "TAXONOMY": "repro_torch.obs.taxonomy",
    "RunManifest": "repro_torch.obs.manifest",
    "latest_manifest": "repro_torch.obs.manifest",
    "read_manifest": "repro_torch.obs.manifest",
    "render_report": "repro_torch.obs.report",
}


def __getattr__(name: str):
    mod = _LAZY.get(name)
    if mod is None:
        raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
    import importlib

    return getattr(importlib.import_module(mod), name)


__all__ = [
    "EVENT_FIELDS",
    "EVENT_KINDS",
    "HEALTH_CODES",
    "PhaseRecorder",
    "Span",
    "TraceBuffer",
    "count",
    "current_recorder",
    "format_events",
    "health_codes",
    "health_matrix_summary",
    "measured_call",
    "merge_traces",
    "note",
    "span",
    "trace_append",
    "trace_buffer",
    "trace_events",
    "trace_summary",
    "use_recorder",
    *sorted(_LAZY),
]

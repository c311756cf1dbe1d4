"""JSONL run manifests: one append-only file per instrumented run.

A ``RunManifest`` is the durable side of the obs layer: every line is one
self-describing JSON record ``{"kind": ..., "ts": ..., **fields}``, flushed
as written so a killed run still leaves everything up to the interruption
on disk.  Kinds in use:

  meta           run header (argv, label, free-form fields)
  phases         a ``PhaseRecorder`` dump: spans, notes, aggregates
  trace          a flight-recorder summary (+ optional taxonomy histogram)
  health         a chaos health-matrix summary
  bench_record   one benchmark JSON record (fig name + derived fields)

``python -m repro_torch.obs.report`` renders the newest manifest (or a given
path) as a terminal report.  Manifests default into ``.obs/`` under the
working directory (git-ignored at the repo root).
"""
from __future__ import annotations

import json
import os
import time
from typing import Any, Iterator

__all__ = ["RunManifest", "latest_manifest", "read_manifest", "DEFAULT_DIR"]

DEFAULT_DIR = ".obs"


def _jsonable(v):
    """numpy scalars and arrays and torch tensors (on any device) as plain
    numbers and lists; anything else as its ``str``."""
    tolist = getattr(v, "tolist", None)
    if callable(tolist):
        return tolist()
    return str(v)


class RunManifest:
    """Append-only JSONL writer for one run."""

    def __init__(self, path: str, *, label: str = "", **meta):
        self.path = path
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._fh = open(path, "a")
        self.write("meta", label=label, pid=os.getpid(), **meta)

    @classmethod
    def create(cls, directory: str = DEFAULT_DIR, *, label: str = "run",
               **meta) -> "RunManifest":
        """A fresh timestamped manifest under ``directory``."""
        stamp = time.strftime("%Y%m%d-%H%M%S")
        path = os.path.join(directory, f"{stamp}-{label}-{os.getpid()}.jsonl")
        return cls(path, label=label, **meta)

    # -- core -------------------------------------------------------------
    def write(self, kind: str, **fields) -> None:
        rec = {"kind": kind, "ts": round(time.time(), 3), **fields}
        self._fh.write(json.dumps(rec, default=_jsonable) + "\n")
        self._fh.flush()

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.close()

    def __enter__(self) -> "RunManifest":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    # -- typed helpers ----------------------------------------------------
    def record_phases(self, recorder, *, scope: str = "") -> None:
        """Dump a ``repro_torch.obs.phase.PhaseRecorder``."""
        self.write(
            "phases", scope=scope,
            spans=[{"name": s.name, "kind": s.kind, "ms": round(s.ms, 3),
                    **({"extra": s.extra} if s.extra else {})}
                   for s in recorder.spans],
            notes=recorder.notes,
            by_phase=recorder.phase_fields(),
        )

    def record_trace(self, buf, *, scope: str = "", taxonomy=None) -> None:
        """Dump a flight-recorder summary (+ optional taxonomy result)."""
        from repro_torch.obs.trace import trace_summary

        fields: dict[str, Any] = {"summary": trace_summary(buf)}
        if taxonomy is not None:
            fields["taxonomy"] = taxonomy
        self.write("trace", scope=scope, **fields)

    def record_health(self, health, *, scope: str = "") -> None:
        """Dump a chaos health matrix ((S, K) tensor or array): summary +
        the full codes."""
        from repro_torch.obs.health import health_matrix_summary

        self.write(
            "health", scope=scope,
            summary=health_matrix_summary(health),
            codes=health.tolist(),
        )

    def record_bench(self, record: dict) -> None:
        """Mirror one benchmark JSON record into the manifest."""
        self.write("bench_record", record=record)


def latest_manifest(directory: str = DEFAULT_DIR) -> str | None:
    """Newest ``*.jsonl`` under ``directory`` (None when empty/missing)."""
    try:
        names = [n for n in os.listdir(directory) if n.endswith(".jsonl")]
    except FileNotFoundError:
        return None
    if not names:
        return None
    paths = [os.path.join(directory, n) for n in names]
    return max(paths, key=os.path.getmtime)


def read_manifest(path: str) -> Iterator[dict]:
    """Yield the records of a manifest (corrupt tail lines are skipped —
    a SIGKILL mid-write must not take the readable prefix with it)."""
    with open(path) as fh:
        for line in fh:
            line = line.strip()
            if not line:
                continue
            try:
                yield json.loads(line)
            except json.JSONDecodeError:
                continue

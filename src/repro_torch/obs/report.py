"""Terminal report over a run manifest: ``python -m repro_torch.obs.report``.

Renders the newest manifest in ``.obs/`` (or an explicit path) as plain
text: run header, per-phase timing breakdown, memory watermarks vs the
chunk budget, flight-recorder summaries with taxonomy histograms, ASCII
chaos health timelines, and the BENCH record trajectory.  Reads only the
manifest file: it runs on any host, with or without a card.
"""
from __future__ import annotations

import sys

from repro_torch.obs.health import HEALTH_CODES, HEALTH_GLYPHS
from repro_torch.obs.manifest import DEFAULT_DIR, latest_manifest, read_manifest

__all__ = ["render_report", "main"]


def _fmt_bytes(n: float) -> str:
    for unit in ("B", "KiB", "MiB", "GiB"):
        if abs(n) < 1024 or unit == "GiB":
            return f"{n:.1f} {unit}" if unit != "B" else f"{int(n)} B"
        n /= 1024
    return f"{n:.1f} GiB"


def _phase_section(rec: dict, out: list) -> None:
    scope = rec.get("scope") or "(run)"
    by_phase = rec.get("by_phase") or {}
    if by_phase:
        out.append(f"  phases [{scope}]")
        width = max(len(n) for n in by_phase)
        for name, slot in sorted(
            by_phase.items(), key=lambda kv: -kv[1]["ms"]
        ):
            out.append(
                f"    {name:<{width}}  {slot['ms']:>10.1f} ms"
                f"  {slot['kind']:<8}x{slot['count']}"
            )
    for note in rec.get("notes") or []:
        name = note.get("name", "")
        if name.startswith("memory."):
            line = f"    {name[7:]:<24} {_fmt_bytes(note.get('bytes', 0)):>12}"
            if "budget" in note:
                line += (f"  ({100 * note.get('frac', 0.0):.1f}% of "
                         f"{_fmt_bytes(note['budget'])} budget)")
            out.append(line)
        elif name.endswith(".plan") or name.startswith("chunked_map."):
            kv = ", ".join(f"{k}={v}" for k, v in note.items() if k != "name")
            out.append(f"    {name}: {kv}")


def _trace_section(rec: dict, out: list) -> None:
    scope = rec.get("scope") or "(run)"
    s = rec.get("summary") or {}
    out.append(
        f"  trace [{scope}]: {s.get('events_total', 0)} events over "
        f"{s.get('trials', 0)} trials (cap {s.get('capacity', 0)}, "
        f"{s.get('overflowed_trials', 0)} overflowed)"
    )
    by_kind = s.get("by_kind") or {}
    if by_kind:
        out.append("    " + "  ".join(
            f"{k}:{v}" for k, v in by_kind.items() if v
        ))
    tax = rec.get("taxonomy")
    if tax:
        hist = tax.get("histogram") or {}
        out.append(
            f"    taxonomy[{tax.get('scheme', '?')}]: "
            f"{tax.get('residual_total', 0)} residuals -> "
            + (", ".join(f"{k}={v}" for k, v in hist.items()) or "none")
            + f"  (unknown={tax.get('unknown', 0)})"
        )


def _health_section(rec: dict, out: list) -> None:
    scope = rec.get("scope") or "(run)"
    s = rec.get("summary") or {}
    out.append(
        f"  health [{scope}]: {s.get('steps', 0)} steps x "
        f"{s.get('links', 0)} links, "
        f"{100 * s.get('healthy_frac', 1.0):.1f}% healthy "
        f"(worst step {s.get('worst_step', 0)})"
    )
    codes = rec.get("codes")
    if codes:
        legend = "  ".join(
            f"{HEALTH_GLYPHS[i]}={name}" for i, name in enumerate(HEALTH_CODES)
        )
        out.append(f"    links ->   [{legend}]")
        for step, row in enumerate(codes):
            line = "".join(
                HEALTH_GLYPHS[c] if 0 <= c < len(HEALTH_GLYPHS) else "?"
                for c in row
            )
            out.append(f"    step {step:3d}  {line}")


def _bench_section(recs: list, out: list) -> None:
    out.append(f"  bench trajectory ({len(recs)} records)")
    for rec in recs:
        r = rec.get("record") or {}
        name = r.get("name") or r.get("figure") or "?"
        wall = r.get("module_wall_ms")
        bits = [f"    {name:<28}"]
        if wall is not None:
            bits.append(f"{float(wall):>10.1f} ms")
        derived = r.get("derived") or {}
        if derived.get("timeout"):
            phase = derived.get("phase")
            bits.append("  TIMEOUT" + (f" in {phase}" if phase else ""))
        out.append("".join(bits))


def render_report(path: str) -> str:
    """The manifest at ``path`` as a terminal-ready report string."""
    out: list[str] = []
    bench: list[dict] = []
    n_records = 0
    for rec in read_manifest(path):
        n_records += 1
        kind = rec.get("kind")
        if kind == "meta":
            label = rec.get("label", "")
            out.append(f"== run manifest: {label or path} ==")
            extras = {
                k: v for k, v in rec.items()
                if k not in ("kind", "ts", "label", "pid")
            }
            if extras:
                out.append(
                    "  " + ", ".join(f"{k}={v}" for k, v in extras.items())
                )
        elif kind == "phases":
            _phase_section(rec, out)
        elif kind == "trace":
            _trace_section(rec, out)
        elif kind == "health":
            _health_section(rec, out)
        elif kind == "bench_record":
            bench.append(rec)
    if bench:
        _bench_section(bench, out)
    if not out:
        out.append(f"(empty manifest: {path})")
    out.append(f"-- {n_records} records: {path}")
    return "\n".join(out)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv and argv[0] in ("-h", "--help"):
        print("usage: python -m repro_torch.obs.report [manifest.jsonl | dir]")
        return 0
    target = argv[0] if argv else DEFAULT_DIR
    import os

    path = (latest_manifest(target) if os.path.isdir(target) or not argv
            else target)
    if path is None:
        print(f"no manifests under {target!r}", file=sys.stderr)
        return 1
    print(render_report(path))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""End-to-end obs smoke: ``python -m repro_torch.obs.smoke [--device cpu]``.

One tiny WDM8 pass through every instrument, on the card unless
``--device`` names another: a trace-enabled protocol run with taxonomy, a
recorded sweep (phase spans, chunk plan and, on CUDA, the device-memory
watermark), a chaos timeline with the health matrix, all written to a run
manifest and rendered back through ``repro_torch.obs.report``.  Exits
nonzero if any instrument changes an arbitration outcome or the render
lacks a section.
"""
from __future__ import annotations

import argparse
import sys
import tempfile

import numpy as np
import torch


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default=None,
                        help="device to run on (default: CUDA, which must be present)")
    args = parser.parse_args(argv)

    from ..configs.fabric import FABRIC_TINY
    from ..configs.wdm import WDM8_G200
    from ..core.api import make_units
    from ..core.protocol import default_rounds, run_protocol
    from ..core.relation import chain_spec
    from ..core.sampling import instantiate, resolve_device
    from ..core.search_table import build_search_tables
    from ..core.sweep import SweepRequest, sweep
    from ..fabric import make_fabric_timeline, make_fabric_units, run_fabric_timeline
    from .manifest import RunManifest
    from .phase import PhaseRecorder, use_recorder
    from .report import render_report
    from .taxonomy import classify_trials, taxonomy_histogram
    from .trace import trace_summary

    dev = resolve_device(args.device)
    cfg = WDM8_G200
    n = cfg.grid.n_ch
    with tempfile.TemporaryDirectory() as tmp:
        manifest = RunManifest.create(tmp, label="obs-smoke", device=str(dev))
        with manifest:
            # 1) trace-enabled protocol run + invariance + taxonomy
            units = make_units(cfg, seed=7, n_laser=4, n_ring=6, device=dev)
            tables = build_search_tables(instantiate(cfg, units), 3.2,
                                         max_alias=cfg.max_fsr_alias)
            spec = chain_spec(cfg.s)
            _, stats0 = run_protocol(tables, spec, with_stats=True)
            _, stats1, state, buf = run_protocol(
                tables, spec, with_stats=True, with_state=True, trace=64)
            if not all(torch.equal(a, b) for a, b in zip(stats0, stats1)):
                print("FAIL: tracing changed the protocol stats", file=sys.stderr)
                return 1
            codes = classify_trials(state.lock, tables.n_valid, buf.counts, stats1.worked,
                                    rounds=default_rounds(n))
            hist = taxonomy_histogram(codes)
            manifest.record_trace(
                buf, scope="wdm8-protocol",
                taxonomy={"scheme": "protocol_lta",
                          "residual_total": int((codes != 5).sum()),
                          "histogram": hist, "unknown": hist["unknown"]},
            )
            summ = trace_summary(buf)

            # 2) recorded sweep: spans + chunk plan (+ memory watermark on CUDA)
            req = SweepRequest(cfg=cfg, units=units, scheme="seq_retry",
                               axes={"tr_mean": np.linspace(1.0, 6.0, 4, dtype=np.float32)})
            rec = PhaseRecorder(measure_memory=True)
            with use_recorder(rec):
                res = sweep(req)
            bare = sweep(req)
            if not torch.equal(res.data.cafp, bare.data.cafp):
                print("FAIL: recorder changed sweep grid", file=sys.stderr)
                return 1
            if not rec.spans:
                print("FAIL: recorded sweep produced no spans", file=sys.stderr)
                return 1
            manifest.record_phases(rec, scope="wdm8-sweep")

            # 3) chaos health matrix
            funits = make_fabric_units(cfg, FABRIC_TINY, 0, dev)
            tl = make_fabric_timeline(FABRIC_TINY, 3, n, thermal=0.15,
                                      events=[(1, "link_kill", 0)], device=dev)
            _, cs = run_fabric_timeline(cfg, funits, FABRIC_TINY, tl, health=True)
            manifest.record_health(cs.health, scope="fabric-tiny")

        report = render_report(manifest.path)
        print(report)
        ok = ("trace [wdm8-protocol]" in report
              and "phases [wdm8-sweep]" in report
              and "health [fabric-tiny]" in report)
        if not ok:
            print("FAIL: report missing a section", file=sys.stderr)
            return 1
        print(f"obs smoke OK on {dev}: {summ['events_total']} events, "
              f"{len(rec.spans)} spans, {len(rec.memory_fields())} memory notes, "
              f"{tuple(cs.health.shape)} health matrix")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())

"""Post-hoc failure taxonomy over flight-recorder traces.

``classify_trials`` turns one ``run_protocol`` outcome (final lock state,
table occupancy, per-kind event counts, honest round counts) into a
per-trial failure code.  The vocabulary mirrors how arbitration dies
(fig19's mid-TR residuals, fig22's unhealed links):

  starvation   a ring ran out of visible lines and nothing it could do
               (no displacement activity) would have freed one
  storm        heavy displacement/surrender churn: lines exist but the
               oblivious controllers keep stealing them from each other
  livelock     the engine sticky-halted early (fixed point or plateau)
               while displacement was active: the hole walks a cycle
  hopeless     the trial was never winnable: the live bus admits no
               complete matching (or every starved ring's table is empty)
  locked       not a failure: the trial completed

Precedence (hopeless > livelock > storm > starvation) makes the classes
exhaustive and mutually exclusive: every trial gets exactly one code and
``unknown`` cannot occur by construction.

``explain_residuals`` is fig19's classifier: per TR point it finds the trials
a one-shot scheme (default ``seq_retry``) loses but the ideal arbiter wins,
re-runs the tables through the traced protocol engine at the scheme's
displacement depth, and classifies every residual from the trace alone.
The device of ``units`` selects the path (the CUDA kernels, or their plain
versions on the CPU).
"""
from __future__ import annotations

import numpy as np
import torch

from .trace import EV_DISPLACE, EV_SURRENDER

ST_STARVATION = 0
ST_STORM = 1
ST_LIVELOCK = 2
ST_HOPELESS = 3
ST_UNKNOWN = 4  # reserved: classify_trials never emits it
ST_LOCKED = 5

#: code -> label; order is the integer encoding.
TAXONOMY = ("starvation", "storm", "livelock", "hopeless", "unknown",
            "locked")

__all__ = [
    "ST_STARVATION", "ST_STORM", "ST_LIVELOCK", "ST_HOPELESS",
    "ST_UNKNOWN", "ST_LOCKED", "TAXONOMY",
    "classify_trials", "taxonomy_histogram", "explain_residuals",
]


def classify_trials(lock, n_valid, counts, worked, *, rounds: int,
                    feasible=None, storm_factor: int = 2) -> torch.Tensor:
    """Per-trial int8 failure codes, on the device of ``lock``.

    lock:     (T, N) final lock state (< 0 = starved)
    n_valid:  (T, N) search-table occupancy
    counts:   (T, len(EVENT_KINDS)) per-kind totals from a ``TraceBuffer``
              (wraparound-immune, so long trials classify exactly)
    worked:   (T,) honest executed-round count (``ProtocolStats.worked``)
    rounds:   the round bound the run used
    feasible: optional (T,) bool ideal feasibility; when given it defines
              ``hopeless`` exactly, otherwise the all-tables-empty proxy is
              used (sound: an empty-table starved ring can never lock)
    storm_factor: displacement activity >= factor * N reads as a storm
    """
    lock = torch.as_tensor(lock)
    dev = lock.device
    n = lock.shape[1]
    complete = (lock >= 0).all(dim=1)
    starved_dead = (lock < 0) & (torch.as_tensor(n_valid, device=dev) <= 0)
    dead_end = torch.where(lock < 0, starved_dead, True).all(dim=1)
    hopeless = dead_end if feasible is None else ~torch.as_tensor(feasible, device=dev)
    counts = torch.as_tensor(counts, device=dev)
    activity = counts[:, EV_DISPLACE] + counts[:, EV_SURRENDER]
    early = torch.as_tensor(worked, device=dev) < rounds
    code = torch.where(activity >= storm_factor * n, ST_STORM, ST_STARVATION).to(torch.int8)
    code = torch.where(early & (activity > 0), ST_LIVELOCK, code)
    code = torch.where(hopeless, ST_HOPELESS, code)
    return torch.where(complete, ST_LOCKED, code)


def taxonomy_histogram(codes) -> dict:
    """Host-side {label: count} over a code array (manifest payload)."""
    c = codes.detach().cpu().numpy() if isinstance(codes, torch.Tensor) else np.asarray(codes)
    return {label: int((c == i).sum()) for i, label in enumerate(TAXONOMY)}


def explain_residuals(
    cfg,
    units,
    tr_values,
    *,
    scheme: str = "seq_retry",
    policy: str = "lta",
    depth: int = 1,
    n_rounds: int | None = None,
    trace_cap: int = 128,
    storm_factor: int = 2,
) -> dict:
    """Classify every residual trial of a one-shot scheme from traces alone.

    Per TR point: run ``scheme`` and the ideal ``policy`` arbiter; a
    residual trial is one the scheme loses while the ideal wins (the fig19
    CAFP numerator).  The traced protocol engine then re-arbitrates the same
    tables at displacement depth ``depth`` and every residual is classified.
    A residual the deeper engine recovers (code ``locked``) is remapped from
    its trace: displacement activity on the recovery path means the
    one-shot scheme lost a line it needed someone to surrender (``storm``);
    a quiet recovery means it stopped re-searching too early
    (``starvation``).  Either way the code set stays closed: the returned
    ``unknown`` count is structurally zero.  Returns the reference's dict.
    """
    from ..core import ideal
    from ..core.api import scheme_spec
    from ..core.outcomes import classify
    from ..core.protocol import default_rounds, run_protocol
    from ..core.relation import chain_spec
    from ..core.sampling import instantiate
    from ..core.search_table import build_search_tables
    from ..core.variations import Variations

    arbiter = scheme_spec(scheme).arbiter
    spec = chain_spec(cfg.s)
    n = cfg.grid.n_ch
    rounds = default_rounds(n) if n_rounds is None else int(n_rounds)

    points: list[dict] = []
    total = np.zeros(len(TAXONOMY), np.int64)
    for tr in np.asarray(tr_values, np.float32):
        tr = float(tr)
        sys = instantiate(cfg, units, Variations())
        tables = build_search_tables(sys, tr, max_alias=cfg.max_fsr_alias)
        scheme_ok = classify(arbiter(cfg, tables, spec), cfg.s, policy=policy).success
        ideal_ok = ideal.success(sys, policy, cfg.s, tr)
        residual = (~scheme_ok & ideal_ok).cpu().numpy()

        _, stats, state, buf = run_protocol(
            tables, spec, depth=depth, n_rounds=rounds, with_stats=True,
            with_state=True, trace=trace_cap,
        )
        codes = classify_trials(
            state.lock, tables.n_valid, buf.counts, stats.worked,
            rounds=rounds, feasible=ideal_ok, storm_factor=storm_factor,
        ).cpu().numpy()
        activity = (buf.counts[:, EV_DISPLACE] + buf.counts[:, EV_SURRENDER]).cpu().numpy()
        recovered = residual & (codes == ST_LOCKED)
        codes = np.where(
            recovered & (activity > 0), ST_STORM,
            np.where(recovered, ST_STARVATION, codes),
        ).astype(np.int8)

        res_codes = codes[residual]
        hist = taxonomy_histogram(res_codes)
        for i in range(len(TAXONOMY)):
            total[i] += int((res_codes == i).sum())
        points.append({
            "tr_mean": round(tr, 4),
            "residual_trials": int(residual.sum()),
            "codes": res_codes.tolist(),
            "trial_index": np.nonzero(residual)[0].tolist(),
            "histogram": {k: v for k, v in hist.items() if v},
        })

    histogram = {label: int(total[i]) for i, label in enumerate(TAXONOMY)}
    return {
        "scheme": scheme,
        "policy": policy,
        "depth": depth,
        "rounds": rounds,
        "trace_cap": trace_cap,
        "points": points,
        "residual_total": int(sum(p["residual_trials"] for p in points)),
        "histogram": {k: v for k, v in histogram.items() if v},
        "unknown": histogram["unknown"],
    }

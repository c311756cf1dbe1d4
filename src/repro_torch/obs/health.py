"""Chaos health matrix: per-step x per-link health codes for fig22 post-mortems.

``run_fabric_timeline(..., health=True)`` folds its per-step per-link
aggregates into one small int8 tensor answering "what was every link's
condition at every step?", rendered by ``repro_torch.obs.report`` as an
ASCII timeline (steps down, links across).

The code ladder is ordered worst-first so a glance finds the incident:

  0 down       link administratively dead (killed fiber/port)
  1 hopeless   alive but the live bus admits no complete matching
  2 degraded   feasible yet short of a full 2N lock set
  3 relocking  fully locked, but this step spent probes getting there
               (warm restart after a disturbance)
  4 healthy    fully locked, zero spend: carried state verbatim

Plain tensor ops on already-computed stats: enabling it never changes the
arbitration outcome.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["HEALTH_CODES", "HEALTH_GLYPHS", "health_codes",
           "health_matrix_summary"]

#: code -> name; the order is the on-tensor integer encoding (worst first).
HEALTH_CODES = ("down", "hopeless", "degraded", "relocking", "healthy")

#: code -> single char for the report's ASCII timeline.
HEALTH_GLYPHS = "x!~+#"


def health_codes(locked, probes, feasible, link_alive, n_ch: int) -> torch.Tensor:
    """Fold per-link step aggregates into int8 health codes.

    locked:     (..., K) locked rings per link (0..2N)
    probes:     (..., K) this step's incremental probe spend
    feasible:   (..., K) bool, live bus admits a complete matching
    link_alive: (..., K) bool, link administratively up
    """
    full = locked >= 2 * int(n_ch)
    code = torch.where(probes > 0, 3, 4).to(torch.int8)   # relocking/healthy
    code = torch.where(~full, 2, code)                      # degraded
    code = torch.where(~feasible, 1, code)                  # hopeless
    return torch.where(~link_alive, 0, code)                # down


def health_matrix_summary(health) -> dict:
    """Host-side aggregate of an (S, K) health tensor (manifest payload)."""
    h = health.detach().cpu().numpy() if isinstance(health, torch.Tensor) \
        else np.asarray(health)
    s, k = h.shape
    per_code = {
        name: int((h == code).sum()) for code, name in enumerate(HEALTH_CODES)
    }
    worst_step = int(np.argmin(h.min(axis=1))) if s else 0
    return {
        "steps": s,
        "links": k,
        "by_code": per_code,
        "worst_step": worst_step,
        "healthy_frac": float((h == 4).mean()) if h.size else 1.0,
    }

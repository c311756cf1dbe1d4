"""Arbitration outcome classification (paper Fig. 9(c)-(f)).

Given a per-ring assignment, classify each trial as success or one of:
  * zero-lock   — some ring locked nothing (Fig. 9(e))
  * dup-lock    — two rings locked the same laser line (Fig. 9(d))
  * order error — spectral-ordering requirement violated (Fig. 9(f))
The classifier is wavelength-aware (it is part of the evaluator, not the
arbiter).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..obs.phase import span
from .ssm import Assignment


class Outcome(NamedTuple):
    success: torch.Tensor     # (T,) bool
    zero_lock: torch.Tensor   # (T,) bool
    dup_lock: torch.Tensor    # (T,) bool
    order_err: torch.Tensor   # (T,) bool


def classify(assign: Assignment, s, policy: str = "ltc") -> Outcome:
    with span("arbiters.classify"):
        return _classify(assign, s, policy)


def _classify(assign: Assignment, s, policy: str) -> Outcome:
    wl = assign.wl                                   # (T, N)
    T, n = wl.shape
    zero = torch.any(wl < 0, dim=1)

    # Locks per line; unlocked rings (wl = -1) count into a spare column n.
    counts = torch.zeros((T, n + 1), dtype=torch.int32, device=wl.device)
    counts.scatter_add_(1, torch.where(wl >= 0, wl, n).long(),
                        torch.ones_like(wl, dtype=torch.int32))
    dup = torch.any(counts[:, :n] > 1, dim=1)

    s = torch.as_tensor(s, dtype=torch.int32, device=wl.device)
    if policy == "ltd":
        order_ok = torch.all(wl == s[None, :], dim=1)
    elif policy == "ltc":
        shift = (wl - s[None, :]) % n
        order_ok = torch.all(shift == shift[:, :1], dim=1)
    elif policy == "lta":
        order_ok = torch.ones((T,), dtype=torch.bool, device=wl.device)
    else:
        raise ValueError(policy)
    order_err = ~zero & ~dup & ~order_ok
    success = ~zero & ~dup & order_ok
    return Outcome(success=success, zero_lock=zero, dup_lock=dup, order_err=order_err)

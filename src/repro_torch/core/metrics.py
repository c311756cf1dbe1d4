"""Robustness metrics: AFP and CAFP (paper §III, Eq. 6-7).

AFP  — Arbitration Failure Probability of the *ideal* wavelength-aware
       arbiter under a policy: policy-level yield.
CAFP — Conditional Arbitration Failure Probability of a wavelength-oblivious
       *algorithm*: P(algorithm fails AND ideal succeeds), with the total
       trial count as denominator for sampling stability (Eq. 6).
Total algorithmic failure = AFP + CAFP (Eq. 7).
"""
from __future__ import annotations

import torch


def afp(ideal_success: torch.Tensor) -> torch.Tensor:
    """Fraction of trials where ideal arbitration fails."""
    return 1.0 - torch.mean(ideal_success.to(torch.float32))


def cafp(alg_success: torch.Tensor, ideal_success: torch.Tensor) -> torch.Tensor:
    """P_alg|succ(fail) * P(succ), denominator = total trials (Eq. 6)."""
    return torch.mean((~alg_success & ideal_success).to(torch.float32))


def total_failure(alg_success: torch.Tensor, ideal_success: torch.Tensor) -> torch.Tensor:
    """AFP + CAFP = total failure probability of the algorithm (Eq. 7)."""
    return afp(ideal_success) + cafp(alg_success, ideal_success)


def min_tr_for_complete_success(per_trial_min_tr: torch.Tensor) -> torch.Tensor:
    """Paper's 'minimum tuning range': smallest TR mean with zero failures."""
    return torch.max(per_trial_min_tr)

"""Ideal, wavelength-aware arbitration models (paper §III-A).

These evaluate the *policy* layer: given full wavelength knowledge, can the
system be arbitrated under LtD / LtC / LtA?  Used for AFP and as the
conditioning event of CAFP.  Each policy exposes a per-trial *minimum mean
tuning range*, from which success at any TR is a comparison.  LtD/LtC come
from the ``feasibility`` kernel wrapper, the LtA minimum TR from the
``bottleneck`` wrapper and LtA success from the ``match`` wrapper (each its
plain version on the CPU).
"""
from __future__ import annotations

import torch

from ..kernels.bitmask_match import bottleneck_threshold
from ..kernels.feasibility import feasibility, per_shift_min_tr
from ..obs.phase import span
from .matching import has_perfect_matching
from .reach import reach_matrix, scaled_residual, trial_value
from .sampling import SystemBatch


def ltd_min_tr(sys: SystemBatch, s) -> torch.Tensor:
    """(T,) minimum mean TR for Lock-to-Deterministic success."""
    return feasibility(*sys, s)[0]


def ltc_min_tr(sys: SystemBatch, s) -> torch.Tensor:
    """(T,) minimum mean TR for Lock-to-Cyclic success (best cyclic shift)."""
    return feasibility(*sys, s)[1]


def ltc_best_shift(sys: SystemBatch, s) -> torch.Tensor:
    """(T,) argmin cyclic shift c — the wavelength-aware LtC assignment."""
    return torch.argmin(per_shift_min_tr(*sys, s), dim=0).to(torch.int32)


def lta_min_tr(sys: SystemBatch) -> torch.Tensor:
    """(T,) minimum mean TR for Lock-to-Any success (bottleneck matching)."""
    return bottleneck_threshold(scaled_residual(sys))


def min_tr(sys: SystemBatch, policy: str, s) -> torch.Tensor:
    """(T,) per-trial minimum mean tuning range for the policy."""
    with span("arbiters.ideal", policy=policy):
        return _min_tr(sys, policy, s)


def _min_tr(sys: SystemBatch, policy: str, s) -> torch.Tensor:
    if policy == "ltd":
        return ltd_min_tr(sys, s)
    if policy == "ltc":
        return ltc_min_tr(sys, s)
    if policy == "lta":
        return lta_min_tr(sys)
    raise ValueError(f"unknown policy {policy!r}")


def success(sys: SystemBatch, policy: str, s, tr_mean) -> torch.Tensor:
    """(T,) bool ideal arbitration success at the given mean tuning range
    (a scalar, or one per trial)."""
    with span("arbiters.ideal", policy=policy):
        if policy == "lta":
            return has_perfect_matching(reach_matrix(sys, tr_mean))
        return _min_tr(sys, policy, s) <= trial_value(tr_mean, sys.laser.device, 1)

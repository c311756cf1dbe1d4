"""Reachability in the wavelength domain (Eq. 5).

A ring's thermally-tuned resonance sweeps red-ward by delta in [0, TR_i] from
every comb line lambda_ring,i + j*FSR_i.  Laser line k is reachable iff the
red-shift residual  (lambda_laser,k - lambda_ring,i) mod FSR_i  <= TR_i, and
that residual is exactly the minimum tuning distance delta_{i,k}.

``torch.remainder`` is ``fmod`` plus a sign fix, the same as ``jnp.mod``, so
the residuals equal the reference's bit for bit.
"""
from __future__ import annotations

import torch

from .sampling import SystemBatch


def tuning_residual(sys: SystemBatch) -> torch.Tensor:
    """(T, N, N) residual[t, i, k] = min red-shift of ring i to laser k [nm]."""
    d = sys.laser[:, None, :] - sys.ring[:, :, None]          # (T, ring, laser)
    return torch.remainder(d, sys.fsr[:, :, None])


def scaled_residual(sys: SystemBatch) -> torch.Tensor:
    """Residual divided by the per-ring TR multiplier.

    success at mean tuning range t  <=>  scaled_residual <= t, so per-trial
    minimum tuning ranges are direct max/min-reductions of this tensor.
    """
    return tuning_residual(sys) / sys.tr_unit[:, :, None]


def reach_matrix(sys: SystemBatch, tr_mean) -> torch.Tensor:
    """(T, N, N) bool: ring i can be tuned onto laser k at the given TR mean
    (a scalar, or one per trial)."""
    return scaled_residual(sys) <= trial_value(tr_mean, sys.laser.device, 3)


def as_f32(value, device) -> torch.Tensor:
    """A scalar operating point as a float32 tensor, so comparisons and
    products round it to float32 exactly as the reference does."""
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def trial_value(value, device, ndim: int) -> torch.Tensor:
    """An operating point as float32: a scalar as a 0-d tensor, a (T,) one
    value per trial (a batch of grid points) shaped (T, 1, ...) to broadcast
    against a (T, ...) tensor of ``ndim`` dims."""
    v = as_f32(value, device)
    return v if v.dim() == 0 else v.reshape((-1,) + (1,) * (ndim - 1))

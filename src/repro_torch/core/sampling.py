"""Monte-Carlo sampling of multi-wavelength lasers and microring rows.

The paper crosses ``n_laser`` laser samples with ``n_ring`` microring-row
samples (100 x 100 = 10,000 trials).  Unit uniform deviates in [-1, 1] are
drawn once and scaled by the sigma values at instantiation, so the variation
half-ranges can be swept without re-sampling (§II-C).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .grid import ArbitrationConfig
from .variations import Variations, apply_axis_transforms, as_variations


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names one.

    There is no quiet CPU fallback: without CUDA the default raises.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch runs on CUDA by default, and no CUDA device is "
            "available; pass device='cpu' to run the plain PyTorch versions"
        )
    return torch.device("cuda")


class UnitSamples(NamedTuple):
    """Unit uniform deviates in [-1, 1]; scaled by sigma at instantiation."""

    u_go: torch.Tensor    # (L, 1)  grid offset per laser sample
    u_llv: torch.Tensor   # (L, N)  laser local variation
    u_rlv: torch.Tensor   # (R, N)  ring local resonance variation
    u_fsr: torch.Tensor   # (R, N)  FSR variation
    u_tr: torch.Tensor    # (R, N)  tuning-range variation


class SystemBatch(NamedTuple):
    """A batch of T sampled systems, projected onto the wavelength domain.

    All wavelengths relative to lambda_center.  ``tr_unit`` is the per-ring
    tuning-range multiplier (1 + Delta_TR/TR); actual TR_i = tr_mean * tr_unit.
    """

    laser: torch.Tensor    # (T, N) laser wavelengths, ascending in channel index
    ring: torch.Tensor     # (T, N) ring resonance wavelengths (physical index i)
    fsr: torch.Tensor      # (T, N) per-ring FSR
    tr_unit: torch.Tensor  # (T, N) per-ring tuning-range multiplier

    @property
    def n_trials(self) -> int:
        return self.laser.shape[0]

    @property
    def n_ch(self) -> int:
        return self.laser.shape[1]


def draw_unit_samples(generator: torch.Generator, n_ch: int, n_laser: int,
                      n_ring: int) -> UnitSamples:
    """Unit deviates from a CPU ``torch.Generator`` (on the CPU)."""
    def u(*shape):
        return torch.empty(shape, dtype=torch.float32).uniform_(
            -1.0, 1.0, generator=generator)

    return UnitSamples(
        u_go=u(n_laser, 1),
        u_llv=u(n_laser, n_ch),
        u_rlv=u(n_ring, n_ch),
        u_fsr=u(n_ring, n_ch),
        u_tr=u(n_ring, n_ch),
    )


def instantiate(
    cfg: ArbitrationConfig,
    units: UnitSamples,
    variations: Variations | None = None,
) -> SystemBatch:
    """Apply sigma scales to unit samples and cross lasers x rings (Eq. 3-4).

    ``variations`` (a ``Variations`` or plain mapping) carries the
    overrides; unset axes fall back to the config.  Registered axes with a
    ``transform`` hook (e.g. ``thermal_drift``) are applied after the core
    sampling math; ``tr_mean`` is ignored here (the tuning range is an
    evaluation-time quantity).  The arithmetic follows the reference term
    for term, so the batch equals it bit for bit on the same units.
    """
    over = as_variations(variations)
    grid = cfg.grid
    dev = units.u_llv.device
    s_go = over.resolve("sigma_go", cfg)
    s_llv = over.resolve("sigma_llv_frac", cfg) * grid.grid_spacing
    s_rlv = over.resolve("sigma_rlv", cfg)
    s_fsr = over.resolve("sigma_fsr_frac", cfg)
    s_tr = over.resolve("sigma_tr_frac", cfg)
    fsr0 = over.resolve("fsr_mean", cfg)

    # Lasers: lambda_i = grid_i + Delta_gO + Delta_lLV,i           (Eq. 3)
    laser_grid = torch.from_numpy(grid.laser_grid()).to(dev)
    laser = laser_grid[None, :] + s_go * units.u_go + s_llv * units.u_llv   # (L, N)
    # Rings: lambda_i = grid(r_i) - lambda_rB + Delta_rLV,i        (Eq. 4)
    ring_grid = torch.from_numpy(grid.ring_grid(cfg.r)).to(dev)
    ring = ring_grid[None, :] + s_rlv * units.u_rlv                          # (R, N)
    fsr = fsr0 * (1.0 + s_fsr * units.u_fsr)                                 # (R, N)
    tr_unit = 1.0 + s_tr * units.u_tr                                        # (R, N)

    L, R, N = laser.shape[0], ring.shape[0], laser.shape[1]
    T = L * R
    # Cross product lasers x rings -> T trials (trial = l * R + r), dense:
    # with one laser or one ring sample ``reshape`` alone would keep a
    # stride-0 view, and the kernels take contiguous rows.
    sys = SystemBatch(
        laser=laser[:, None, :].expand(L, R, N).reshape(T, N).contiguous(),
        ring=ring[None, :, :].expand(L, R, N).reshape(T, N).contiguous(),
        fsr=fsr[None, :, :].expand(L, R, N).reshape(T, N).contiguous(),
        tr_unit=tr_unit[None, :, :].expand(L, R, N).reshape(T, N).contiguous(),
    )
    return apply_axis_transforms(sys, over, cfg)

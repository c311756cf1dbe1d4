"""Monte-Carlo sampling of multi-wavelength lasers and microring rows.

The paper crosses ``n_laser`` laser samples with ``n_ring`` microring-row
samples (100 x 100 = 10,000 trials).  Unit uniform deviates in [-1, 1] are
drawn once and scaled by the sigma values at instantiation, so the variation
half-ranges can be swept without re-sampling (§II-C).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..obs.phase import span
from . import prng
from .grid import ArbitrationConfig
from .variations import (Variations, apply_axis_transforms, is_per_point,
                         merge_legacy_overrides, point_count, transform_axes)


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


def draw_unit_samples(key, n_ch: int, n_laser: int, n_ring: int, *,
                      partitionable: bool = True) -> UnitSamples:
    """Unit deviates from a threefry key (``prng.key_from_seed``), on the CPU:
    the reference's draw bit for bit, ``split(key, 5)`` giving the keys of
    u_go, u_llv, u_rlv, u_fsr and u_tr.  ``partitionable`` selects JAX's
    counter layout (its ``jax_threefry_partitionable`` switch)."""
    keys = prng.split(key, 5, partitionable=partitionable)

    def u(k, *shape):
        return torch.from_numpy(prng.uniform(keys[k], shape, -1.0, 1.0,
                                             partitionable=partitionable))

    return UnitSamples(
        u_go=u(0, n_laser, 1),
        u_llv=u(1, n_laser, n_ch),
        u_rlv=u(2, n_ring, n_ch),
        u_fsr=u(3, n_ring, n_ch),
        u_tr=u(4, n_ring, n_ch),
    )


def _f32(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def per_trial(value, n_points: int, n_trials: int, device):
    """An axis value per trial: a per-point (P,) value repeated over each
    point's ``n_trials // P`` trials as a (P*T,) float32 tensor; a scalar is
    returned as it is."""
    if not is_per_point(value):
        return value
    return _f32(value, device).repeat_interleave(n_trials // n_points)


def instantiate(
    cfg: ArbitrationConfig,
    units: UnitSamples,
    variations: Variations | None = None,
    *,
    sigma_rlv: float | None = None,
    sigma_go: float | None = None,
    sigma_llv_frac: float | None = None,
    sigma_fsr_frac: float | None = None,
    sigma_tr_frac: float | None = None,
    fsr_mean: float | None = None,
) -> SystemBatch:
    """Apply sigma scales to unit samples and cross lasers x rings (Eq. 3-4).

    ``variations`` (a ``Variations`` or plain mapping) carries the
    overrides; unset axes fall back to the config.  The ``sigma_*=``
    keywords are the deprecated shims of ``variations.LEGACY_SIGMA_KWARGS``:
    bit-identical, but they warn.  Registered axes with a
    ``transform`` hook (e.g. ``thermal_drift``) are applied after the core
    sampling math; ``tr_mean`` is ignored here (the tuning range is an
    evaluation-time quantity).

    Grid points: an override may be a 1-D (P,) tensor, one value per point
    (all such overrides share P).  The batch then holds P * L * R trials,
    point-major (trial = p * T + l * R + r), and each point's rows equal the
    single-point batch at that point's values.

    Every override is rounded to float32 before it meets a tensor, as the
    reference's jitted scalars are, so ``sigma_llv_frac * grid_spacing`` is a
    float32 product (the un-jitted reference takes a Python float's product
    in double precision); config defaults are double-precision constants.
    The rest of the arithmetic follows the reference's un-jitted
    ``instantiate`` term for term, bit for bit on the same units.
    """
    with span("sampling.instantiate"):
        over = merge_legacy_overrides(
            variations,
            dict(sigma_rlv=sigma_rlv, sigma_go=sigma_go, sigma_llv_frac=sigma_llv_frac,
                 sigma_fsr_frac=sigma_fsr_frac, sigma_tr_frac=sigma_tr_frac,
                 fsr_mean=fsr_mean),
            caller="instantiate",
        )
        return _systems(cfg, units, over)


def _systems(cfg: ArbitrationConfig, units: UnitSamples, over: Variations) -> SystemBatch:
    """``instantiate``'s arithmetic, on the merged overrides."""
    grid = cfg.grid
    dev = units.u_llv.device
    n_points = point_count(over)

    def scale(name, factor=None):
        """(P, 1, 1) float32 override values, or the config default."""
        if name not in over:
            default = over.resolve(name, cfg)
            return default if factor is None else default * factor
        value = _f32(over.get(name), dev).reshape(-1, 1, 1)
        return value if factor is None else value * factor

    s_go = scale("sigma_go")
    s_llv = scale("sigma_llv_frac", grid.grid_spacing)
    s_rlv = scale("sigma_rlv")
    s_fsr = scale("sigma_fsr_frac")
    s_tr = scale("sigma_tr_frac")
    fsr0 = scale("fsr_mean")

    # Lasers: lambda_i = grid_i + Delta_gO + Delta_lLV,i           (Eq. 3)
    laser_grid = torch.from_numpy(grid.laser_grid()).to(dev)
    laser = laser_grid + s_go * units.u_go + s_llv * units.u_llv   # (P, L, N)
    # Rings: lambda_i = grid(r_i) - lambda_rB + Delta_rLV,i        (Eq. 4)
    ring_grid = torch.from_numpy(grid.ring_grid(cfg.r)).to(dev)
    ring = ring_grid + s_rlv * units.u_rlv                          # (P, R, N)
    fsr = fsr0 * (1.0 + s_fsr * units.u_fsr)                        # (P, R, N)
    tr_unit = 1.0 + s_tr * units.u_tr                               # (P, R, N)

    L, R, N = units.u_llv.shape[0], units.u_rlv.shape[0], units.u_llv.shape[1]
    P, T = n_points, L * R

    def cross(x, lasers: bool):
        # Lasers x rings -> trial = p * T + l * R + r, dense: with one laser
        # or one ring sample ``reshape`` alone would keep a stride-0 view,
        # and the kernels take contiguous rows.
        x = x.reshape(-1, x.shape[-2], N).expand(P, x.shape[-2], N)
        x = x[:, :, None, :] if lasers else x[:, None, :, :]
        return x.expand(P, L, R, N).reshape(P * T, N).contiguous()

    sys = SystemBatch(laser=cross(laser, True), ring=cross(ring, False),
                      fsr=cross(fsr, False), tr_unit=cross(tr_unit, False))
    # Transform hooks see scalars as they are, per-point values as per-trial
    # (P * T, 1) columns, so a hook written for one point serves a grid.
    transforms = {name: per_trial(value, P, P * T, dev)[:, None] if is_per_point(value)
                  else value for name, value in over.items() if name in transform_axes()}
    return apply_axis_transforms(sys, transforms, cfg)


def sample_systems(
    key,
    cfg: ArbitrationConfig,
    n_laser: int = 100,
    n_ring: int = 100,
    variations: Variations | None = None,
    *,
    device=None,
    partitionable: bool = True,
) -> SystemBatch:
    """Draw units from a threefry key (``prng.key_from_seed``) and
    instantiate them in one go: the reference's ``sample_systems``, its
    systems bit for bit, on ``device`` (CUDA unless named)."""
    dev = resolve_device(device)
    units = draw_unit_samples(key, cfg.grid.n_ch, n_laser, n_ring,
                              partitionable=partitionable)
    return instantiate(cfg, UnitSamples(*(u.to(dev) for u in units)), variations)

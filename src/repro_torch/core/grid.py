"""DWDM grid, device-variation model and arbitration configuration.

The wavelength-domain model of Choi & Stojanović, §II-C (Fig. 2, Table I).
All wavelengths are *relative* to the grid center (only relative distances
matter), which keeps float32 exact enough: values span about ±60 nm at a
spacing resolution of about 1e-3 nm.

Units: nm everywhere.  ``sigma_*`` are half-ranges of uniform distributions
(paper footnote 4: linear, not RSS, sums).  Plain numpy, so the package's
configurations need no device.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np

Policy = str  # "ltd" | "ltc" | "lta"
POLICIES: Tuple[Policy, ...] = ("ltd", "ltc", "lta")


def natural_order(n_ch: int) -> np.ndarray:
    """Natural spectral ordering (0, 1, 2, ..., N-1)."""
    return np.arange(n_ch, dtype=np.int32)


def permuted_order(n_ch: int) -> np.ndarray:
    """Paper's 'Permuted' ordering (0, N/2, 1, N/2+1, ...) — Table II."""
    half = n_ch // 2
    out = np.empty(n_ch, dtype=np.int32)
    out[0::2] = np.arange(half, dtype=np.int32)
    out[1::2] = np.arange(half, dtype=np.int32) + half
    return out


@dataclasses.dataclass(frozen=True)
class DWDMGrid:
    """Pre-fabrication design intent (Eq. 1-2 of the paper)."""

    n_ch: int = 8                 # number of DWDM channels
    grid_spacing: float = 1.12    # lambda_gS [nm]  (200 GHz in O-band)
    ring_bias: float = 4.48       # lambda_rB [nm]  blue-side fabrication bias
    fsr_mean: float | None = None  # lambda_FSR mean; default N_ch * grid_spacing
    tr_mean: float = 8.96         # lambda_TR mean [nm] (swept in experiments)

    @property
    def fsr(self) -> float:
        return self.n_ch * self.grid_spacing if self.fsr_mean is None else self.fsr_mean

    def laser_grid(self) -> np.ndarray:
        """Pre-fab laser wavelengths, relative to lambda_center (Eq. 1)."""
        i = np.arange(self.n_ch, dtype=np.float32)
        return (i - (self.n_ch - 1) / 2.0) * np.float32(self.grid_spacing)

    def ring_grid(self, r: np.ndarray) -> np.ndarray:
        """Pre-fab ring resonances, relative to lambda_center (Eq. 2)."""
        r = np.asarray(r, dtype=np.float32)
        return -np.float32(self.ring_bias) + (r - (self.n_ch - 1) / 2.0) * np.float32(
            self.grid_spacing
        )


@dataclasses.dataclass(frozen=True)
class VariationModel:
    """Half-ranges of uniform device variations (Table I)."""

    sigma_go: float = 15.0        # grid offset  = sigma_lGV + sigma_rGV [nm]
    sigma_llv_frac: float = 0.25  # laser local variation, fraction of grid_spacing
    sigma_rlv: float = 2.24       # ring local resonance variation [nm]
    sigma_fsr_frac: float = 0.01  # FSR variation, fraction of FSR mean
    sigma_tr_frac: float = 0.10   # tuning-range variation, fraction of TR mean

    def replace(self, **kw) -> "VariationModel":
        return dataclasses.replace(self, **kw)


@dataclasses.dataclass(frozen=True)
class ArbitrationConfig:
    """A complete system-under-test specification.

    ``r`` — pre-fabrication spectral ordering (r_i), per physical ring i.
    ``s`` — post-arbitration target spectral ordering (s_i).  The paper's
    experiments assume s == r (Table II).
    """

    grid: DWDMGrid = dataclasses.field(default_factory=DWDMGrid)
    var: VariationModel = dataclasses.field(default_factory=VariationModel)
    r_order: Tuple[int, ...] = None  # type: ignore[assignment]
    s_order: Tuple[int, ...] = None  # type: ignore[assignment]
    max_fsr_alias: int = 8        # |j| bound when enumerating FSR-periodic resonances

    def __post_init__(self):
        n = self.grid.n_ch
        if self.r_order is None:
            object.__setattr__(self, "r_order", tuple(natural_order(n).tolist()))
        if self.s_order is None:
            object.__setattr__(self, "s_order", tuple(self.r_order))
        if sorted(self.r_order) != list(range(n)):
            raise ValueError(f"r must be a permutation of range({n}), got {self.r_order}")
        if sorted(self.s_order) != list(range(n)):
            raise ValueError(f"s must be a permutation of range({n}), got {self.s_order}")
        # Laser lines must stay monotone in index for order semantics.
        if not self.var.sigma_llv_frac < 0.5:
            raise ValueError("laser local variation must keep the grid monotone (< 0.5)")

    @property
    def r(self) -> np.ndarray:
        return np.asarray(self.r_order, dtype=np.int32)

    @property
    def s(self) -> np.ndarray:
        return np.asarray(self.s_order, dtype=np.int32)

    @property
    def chain(self) -> np.ndarray:
        """Tuning/relation chain pi: pi[t] = physical ring with target order t."""
        return np.argsort(self.s).astype(np.int32)

    def with_orders(self, kind: str) -> "ArbitrationConfig":
        """kind in {'natural', 'permuted'} applied to both r and s (N/N, P/P)."""
        order = {"natural": natural_order, "permuted": permuted_order}[kind](self.grid.n_ch)
        t = tuple(order.tolist())
        return dataclasses.replace(self, r_order=t, s_order=t)


def wdm_config(n_ch: int = 8, ghz: int = 200, **kw) -> ArbitrationConfig:
    """Named DWDM configuration (Fig. 5): 200 GHz = 1.12 nm in the O-band."""
    spacing = 1.12 * (ghz / 200.0)
    grid = DWDMGrid(n_ch=n_ch, grid_spacing=spacing, ring_bias=4.0 * spacing)
    return ArbitrationConfig(grid=grid, **kw)

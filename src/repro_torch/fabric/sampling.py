"""Per-link Monte-Carlo sampling for fabric bring-up.

One fabric draw is *per-link*, not a laser x ring cross product: link k has
its own comb sample (grid offset + per-line local variation, shared by both
endpoint transceivers, which see the same physical light) and two
independent ring-row samples (one per endpoint).  ``instantiate_links``
computes ``core.sampling.instantiate``'s Eq. 3-4 math for every link as an
(L=1 laser, R=2 rings) cross product, which is what makes constraints-off
fabric bring-up bit-identical to independent per-link arbitration (the
fig21 parity).

All K links become one flat batch of 2K trials: row 2k is link k's tx end,
row 2k + 1 its rx end (the layout of ``FabricResult.system``).

Shared-comb coupling blends each link's private laser draws with its comb
group's draws: ``u_eff = (1 - c) * u_private + c * u_group`` with ``c`` the
``comb_coupling`` variation axis.  Both endpoints are exact by construction:
c = 0 reproduces the private draw bit for bit (``1*u + 0*g``), c = 1 the
group draw (``0*u + 1*g``).  For ``comb_group="link"`` the group draws alias
the private draws and the blend is skipped entirely.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core import prng
from ..core.grid import ArbitrationConfig
from ..core.sampling import SystemBatch, per_trial, resolve_device
from ..core.variations import (Variations, apply_axis_transforms, as_variations, is_per_point,
                               point_count, transform_axes)
from .spec import FabricSpec


class FabricUnits(NamedTuple):
    """Unit uniform deviates in [-1, 1] for every link of a fabric.

    Laser draws are per link (both endpoints share the comb); ring draws
    are per endpoint (axis 1: 0 = tx-side transceiver, 1 = rx-side).
    ``g_go``/``g_llv`` are the link's comb-*group* draws, pre-gathered to
    link order (for ``comb_group="link"`` they alias ``go``/``llv``).
    """

    go: torch.Tensor     # (K,)       grid offset per link comb
    llv: torch.Tensor    # (K, N)     laser local variation per link comb
    g_go: torch.Tensor   # (K,)       comb-group grid offset, gathered per link
    g_llv: torch.Tensor  # (K, N)     comb-group local variation, per link
    rlv: torch.Tensor    # (K, 2, N)  ring local variation per endpoint
    fsr: torch.Tensor    # (K, 2, N)  FSR variation per endpoint
    tr: torch.Tensor     # (K, 2, N)  tuning-range variation per endpoint

    @property
    def n_links(self) -> int:
        return self.go.shape[0]


def make_fabric_units(cfg: ArbitrationConfig, spec: FabricSpec, seed: int, device=None, *,
                      partitionable: bool = True) -> FabricUnits:
    """The reference's per-link and per-endpoint unit draws for ``seed``,
    bit for bit: ``split(key(seed), 7)`` and seven float32 ``uniform(-1, 1)``
    draws (threefry in numpy, ``core.prng``), the group draws gathered to
    link order; made on the CPU, then moved to ``device`` (CUDA unless
    named).  ``partitionable`` selects JAX's counter layout, as in
    ``core.api.make_units``."""
    dev = resolve_device(device)
    n, k = cfg.grid.n_ch, spec.n_links
    keys = prng.split(prng.key_from_seed(seed), 7, partitionable=partitionable)

    def u(i, *shape):
        return torch.from_numpy(prng.uniform(keys[i], shape, -1.0, 1.0,
                                             partitionable=partitionable)).to(dev)

    go, llv = u(0, k), u(1, k, n)
    if spec.comb_group == "link":
        g_go, g_llv = go, llv  # the blend is the identity; see instantiate_links
    else:
        group = torch.from_numpy(spec.link_group()).to(dev)
        g_go = u(2, spec.n_groups)[group]
        g_llv = u(3, spec.n_groups, n)[group]
    return FabricUnits(go=go, llv=llv, g_go=g_go, g_llv=g_llv,
                       rlv=u(4, k, 2, n), fsr=u(5, k, 2, n), tr=u(6, k, 2, n))


def _f32(value, device) -> torch.Tensor:
    return torch.as_tensor(value, dtype=torch.float32, device=device)


def instantiate_link(
    cfg: ArbitrationConfig,
    spec: FabricSpec,
    units: FabricUnits,
    variations: Variations | None = None,
) -> SystemBatch:
    """One link's unit draws -> a T = 2 ``SystemBatch`` (one trial per end):
    the reference's one-link form.  ``units`` is a single-link slice with no
    K axis (``go`` a 0-d tensor, ``llv`` (N,), ``rlv`` (2, N), ...); the
    result is ``instantiate_links`` on K = 1."""
    return instantiate_links(cfg, spec, FabricUnits(*(u[None] for u in units)), variations)


def instantiate_links(
    cfg: ArbitrationConfig,
    spec: FabricSpec,
    units: FabricUnits,
    variations: Variations | None = None,
) -> SystemBatch:
    """Every link's unit draws -> one (2K, N) ``SystemBatch`` (row 2k = link
    k's tx end, 2k + 1 its rx end): the reference's per-link
    ``instantiate_link``, all links at once.

    Both rows of a link share its laser row; each gets its own ring row.
    The arithmetic is the reference's un-jitted ``instantiate_link`` term
    for term, bit for bit on the same units, with every override rounded to
    float32 before it meets a tensor (as the jitted reference's traced
    scalars are), so ``1 - comb_coupling`` is a float32 subtraction.

    Per-link values: an override may be a 1-D (K,) tensor, one value per
    link.  The sweep engine gives each grid point its own copy of the
    fabric's links, so a chunk of points is one batch whose rows equal
    each point's own batch.
    """
    over = as_variations(variations)
    grid = cfg.grid
    dev = units.llv.device
    k, n = units.llv.shape
    point_count(over)  # per-link overrides must share their length

    def scale(name, factor=None, ndim=2):
        """An override as float32, (K,) values shaped (K, 1, ...) to broadcast
        against ``ndim``-dim per-link draws; or the config default."""
        if name not in over:
            default = over.resolve(name, cfg)
            return default if factor is None else default * factor
        value = _f32(over.get(name), dev)
        if value.dim() == 1:
            value = value.reshape((-1,) + (1,) * (ndim - 1))
        return value if factor is None else value * factor

    s_go = scale("sigma_go")
    s_llv = scale("sigma_llv_frac", grid.grid_spacing)
    s_rlv = scale("sigma_rlv", ndim=3)
    s_fsr = scale("sigma_fsr_frac", ndim=3)
    s_tr = scale("sigma_tr_frac", ndim=3)
    fsr0 = scale("fsr_mean", ndim=3)

    u_go, u_llv = units.go[:, None], units.llv                   # (K, 1), (K, N)
    if spec.comb_group != "link":
        c = scale("comb_coupling")
        u_go = (1.0 - c) * u_go + c * units.g_go[:, None]
        u_llv = (1.0 - c) * u_llv + c * units.g_llv

    # Lasers: lambda_i = grid_i + Delta_gO + Delta_lLV,i           (Eq. 3)
    laser_grid = torch.from_numpy(grid.laser_grid()).to(dev)
    laser = laser_grid + s_go * u_go + s_llv * u_llv              # (K, N)
    # Rings: lambda_i = grid(r_i) - lambda_rB + Delta_rLV,i        (Eq. 4)
    ring_grid = torch.from_numpy(grid.ring_grid(cfg.r)).to(dev)
    ring = ring_grid + s_rlv * units.rlv                          # (K, 2, N)
    fsr = fsr0 * (1.0 + s_fsr * units.fsr)                        # (K, 2, N)
    tr_unit = 1.0 + s_tr * units.tr                               # (K, 2, N)

    def rows(x):
        return x.expand(k, 2, n).reshape(2 * k, n).contiguous()

    sys = SystemBatch(laser=rows(laser[:, None, :]), ring=rows(ring), fsr=rows(fsr),
                      tr_unit=rows(tr_unit))
    # Transform hooks see scalars as they are, per-link values as per-row
    # (2K, 1) columns.
    transforms = {name: per_trial(value, k, 2 * k, dev)[:, None] if is_per_point(value)
                  else value for name, value in over.items() if name in transform_axes()}
    return apply_axis_transforms(sys, transforms, cfg)

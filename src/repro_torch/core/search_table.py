"""Microring search tables (paper §V-A, Fig. 9-10).

During a wavelength search the tuner sweeps delta in [0, TR_i]; a peak in
intra-cavity power occurs whenever any comb resonance
lambda_ring,i + j*FSR_i + delta aligns with a *visible* laser line.  The
recorded tuner codes are monotone in delta, so the wavelength-domain search
table is the ascending list of (delta, wavelength-id) peaks.

The oblivious algorithms only use entry *indices* and masking events; the
wavelength ids are simulator-side ground truth for the evaluator.

Tables are fixed-size (E = 3*N entries by default) with sentinel padding:
delta = +inf, wl = -1.  If TR > FSR a laser line aliases into several
entries (multi-FSR, paper §V-B).  The builder is the ``table_build`` kernel
wrapper; ties are broken by flat candidate index (line-major, alias-minor),
the order of the reference's stable argsort.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..kernels.table_build import build_tables
from ..obs.phase import span
from .reach import trial_value
from .sampling import SystemBatch

#: The padding of a table's ``delta`` beyond its valid entries (float32 +inf).
SENTINEL = np.float32(np.inf)


class SearchTables(NamedTuple):
    delta: torch.Tensor    # (T, N, E) ascending tuning distances; +inf padded
    wl: torch.Tensor       # (T, N, E) int32 laser line index of each peak; -1 padded
    n_valid: torch.Tensor  # (T, N) int32 number of valid entries per ring

    @property
    def max_entries(self) -> int:
        return self.delta.shape[-1]


def max_entries_for(n_ch: int) -> int:
    return 3 * n_ch


def build_search_tables(
    sys: SystemBatch,
    tr_mean,
    *,
    visible: torch.Tensor | None = None,
    max_alias: int = 8,
    max_entries: int | None = None,
) -> SearchTables:
    """Construct per-ring search tables for a batch of trials.

    tr_mean: the mean tuning range, a scalar or one per trial ((T,)).
    visible: optional bool tensor of lines present on the bus — (T, N_wl)
      (same for every ring) or (T, N_ring, N_wl) (per searching ring).
      None = all lines visible.
    """
    with span("arbiters.tables"):
        n = sys.n_ch
        tr = trial_value(tr_mean, sys.tr_unit.device, 2) * sys.tr_unit
        delta, wl, n_valid = build_tables(
            sys.laser, sys.ring, sys.fsr, tr, visible=visible, max_alias=max_alias,
            max_entries=max_entries_for(n) if max_entries is None else max_entries,
        )
        return SearchTables(delta=delta, wl=wl, n_valid=n_valid)


def mask_wavelength(tables: SearchTables, ring: int, wl_id: torch.Tensor) -> torch.Tensor:
    """Index of the *first* entry of ``ring``'s table whose line equals wl_id.

    Returns (T,) int32, or -1 if none — what a victim ring observes when an
    aggressor captures a line.
    """
    hit = tables.wl[:, ring, :] == wl_id[:, None]
    first, found = first_true(hit)
    return torch.where(found, first, -1)


def first_true(mask: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Along the last axis: (int32 index of the first True, 0 if none; any)."""
    e = mask.shape[-1]
    iota = torch.arange(e, dtype=torch.int32, device=mask.device)
    first = torch.where(mask, iota, e).amin(dim=-1)
    found = first < e
    return torch.where(found, first, 0), found

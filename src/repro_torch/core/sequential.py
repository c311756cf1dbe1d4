"""Sequential Lock-to-Nearest tuning — the paper's baseline (§V-D).

Rings tune one at a time in target-ordering chain order; each locks onto the
first (nearest, smallest red-shift) peak visible in its wavelength search.
Visibility honors light precedence: a locked ring captures its line only for
rings physically *downstream* of it.  Under permuted orderings a ring that
tunes later but sits upstream can therefore steal a line already held
downstream — the dup-lock failure mode of Fig. 15; under natural ordering the
characteristic failure is tone skipping (zero-lock).
"""
from __future__ import annotations

import torch

from .relation import ChainSpec
from .search_table import SearchTables, first_true
from .ssm import Assignment, gather_assignment


def sequential_tuning(tables: SearchTables, spec: ChainSpec) -> Assignment:
    T, n, E = tables.wl.shape
    dev = tables.wl.device
    rows = torch.arange(T, device=dev)
    entry = torch.full((T, n), -1, dtype=torch.int32, device=dev)
    cap_wl = torch.full((T, n), -1, dtype=torch.int32, device=dev)  # captured line

    for pos in range(n):                        # static chain order
        ring = int(spec.chain[pos])
        # Lines captured by locked rings physically upstream of `ring`; the
        # extra column n stays False for the clipped sentinel lookups.
        taken = torch.zeros((T, n + 1), dtype=torch.bool, device=dev)
        if ring > 0:
            up = cap_wl[:, :ring].long()                        # (T, ring)
            taken.scatter_(1, torch.where(up >= 0, up, n), True)
            taken[:, n] = False
        wl_row = tables.wl[:, ring, :]                          # (T, E)
        vis = (wl_row >= 0) & ~torch.gather(taken, 1, wl_row.clamp(0, n).long())
        # Tables are delta-ascending: first visible entry = nearest peak.
        first, found = first_true(vis)
        entry[:, ring] = torch.where(found, first, -1)
        cap_wl[:, ring] = torch.where(found, wl_row[rows, first.long()], -1)

    _, delta = gather_assignment(tables, entry)
    return Assignment(entry=entry, wl=cap_wl, delta=delta)

"""Beyond-paper: a wavelength-oblivious Lock-to-Any arbiter (SEQ-R).

The paper leaves LtA algorithms as future work (§V-E).  Sequential tuning
with conflict retry:

  round 0: every ring locks its nearest visible peak (Lock-to-Nearest), in
           lock order; upstream precedence is the arbiter;
  round r: every ring whose line was captured by an upstream ring (its lock
           monitor reads no power, an observable event) re-runs its
           wavelength search against the masked bus and locks its nearest
           remaining peak.  Up to R rounds,

then two depth-1 augmenting sweeps, each followed by a clean-up lock pass.
No spectral ordering is enforced: exactly the LtA policy.  Scored as CAFP
against the ideal LtA arbiter (perfect matching).

The structure follows the reference loop for loop (``rounds + 2`` lock
passes of N ranks, two augment passes over N(N-1)/2 ring pairs), each step
a handful of plain torch ops over the trial batch.  Two tie rules are
explicit: the lock order is a *stable* argsort of the peak counts, and the
first visible entry comes from ``first_true``, not an argmax of a bool mask.
"""
from __future__ import annotations

import torch

from .search_table import SearchTables, first_true
from .ssm import Assignment


def sequential_retry(tables: SearchTables, n_rounds: int | None = None,
                     constrained_first: bool = True) -> Assignment:
    """Oblivious LtA arbitration.

    Lock ORDER is a controller choice; by default rings lock
    most-constrained-first (fewest search-table peaks, a locally observable
    quantity).  VISIBILITY is physical: a searcher sees every line except
    those captured by locked rings physically upstream of it; a ring whose
    line is later stolen upstream observes lost power and re-searches.
    """
    T, n, E = tables.wl.shape
    dev = tables.wl.device
    rounds = n if n_rounds is None else n_rounds
    rows = torch.arange(T, device=dev)
    lanes = torch.arange(n, device=dev)
    if constrained_first:
        order = torch.argsort(tables.n_valid, dim=1, stable=True)
    else:
        order = lanes.expand(T, n)

    def taken_mask(lock, upto):
        """(T, n + 1) lines claimed by locked rings with index < upto (T,);
        column n stays False, the lookup of a clipped -1."""
        claimed = (lanes[None, :] < upto[:, None]) & (lock >= 0)
        taken = torch.zeros((T, n + 1), dtype=torch.bool, device=dev)
        taken.scatter_(1, torch.where(claimed, lock, n).long(), True)
        taken[:, n] = False
        return taken

    def is_taken(taken, lines):
        return torch.gather(taken, 1, lines.clamp(0, n).long())

    def lock_pass(lock):
        """One sweep in lock order; per-trial ring selection via gather."""
        new_lock = lock.clone()
        for rank in range(n):
            ring = order[:, rank]                                   # (T,)
            taken = taken_mask(new_lock, ring)
            wl_row = tables.wl[rows, ring, :]                       # (T, E)
            vis = (wl_row >= 0) & ~is_taken(taken, wl_row)
            first, found = first_true(vis)
            k = torch.where(found, wl_row[rows, first.long()], -1)
            # Keep a lock that no upstream ring claims (stability).
            cur = new_lock[rows, ring]
            cur_ok = (cur >= 0) & ~is_taken(taken, cur[:, None])[:, 0]
            new_lock[rows, ring] = torch.where(cur_ok, cur, k)
        return new_lock

    def augment_pass(lock):
        """Depth-1 oblivious augmenting: a starved ring R probes upstream
        donors X one at a time; X moves to its own next visible line and R
        takes the freed one."""
        new_lock = lock.clone()
        for R in range(n):
            starved = new_lock[:, R] < 0
            wl_R = tables.wl[:, R, :]
            upto_R = torch.full((T,), R, device=dev)
            for X in range(R):
                lx = new_lock[:, X].clone()
                holds_useful = (lx[:, None] == wl_R).any(dim=1) & (lx >= 0)
                taken_x = taken_mask(new_lock, torch.full((T,), X, device=dev))
                wl_X = tables.wl[:, X, :]
                vis_x = ((wl_X >= 0) & ~is_taken(taken_x, wl_X)
                         & (wl_X != lx[:, None]))
                alt_e, has_alt = first_true(vis_x)
                without_x = new_lock.clone()
                without_x[:, X] = -1
                taken_r = taken_mask(without_x, upto_R)
                freed_visible = ~is_taken(taken_r, lx[:, None])[:, 0]
                do = starved & holds_useful & has_alt & freed_visible
                alt_line = wl_X[rows, alt_e.long()]
                new_lock[:, X] = torch.where(do, alt_line, new_lock[:, X])
                new_lock[:, R] = torch.where(do, lx, new_lock[:, R])
                starved = starved & ~do
        return new_lock

    lock = torch.full((T, n), -1, dtype=torch.int32, device=dev)
    for _ in range(rounds):
        lock = lock_pass(lock)
    for _ in range(2):          # augmenting + clean-up sweeps
        lock = augment_pass(lock)
        lock = lock_pass(lock)

    # Entries and deltas of the final locks (nearest alias of the line).
    first, hit = first_true(tables.wl == lock[:, :, None])
    entry = torch.where(hit, first, -1)
    delta = torch.where(
        entry >= 0,
        torch.gather(tables.delta, 2, entry.clamp(min=0).long()[..., None])[..., 0],
        torch.inf,
    )
    return Assignment(entry=entry, wl=torch.where(entry >= 0, lock, -1), delta=delta)

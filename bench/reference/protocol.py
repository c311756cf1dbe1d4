"""Plain reference of the round-driven arbitration protocol, ``protocol_lta``.

Per-ring controllers that see only their own search table and masking
events: each round a probe sweep (starved rings, fewest peaks first, lock the
first visible line at or after their cursor), then up to four displacement
chains of up to N hops (a free line; else a donor among the first four that
can relock red-ward; else the nearest donor yields and seeks next), then a
release (starved cursors back to entry 0).  A trial halts once a round
changes nothing; halted trials keep their state.  At most 4N rounds.

The simulator's formulation frozen in plain tensor operations, with the
masked re-search written out (no kernel); the rounds run from a cold start.
"""
from __future__ import annotations

import torch

from .model import Tables, first_true

SEEKERS = 4
DONORS = 4


def masked_first(wl: torch.Tensor, taken: torch.Tensor, floor: torch.Tensor):
    """wl (T, C, E) lines, taken (T, L) captured lines, floor (T, C) ->
    (first visible entry at or after the floor, -1 if none; found)."""
    t, c, e = wl.shape
    n_lines = taken.shape[1]
    pad = torch.cat([taken, taken.new_zeros((t, 1))], dim=1)
    idx = torch.where((wl < 0) | (wl >= n_lines), n_lines, wl)
    taken_at = torch.gather(pad, 1, idx.reshape(t, c * e)).reshape(t, c, e)
    eiota = torch.arange(e, device=wl.device)
    first, found = first_true((wl >= 0) & ~taken_at & (eiota >= floor[..., None]))
    return torch.where(found, first, -1), found


def _taken(lock: torch.Tensor, n: int) -> torch.Tensor:
    t = lock.shape[0]
    idx = torch.where(lock >= 0, lock.clamp(0, n - 1), n)
    out = torch.zeros((t, n + 1), dtype=torch.int64, device=lock.device)
    return out.scatter_add_(1, idx, torch.ones_like(lock))[:, :n] > 0


def _holder(lock: torch.Tensor, n: int) -> torch.Tensor:
    t = lock.shape[0]
    idx = torch.where(lock >= 0, lock.clamp(0, n - 1), n)
    ring1 = torch.arange(1, n + 1, device=lock.device).expand_as(lock)
    out = torch.zeros((t, n + 1), dtype=torch.int64, device=lock.device)
    return out.scatter_add_(1, idx, ring1)[:, :n] - 1


def _probe(tables: Tables, order: torch.Tensor, lock, entry, cursor):
    t, n, e = tables.wl.shape
    rows = torch.arange(t, device=lock.device)
    lock, entry, cursor = lock.clone(), entry.clone(), cursor.clone()
    for rank in range(n):
        ring = order[:, rank]
        lock_r = lock[rows, ring]
        searching = (lock_r < 0) & (tables.n_valid[rows, ring] > 0)
        wl_row = tables.wl[rows, ring]
        cur = cursor[rows, ring]
        first, found = masked_first(wl_row[:, None, :], _taken(lock, n), cur[:, None])
        first, found = first[:, 0], found[:, 0]
        do = searching & found
        lock[rows, ring] = torch.where(do, wl_row[rows, first.clamp(0, e - 1)], lock_r)
        entry[rows, ring] = torch.where(do, first, entry[rows, ring])
        cursor[rows, ring] = torch.where(do, first, cur)
    return lock, entry, cursor


def _augment(tables: Tables, lock, entry, cursor):
    t, n, e = tables.wl.shape
    dev = lock.device
    k_don = max(1, min(DONORS, e))
    rows = torch.arange(t, device=dev)
    eiota = torch.arange(e, device=dev)
    lock, entry, cursor = lock.clone(), entry.clone(), cursor.clone()

    def hop(s, active):
        taken = _taken(lock, n)
        holder = _holder(lock, n)
        wl_s = tables.wl[rows, s]
        floor_s = cursor[rows, s]
        f_free, free_ok = masked_first(wl_s[:, None, :], taken, floor_s[:, None])
        f_free, free_ok = f_free[:, 0], free_ok[:, 0]
        cand = (wl_s >= 0) & (eiota[None, :] >= floor_s[:, None])
        x_e = torch.where(cand, torch.gather(holder, 1, wl_s.clamp(0, n - 1)), -1)
        cand = cand & (x_e >= 0) & (x_e != s[:, None])
        e_k = torch.sort(torch.where(cand, eiota[None, :], e), dim=1).values[:, :k_don]
        valid_k = e_k < e
        e_k_safe = e_k.clamp(0, e - 1)
        x_k = torch.gather(x_e, 1, e_k_safe).clamp(0, n - 1)
        alt, has_alt = masked_first(tables.wl[rows[:, None], x_k], taken,
                                    torch.gather(entry, 1, x_k) + 1)
        swap_ok = valid_k & has_alt
        any_swap = swap_ok.any(dim=1)
        do_free = active & free_ok
        do_swap = active & ~free_ok & any_swap
        do_yield = active & ~free_ok & ~any_swap & cand.any(dim=1)
        take = do_free | do_swap | do_yield
        k_sel = torch.where(do_swap, first_true(swap_ok)[0], 0)[:, None]
        e_s = torch.where(do_free, f_free, torch.gather(e_k_safe, 1, k_sel)[:, 0])
        l_s = wl_s[rows, e_s.clamp(0, e - 1)]
        x_sel = torch.gather(x_k, 1, k_sel)[:, 0]
        a_sel = torch.gather(alt, 1, k_sel)[:, 0].clamp(0, e - 1)
        l_alt = tables.wl[rows, x_sel, a_sel]
        x_entry = entry[rows, x_sel]
        lock[rows, s] = torch.where(take, l_s, lock[rows, s])
        entry[rows, s] = torch.where(take, e_s, entry[rows, s])
        cursor[rows, s] = torch.where(take, e_s, cursor[rows, s])
        lock[rows, x_sel] = torch.where(do_swap, l_alt,
                                        torch.where(do_yield, -1, lock[rows, x_sel]))
        entry[rows, x_sel] = torch.where(do_swap, a_sel,
                                         torch.where(do_yield, -1, entry[rows, x_sel]))
        cursor[rows, x_sel] = torch.where(do_swap, a_sel,
                                          torch.where(do_yield, x_entry + 1, cursor[rows, x_sel]))
        return torch.where(do_yield, x_sel, s), do_yield

    tried = torch.zeros((t, n), dtype=torch.bool, device=dev)
    for _ in range(min(SEEKERS, n)):
        starved = (lock < 0) & ~tried & (tables.n_valid > 0)
        any_s = starved.any(dim=1)
        s = first_true(starved)[0]
        tried[rows, s] = tried[rows, s] | any_s
        active = any_s
        for _ in range(n):
            s, active = hop(s, active)
    return lock, entry, cursor


def protocol_lta(tables: Tables) -> torch.Tensor:
    """(T, N) line held by each ring at the end, -1 where starved."""
    t, n, _ = tables.wl.shape
    dev = tables.wl.device
    order = torch.argsort(tables.n_valid, dim=1, stable=True)
    has_peaks = tables.n_valid > 0
    lock = torch.full((t, n), -1, dtype=torch.int64, device=dev)
    entry = torch.full((t, n), -1, dtype=torch.int64, device=dev)
    cursor = torch.zeros((t, n), dtype=torch.int64, device=dev)
    halted = torch.zeros(t, dtype=torch.bool, device=dev)
    for _ in range(4 * n):
        live = ((lock < 0) & has_peaks).any(dim=1)
        if not bool((live & ~halted).any()):
            break
        new = _probe(tables, order, lock, entry, cursor)
        new = _augment(tables, *new)
        l2, e2, c2 = new
        c2 = torch.where(l2 < 0, 0, c2)
        changed = (l2 != lock).any(dim=1) | (e2 != entry).any(dim=1) | (c2 != cursor).any(dim=1)
        h = halted[:, None]
        lock, entry, cursor = (torch.where(h, old, x) for old, x in
                               ((lock, l2), (entry, e2), (cursor, c2)))
        halted = halted | (live & ~changed)
    return torch.where(entry >= 0, lock, -1)

"""Single-Step Matching (paper §V-C, Fig. 12-13).

Builds the Lock Allocation Table implicitly: within a sub-chain (rings
between two RI=phi cuts, in target-ordering chain order), aligning search
tables by relation indices makes entry ``e`` of chain position p sit at LAT
row ``e + off_p`` with off_{p+1} = off_p - RI_p.  The diagonal assignment
"head takes its first entry, every following ring takes the next row" then
reduces to the closed form

    e_p = (p - h) + sum_{q=h..p-1} RI_q        (h = sub-chain head position)

with the paper's overrides: sub-chain heads take their first entry and
sub-chain tails their last (Fig. 13(b)(c)).  With no phi at all the cycle is
cut at the wrap link and the diagonal starts at chain position 0 (Fig. 13(a)).

The phi pattern differs per trial, so segmentation is data-dependent; it is
resolved with a doubled pass over chain positions (2N fixed steps),
vectorized over trials.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from .relation import _PHI, RI_PHI, ChainSpec  # noqa: F401  (RI_PHI: the reference's name here)
from .search_table import SearchTables, first_true


class Assignment(NamedTuple):
    """Per-physical-ring lock outcome of an oblivious arbitration."""

    entry: torch.Tensor   # (T, N) int32 chosen search-table entry index, -1 if none
    wl: torch.Tensor      # (T, N) int32 laser line id of the chosen entry, -1 if none
    delta: torch.Tensor   # (T, N) tuning distance, +inf if none


def gather_assignment(tables: SearchTables, entry: torch.Tensor) -> tuple:
    """(wl, delta) of each ring's chosen entry; -1 / +inf where entry < 0."""
    t, n = entry.shape
    rows = torch.arange(t, device=entry.device)[:, None]
    rings = torch.arange(n, device=entry.device)[None, :]
    e_safe = entry.clamp(0, tables.max_entries - 1).long()
    locked = entry >= 0
    wl = torch.where(locked, tables.wl[rows, rings, e_safe], -1)
    delta = torch.where(locked, tables.delta[rows, rings, e_safe], torch.inf)
    return wl, delta


def single_step_matching(
    tables: SearchTables, ri_chain: torch.Tensor, spec: ChainSpec
) -> Assignment:
    """ri_chain: (T, N) chain-oriented relation indices (RI_PHI = cut)."""
    T, n = ri_chain.shape
    dev = ri_chain.device
    chain = torch.as_tensor(spec.chain, dtype=torch.long, device=dev)  # pos -> ring
    cut = ri_chain == _PHI                                # (T, N) link p->p+1 broken
    any_cut = cut.any(dim=1)                              # (T,)
    # Head at position p iff the incoming link (p-1 -> p) is broken; with no
    # phi anywhere, cut the cycle at the wrap link => artificial head at 0.
    prev_cut = torch.roll(cut, 1, dims=1)
    at_zero = (torch.arange(n, device=dev) == 0)[None, :]
    is_head = torch.where(any_cut[:, None], prev_cut, at_zero)

    ri_safe = torch.where(cut, 0, ri_chain)

    # Doubled pass: positions 0..2N-1; state (u, acc) = (distance from head,
    # accumulated RI since head).  The second lap fixes wrapped sub-chains.
    u = torch.zeros(T, dtype=torch.int32, device=dev)
    acc = torch.zeros(T, dtype=torch.int32, device=dev)
    e_diag = torch.zeros((T, n), dtype=torch.int32, device=dev)
    for step in range(2 * n):
        p = step % n
        head = is_head[:, p]
        u = torch.where(head, 0, u + 1)
        acc = torch.where(head, 0, acc + ri_safe[:, (p - 1) % n])
        e_diag[:, p] = u + acc

    # LAT rows are modular: a laser line reappears N rows apart through the
    # adjacent FSR, so "the next row" is taken mod N with the smallest
    # in-table representative (bluest alias, minimal tuning power).
    nv_chain = tables.n_valid[:, chain]                   # (T, N) by position

    # Sub-chains anchored at a real phi cut: head -> first entry, diagonal
    # mod N inside.
    e_anchored = e_diag % n

    # No phi anywhere (Fig. 13(a)): scan cyclic offsets rho0 and take the
    # first that fits every search table.
    rho = torch.arange(n, dtype=torch.int32, device=dev)
    e_cand = (e_diag[:, None, :] + rho[None, :, None]) % n   # (T, rho, pos)
    feas = torch.all(e_cand < nv_chain[:, None, :], dim=-1)  # (T, rho)
    rho0, _ = first_true(feas)
    e_free = torch.take_along_dim(e_cand, rho0.long()[:, None, None], dim=1)[:, 0, :]

    e_pos = torch.where(any_cut[:, None], e_anchored, e_free)

    # Tail override: ring at position p with a real outgoing cut takes its
    # LAST entry (paper Fig. 13(b)(c)).
    e_pos = torch.where(cut, nv_chain - 1, e_pos)

    valid = (e_pos >= 0) & (e_pos < nv_chain)
    e_pos = torch.where(valid, e_pos, -1)

    # Scatter back from chain position to physical ring index.
    entry = torch.full((T, n), -1, dtype=torch.int32, device=dev)
    entry[:, chain] = e_pos.to(torch.int32)
    wl, delta = gather_assignment(tables, entry)
    return Assignment(entry=entry, wl=wl, delta=delta)

"""Wavelength-oblivious Relation Search (paper §V-B, Fig. 10-11).

The record phase runs N relation searches on consecutive pairs of the target
spectral ordering s.  For the pair at chain position t:

    a_t = pi[t], b_t = pi[(t+1) % N]        (pi = argsort(s))

the physically-upstream ring min(a, b) is the *aggressor* (light precedence,
§V-B) and the other the *victim*.  A unit search locks the aggressor onto one
entry ``e`` of its table, capturing that laser line for every ring downstream;
the victim re-runs its wavelength search and observes the first masked entry
``m`` of its own table.  The unit relation index is RI = m - e.

RS combines Lock-to-Last and Lock-to-First unit searches (footnote 8):
  * both valid and congruent mod N  -> valid RI
  * exactly one valid              -> that RI
  * otherwise                       -> RI = phi  (encoded as RI_PHI)

VT-RS retries with Lock-to-Second when RS yields phi (Fig. 11(c)(d)).
All N pair searches run at once over a pair axis.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .search_table import SearchTables, first_true

RI_PHI = np.int32(-(10**6))  # sentinel: relation not found
_PHI = int(RI_PHI)


class ChainSpec(NamedTuple):
    """Static per-pair metadata derived from the target ordering s."""

    aggressor: np.ndarray  # (N,) physical ring index of pair aggressor
    victim: np.ndarray     # (N,) physical ring index of pair victim
    forward: np.ndarray    # (N,) bool: aggressor is the chain-earlier element
    chain: np.ndarray      # (N,) pi[t] = ring at chain position t


def chain_spec(s) -> ChainSpec:
    s = np.asarray(s)
    n = s.shape[0]
    pi = np.argsort(s).astype(np.int32)
    first = pi                                  # chain position t
    second = pi[(np.arange(n) + 1) % n]         # chain position t+1
    aggressor = np.minimum(first, second)
    victim = np.maximum(first, second)
    forward = aggressor == first                # RI measured along the chain?
    return ChainSpec(aggressor=aggressor, victim=victim, forward=forward, chain=pi)


def _unit_relation_search(tables: SearchTables, agg: torch.Tensor, vic: torch.Tensor,
                          entry: torch.Tensor) -> torch.Tensor:
    """Aggressor injections for all pairs at once.

    agg, vic: (P,) long ring indices; entry: (T, P) aggressor entry index.
    Returns (T, P) int32 RI = masked_victim_index - entry, or RI_PHI.
    """
    rows = torch.arange(tables.delta.shape[0], device=entry.device)[:, None]
    e_ok = (entry >= 0) & (entry < tables.n_valid[:, agg])
    e_safe = entry.clamp(0, tables.max_entries - 1).long()
    line = tables.wl[rows, agg, e_safe]                   # (T, P) captured line
    vic_wl = tables.wl[:, vic, :]                         # (T, P, E)
    hit = (vic_wl == line[..., None]) & (vic_wl >= 0)
    first, found = first_true(hit)
    masked = torch.where(found, first, -1)
    ri = masked - entry
    return torch.where(e_ok & (masked >= 0), ri, _PHI).to(torch.int32)


def _combine(ri_a: torch.Tensor, ri_b: torch.Tensor, n_ch: int) -> torch.Tensor:
    """Footnote-8 combination of two unit searches.

    ``%`` is the floored remainder (as ``jnp.mod``), not ``fmod``: the
    operands are negative around RI_PHI.
    """
    a_ok, b_ok = ri_a != _PHI, ri_b != _PHI
    congruent = (ri_a - ri_b) % n_ch == 0
    both = a_ok & b_ok
    out = torch.where(both & congruent, ri_a, _PHI)
    out = torch.where(a_ok & ~b_ok, ri_a, out)
    out = torch.where(b_ok & ~a_ok, ri_b, out)
    return out.to(torch.int32)


def relation_search(
    tables: SearchTables, spec: ChainSpec, *, variation_tolerant: bool = False
) -> torch.Tensor:
    """Full record phase.  Returns (T, N) int32 chain-oriented relation indices.

    Output ri[t, pos]: ST(pi[pos])[e] and ST(pi[pos+1])[e + ri] refer to the
    same laser line; RI_PHI where no relation was found.
    """
    n = spec.chain.shape[0]
    dev = tables.wl.device
    agg = torch.as_tensor(spec.aggressor, dtype=torch.long, device=dev)
    vic = torch.as_tensor(spec.victim, dtype=torch.long, device=dev)
    last = tables.n_valid[:, agg] - 1                    # (T, N) per pair
    first = torch.zeros_like(last)
    ri = _combine(
        _unit_relation_search(tables, agg, vic, last),
        _unit_relation_search(tables, agg, vic, first),
        n,
    )
    if variation_tolerant:
        second = torch.clamp(last, max=1)
        ri_vt = _unit_relation_search(tables, agg, vic, second)
        ri = torch.where(ri == _PHI, ri_vt, ri)
    # Orient along the chain: RI was measured aggressor->victim.
    forward = torch.as_tensor(spec.forward, device=dev)[None, :]
    return torch.where(forward | (ri == _PHI), ri, -ri)

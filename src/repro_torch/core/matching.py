"""Batched exact bipartite matching for the Lock-to-Any ideal arbiter.

Ring i can take laser line k iff reach[t, i, k]; LtA succeeds iff the
(ring x line) graph of a trial holds a perfect matching, and the LtA minimum
mean TR is the bottleneck threshold of the scaled residuals.  Both go
through the kernel wrappers of ``repro_torch.kernels.bitmask_match``
(``match`` and ``bottleneck``), whose plain versions run on the CPU.

Adjacencies are packed one int64 word per ring (bit k = line k), so every
configuration up to 64 channels takes one word: the reference's int32 word
read as uint32 for N <= 32, and its two little-endian uint32 words combined
for 32 < N <= 64.
"""
from __future__ import annotations

import torch

from ..kernels.bitmask_match import MAX_N, bottleneck_threshold, perfect_matching


def adjacency_bitmask(reach: torch.Tensor) -> torch.Tensor:
    """(T, N, N) bool reach[t, ring, line] -> (T, N) int64 line bitmasks."""
    n = reach.shape[-1]
    if not 1 <= n <= MAX_N:
        raise ValueError(f"adjacency_bitmask: N must be in [1, {MAX_N}], got {n}")
    bits = torch.ones(n, dtype=torch.int64, device=reach.device) << torch.arange(
        n, dtype=torch.int64, device=reach.device)
    # Distinct bits: the sum is their OR (bit 63 wraps to the sign, as in OR).
    return torch.where(reach, bits, 0).sum(dim=-1)


def max_matching(adj: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Kuhn over all rings -> (match_wl (T, N) ring -> line, match_ring
    (T, N) line -> ring), int32, -1 where unmatched."""
    match_wl, _ = perfect_matching(adj)
    t, n = match_wl.shape
    match_ring = torch.full((t, n + 1), -1, dtype=torch.int32, device=adj.device)
    rings = torch.arange(n, dtype=torch.int32, device=adj.device).expand(t, n)
    match_ring.scatter_(1, torch.where(match_wl >= 0, match_wl, n).long(), rings)
    return match_wl, match_ring[:, :n]


def has_perfect_matching(reach: torch.Tensor) -> torch.Tensor:
    """(T, N, N) bool reach -> (T,) bool perfect matching existence."""
    return perfect_matching(adjacency_bitmask(reach))[1]


# Minimum t such that a perfect matching exists in {weights <= t}: (T, N, N)
# scaled residuals (ring x line) -> (T,) float32, one of each trial's weights.
bottleneck_matching_threshold = bottleneck_threshold

"""Batched bipartite matching for the ideal Lock-to-Any arbiter.

Two wrappers over the (ring x line) graph of each trial; each launches its
CUDA kernel for CUDA tensors and runs its plain version for CPU tensors:

``perfect_matching`` (``csrc/match.cu``): Kuhn's augmenting-path matching on
per-ring line bitmasks, one int64 word per ring (bit k = line k, N <= 64).
Rings are inserted in index order; each BFS takes the lowest free line of a
level and gives a newly reached line the lowest-index ring that reaches it,
so ``match_wl`` is defined by that search order and equals the reference's
on every trial.

``bottleneck_threshold`` (``csrc/bottleneck.cu``): the least t such that
{weights <= t} holds a perfect matching, the ideal LtA minimum mean TR.  The
kernel is the reference's single-pass bottleneck sweep; the plain version is
an independent formulation, a binary search over each trial's sorted N^2
weights with a Kuhn existence query per step.
"""
from __future__ import annotations

import math

import torch

from ..core.search_table import first_true
from . import _build

MAX_N = 64


def _check_n(name: str, n: int) -> None:
    if not 1 <= n <= MAX_N:
        raise ValueError(f"{name}: N must be in [1, {MAX_N}], got {n}")


def unpack_words(adj: torch.Tensor) -> torch.Tensor:
    """(T, N) int64 line bitmasks -> (T, N, N) bool reach[t, ring, line]."""
    n = adj.shape[-1]
    lines = torch.arange(n, dtype=torch.int64, device=adj.device)
    return ((adj[..., None] >> lines) & 1).bool()


def kuhn_plain(reach: torch.Tensor) -> torch.Tensor:
    """(T, N, N) bool -> (T, N) int32 ring -> matched line, -1 if unmatched.

    Batched Kuhn on bool lanes with fixed trip counts (N rings x (N BFS
    levels + N walk-back steps)), in the kernel's search order.
    """
    t, n, _ = reach.shape
    dev = reach.device
    rows = torch.arange(t, device=dev)
    ring_iota = torch.arange(n, dtype=torch.int32, device=dev)[None, :, None]
    match_wl = torch.full((t, n), -1, dtype=torch.int32, device=dev)
    match_rg = torch.full((t, n), -1, dtype=torch.int32, device=dev)
    for i in range(n):
        matched = match_rg >= 0
        has_line = match_wl >= 0
        line_of = match_wl.clamp(min=0).long()
        start = reach[:, i, :]
        parent = torch.where(start, i, -1).to(torch.int32)
        frontier, visited = start, start
        free_wl = torch.full((t,), -1, dtype=torch.int32, device=dev)
        for _ in range(n):
            first, hit = first_true(frontier & ~matched)
            free_wl = torch.where(hit & (free_wl < 0), first, free_wl)
            # Matched rings whose line is in the frontier expand it; a newly
            # reached line's parent is the lowest such ring reaching it.
            in_front = has_line & torch.gather(frontier, 1, line_of)
            newly = reach & in_front[:, :, None] & ~visited[:, None, :]
            reached = newly.any(dim=1)
            par_new = torch.where(newly, ring_iota, n).amin(dim=1)
            cont = (free_wl < 0)[:, None]
            parent = torch.where(cont & reached, par_new, parent)
            frontier = reached & cont
            visited = visited | reached
        k, active = free_wl, free_wl >= 0
        for _ in range(n):
            k_safe = k.clamp(min=0).long()
            r = parent[rows, k_safe].clamp(min=0).long()
            prev = match_wl[rows, r]
            match_wl[rows, r] = torch.where(active, k_safe.to(torch.int32), prev)
            match_rg[rows, k_safe] = torch.where(active, r.to(torch.int32),
                                                 match_rg[rows, k_safe])
            active = active & (r != i) & (prev >= 0)
            k = torch.where(active, prev, k)
    return match_wl


def perfect_matching_plain(adj: torch.Tensor):
    """Plain PyTorch version: (match_wl (T, N) int32, ok (T,) bool)."""
    _check_n("match", adj.shape[-1])
    match_wl = kuhn_plain(unpack_words(adj))
    return match_wl, (match_wl >= 0).all(dim=1)


def perfect_matching(adj: torch.Tensor):
    """(T, N) int64 per-ring line bitmasks -> (match_wl (T, N) int32, ok (T,)).

    ``ok`` is True where every ring is matched.  CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    if adj.device.type == "cpu":
        return perfect_matching_plain(adj)
    t, n = _build.check_inputs("match", (adj,), MAX_N, dtype=torch.int64)
    match_wl = torch.empty((t, n), dtype=torch.int32, device=adj.device)
    ok = torch.empty((t,), dtype=torch.bool, device=adj.device)
    with torch.cuda.device(adj.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().match_launch(
            adj.data_ptr(), t, n, match_wl.data_ptr(), ok.data_ptr(), stream)
    _build.check(err, "match")
    perfect_matching.launches += 1
    return match_wl, ok


perfect_matching.launches = 0


def bottleneck_threshold_plain(weights: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: binary search over each trial's sorted weights,
    ceil(log2 N^2) + 1 Kuhn existence queries.  (T,) float32."""
    t, n, _ = weights.shape
    _check_n("bottleneck", n)
    cand = torch.sort(weights.reshape(t, n * n), dim=1).values
    rows = torch.arange(t, device=weights.device)
    lo = torch.zeros(t, dtype=torch.long, device=weights.device)
    hi = torch.full((t,), n * n - 1, dtype=torch.long, device=weights.device)
    for _ in range(math.ceil(math.log2(n * n)) + 1):
        mid = (lo + hi) // 2
        thr = cand[rows, mid]
        ok = (kuhn_plain(weights <= thr[:, None, None]) >= 0).all(dim=1)
        lo = torch.where(ok, lo, mid + 1)
        hi = torch.where(ok, mid, hi)
    return cand[rows, hi]


def bottleneck_threshold(weights: torch.Tensor) -> torch.Tensor:
    """(T, N, N) float32 weights (ring x line) -> (T,) float32 thresholds.

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if weights.device.type == "cpu":
        return bottleneck_threshold_plain(weights)
    t, n = _build.check_inputs("bottleneck", (weights,), MAX_N, square=True)
    thr = torch.empty((t,), dtype=torch.float32, device=weights.device)
    with torch.cuda.device(weights.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().bottleneck_launch(
            weights.data_ptr(), t, n, thr.data_ptr(), stream)
    _build.check(err, "bottleneck")
    bottleneck_threshold.launches += 1
    return thr


bottleneck_threshold.launches = 0

"""Batched masked re-search, the protocol engine's unit primitive.

``masked_research`` launches the CUDA kernel (``csrc/probe.cu``) for CUDA
tensors and runs ``masked_research_plain`` for CPU tensors.  For C search
table rows per trial it returns the first entry at or after the row's
``floor`` whose line id is valid and not captured.  A line id >= L counts as
not captured (the reference routes it to an all-False pad column), a floor
>= E finds nothing and a negative floor admits every entry.

The plain version gathers the captured mask, padded with one False column,
at the entries' line ids and takes ``first_true`` of the visible entries.
"""
from __future__ import annotations

import torch

from ..core.search_table import first_true
from . import _build


def masked_research_plain(wl: torch.Tensor, taken: torch.Tensor, floor: torch.Tensor):
    """Plain PyTorch version -> (first (T, C) int32 or -1, found (T, C) bool)."""
    t, c, e = wl.shape
    n_lines = taken.shape[1]
    pad = torch.cat([taken, taken.new_zeros((t, 1))], dim=1)          # (T, L + 1)
    idx = torch.where((wl < 0) | (wl >= n_lines), n_lines, wl).long()
    taken_at = torch.gather(pad, 1, idx.reshape(t, c * e)).reshape(t, c, e)
    eiota = torch.arange(e, dtype=torch.int32, device=wl.device)
    vis = (wl >= 0) & ~taken_at & (eiota >= floor[..., None])
    first, found = first_true(vis)
    return torch.where(found, first, -1), found


def _check(wl, taken, floor) -> tuple[int, int, int, int]:
    if wl.dim() != 3 or taken.dim() != 2 or floor.dim() != 2:
        raise ValueError("probe: wl must be (T, C, E), taken (T, L), floor (T, C)")
    t, c, e = wl.shape
    if taken.shape[0] != t or tuple(floor.shape) != (t, c):
        raise ValueError(f"probe: shapes disagree: wl {tuple(wl.shape)}, taken "
                         f"{tuple(taken.shape)}, floor {tuple(floor.shape)}")
    if c < 1 or e < 1 or taken.shape[1] < 1:
        raise ValueError("probe: C, E and L must be >= 1")
    _build.check_trials("probe", t)
    dev = wl.device
    if dev.type != "cuda" or taken.device != dev or floor.device != dev:
        raise ValueError("probe: all inputs must lie on one CUDA device")
    for a, dtype in ((wl, torch.int32), (taken, torch.bool), (floor, torch.int32)):
        if a.dtype != dtype:
            raise TypeError(f"probe: expected {dtype}, got {a.dtype}")
    if not (wl.is_contiguous() and taken.is_contiguous() and floor.is_contiguous()):
        raise ValueError("probe: inputs must be contiguous")
    return t, c, e, taken.shape[1]


def masked_research(wl: torch.Tensor, taken: torch.Tensor, floor: torch.Tensor):
    """wl (T, C, E) int32 line ids, taken (T, L) bool captured lines, floor
    (T, C) int32 first admissible entry -> (first (T, C) int32 entry or -1,
    found (T, C) bool).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if wl.device.type == "cpu":
        return masked_research_plain(wl, taken, floor)
    t, c, e, n_lines = _check(wl, taken, floor)
    dev = wl.device
    first = torch.empty((t, c), dtype=torch.int32, device=dev)
    found = torch.empty((t, c), dtype=torch.bool, device=dev)
    args = (wl.data_ptr(), taken.data_ptr(), floor.data_ptr(), t, c, e, n_lines,
            first.data_ptr(), found.data_ptr())
    # The launch goes to the current stream of the inputs' device; the device
    # guard is entered only when another device is current.
    if dev.index == torch.cuda.current_device():
        err = _launch(args, dev.index)
    else:
        with torch.cuda.device(dev):
            err = _launch(args, dev.index)
    _build.check(err, "probe")
    masked_research.launches += 1
    return first, found


def _launch(args, index: int) -> int:
    return _build.library().probe_launch(*args, torch._C._cuda_getCurrentRawStream(index))


masked_research.launches = 0

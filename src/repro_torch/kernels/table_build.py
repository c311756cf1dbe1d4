"""Search-table construction: the first E peaks of every ring's search.

``build_tables`` launches the CUDA kernel (``csrc/table_build.cu``) for CUDA
tensors and runs ``build_tables_plain`` for CPU tensors.  For each (trial,
ring) the candidates are

    delta = (laser_k - ring_i) - j * fsr_i,   j in [-max_alias, max_alias],

kept when 0 <= delta <= tr_i and line k is visible; the table holds the first
E in (delta, flat index k * (2J+1) + j) order.  The plain version is the
dense formulation of the reference's ``build_search_tables_dense``: the full
candidate tensor and a stable sort of the candidate axis.
"""
from __future__ import annotations

import torch

from . import _build

MAX_N = 64
MAX_E = 192
MAX_ALIAS = 32767   # the kernel keys a candidate as (k << 16) | (j + J)


def table_width(n: int, max_alias: int, max_entries: int) -> int:
    """E: like a sort of the candidate axis, at most N * (2J+1) entries exist."""
    return min(max_entries, n * (2 * max_alias + 1))


def build_tables_plain(laser, ring, fsr, tr, *, visible=None, max_alias: int,
                       max_entries: int):
    """Plain PyTorch version -> (delta (T, N, E), wl (T, N, E), n_valid (T, N))."""
    t, n = laser.shape
    n_j = 2 * max_alias + 1
    e = table_width(n, max_alias, max_entries)
    j = torch.arange(-max_alias, max_alias + 1, dtype=torch.float32, device=laser.device)
    d = (laser[:, None, :, None] - ring[:, :, None, None]) - j * fsr[:, :, None, None]
    ok = (d >= 0.0) & (d <= tr[:, :, None, None])                    # (T, N, N, J)
    if visible is not None:
        ok &= visible[:, None, :, None] if visible.dim() == 2 else visible[..., None]
    dflat = torch.where(ok, d, torch.inf).reshape(t, n, n * n_j)
    delta, order = torch.sort(dflat, dim=-1, stable=True)
    delta, order = delta[..., :e].contiguous(), order[..., :e]
    finite = torch.isfinite(delta)
    wl = torch.where(finite, order // n_j, -1).to(torch.int32)
    n_valid = finite.sum(dim=-1, dtype=torch.int32)
    return delta, wl, n_valid


def build_tables(laser, ring, fsr, tr, *, visible=None, max_alias: int,
                 max_entries: int):
    """(T, N) float32 inputs (tr = actual per-ring TR) -> core-layout tables.

    visible: optional bool mask of lines on the bus, (T, N_wl) or
    (T, N_ring, N_wl); None = all lines visible.  CPU tensors take the plain
    version; CUDA tensors launch the kernel.
    """
    if laser.device.type == "cpu":
        return build_tables_plain(laser, ring, fsr, tr, visible=visible,
                                  max_alias=max_alias, max_entries=max_entries)
    args = (laser, ring, fsr, tr)
    t, n = _build.check_inputs("table_build", args, MAX_N)
    if visible is not None:
        if visible.device != laser.device or visible.dtype != torch.bool:
            raise ValueError("table_build: visible must be a bool tensor on the "
                             "inputs' device")
        if tuple(visible.shape) not in ((t, n), (t, n, n)):
            raise ValueError(f"table_build: visible must be (T, N) or (T, N, N), "
                             f"got {tuple(visible.shape)}")
        if not visible.is_contiguous():
            raise ValueError("table_build: visible must be contiguous")
    if not 0 <= max_alias <= MAX_ALIAS:
        raise ValueError(f"table_build: max_alias must be in [0, {MAX_ALIAS}], "
                         f"got {max_alias}")
    e = table_width(n, max_alias, max_entries)
    if not 1 <= e <= MAX_E:
        raise ValueError(f"table_build: E must be in [1, {MAX_E}], got {e}")
    dev = laser.device
    delta = torch.empty((t, n, e), dtype=torch.float32, device=dev)
    wl = torch.empty((t, n, e), dtype=torch.int32, device=dev)
    n_valid = torch.empty((t, n), dtype=torch.int32, device=dev)
    if visible is None:
        vis_ptr, vis_ts, vis_rs = None, 0, 0
    else:
        vis_ptr = visible.data_ptr()
        vis_ts = visible.stride(0)
        vis_rs = visible.stride(1) if visible.dim() == 3 else 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().table_build_launch(
            *(a.data_ptr() for a in args), vis_ptr, vis_ts, vis_rs,
            t, n, max_alias, e, delta.data_ptr(), wl.data_ptr(), n_valid.data_ptr(),
            stream,
        )
    _build.check(err, "table_build")
    build_tables.launches += 1
    return delta, wl, n_valid


build_tables.launches = 0


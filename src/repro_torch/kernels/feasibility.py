"""Ideal LtD/LtC feasibility: the per-trial minimum mean tuning range.

``feasibility`` launches the CUDA kernel (``csrc/feasibility.cu``) for CUDA
tensors and runs ``feasibility_plain`` for CPU tensors.  Both compute

    residual[t, i, k] = ((laser_k - ring_i) mod fsr_i) / tr_unit_i
    ltd[t] = max_i residual[t, i, s_i]
    ltc[t] = min_c max_i residual[t, i, (s_i + c) mod N]

with ``torch.remainder`` semantics, so the two agree bit for bit.
"""
from __future__ import annotations

import torch

from ..core.reach import scaled_residual
from ..core.sampling import SystemBatch
from . import _build

MAX_N = 64


def per_shift_min_tr(laser, ring, fsr, tr_unit, s) -> torch.Tensor:
    """(N, T): the minimum mean TR of every cyclic shift c of the ordering s."""
    res = scaled_residual(SystemBatch(laser, ring, fsr, tr_unit))   # (T, N, N)
    n = res.shape[-1]
    rings = torch.arange(n, device=res.device)
    s = torch.as_tensor(s, dtype=torch.long, device=res.device)
    return torch.stack([res[:, rings, (s + c) % n].amax(dim=-1) for c in range(n)])


def feasibility_plain(laser, ring, fsr, tr_unit, s):
    """Plain PyTorch version: (ltd_min_tr, ltc_min_tr), each (T,) float32."""
    per_shift = per_shift_min_tr(laser, ring, fsr, tr_unit, s)
    return per_shift[0], per_shift.amin(dim=0)


def feasibility(laser, ring, fsr, tr_unit, s):
    """(T, N) float32 system batch and ordering s -> (ltd (T,), ltc (T,)).

    CPU tensors take the plain version; CUDA tensors launch the kernel.
    """
    if laser.device.type == "cpu":
        return feasibility_plain(laser, ring, fsr, tr_unit, s)
    args = (laser, ring, fsr, tr_unit)
    t, n = _build.check_inputs("feasibility", args, MAX_N)
    s_dev = torch.as_tensor(s, dtype=torch.int32).to(laser.device).contiguous()
    if s_dev.shape != (n,):
        raise ValueError(f"s must have shape ({n},), got {tuple(s_dev.shape)}")
    ltd = torch.empty(t, dtype=torch.float32, device=laser.device)
    ltc = torch.empty(t, dtype=torch.float32, device=laser.device)
    with torch.cuda.device(laser.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _build.library().feasibility_launch(
            *(a.data_ptr() for a in args), s_dev.data_ptr(), t, n,
            ltd.data_ptr(), ltc.data_ptr(), stream,
        )
    _build.check(err, "feasibility")
    feasibility.launches += 1
    return ltd, ltc


feasibility.launches = 0


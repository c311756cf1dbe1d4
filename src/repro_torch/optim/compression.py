"""Top-k gradient compression with error feedback (the reference's
``repro.optim.compression``).

For cross-pod data parallelism over *degraded* optical links (lanes lost to
arbitration failures), the runtime can trade gradient fidelity for wire
bytes: each step transmits only the top-k fraction of gradient magnitudes
per tensor; the residual accumulates locally (error feedback) so the
optimizer sees an unbiased long-run signal.
"""
from __future__ import annotations

from typing import Any, NamedTuple, Tuple

import torch

from ..core.sampling import resolve_device
from ..tree import tree_map, tree_unflatten


class FeedbackState(NamedTuple):
    residual: Any   # same tree as grads


def init_feedback(grads_shape, *, device=None) -> FeedbackState:
    """Zero float32 residuals of ``grads_shape``'s leaves' shapes, on each
    leaf's device where it is a tensor with storage, else on ``device``
    (CUDA unless named)."""
    def zeros(s):
        dev = s.device if isinstance(s, torch.Tensor) and s.device.type != "meta" \
            else resolve_device(device)
        return torch.zeros(tuple(s.shape), dtype=torch.float32, device=dev)

    return FeedbackState(residual=tree_map(zeros, grads_shape))


def _topk_mask(x, k_frac: float):
    """1 where |x| is at least the k-th largest |x| (ties at the threshold
    are kept), else 0; in ``x``'s dtype."""
    flat = torch.abs(x.reshape(-1))
    k = max(1, int(k_frac * flat.numel()))
    thresh = torch.topk(flat, k).values[-1]
    return (torch.abs(x) >= thresh).to(x.dtype)


def compress(grads, state: FeedbackState, k_frac: float = 0.1
             ) -> Tuple[Any, FeedbackState, dict]:
    """Returns (sparse grads to transmit, new feedback state, stats).

    Transmitted tree has the dense shape with zeros off-support (byte
    accounting uses 2*k of the dense payload: values + indices).
    """
    def one(g, r):
        g32 = g.float() + r
        send = g32 * _topk_mask(g32, k_frac)
        return send.to(g.dtype), g32 - send

    pairs = []

    def send_of(g, r):
        pairs.append(one(g, r))
        return pairs[-1][0]

    send = tree_map(send_of, grads, state.residual)
    resid = tree_unflatten(grads, [r for _, r in pairs])
    return send, FeedbackState(residual=resid), {
        "wire_fraction": 2.0 * k_frac,  # values + indices vs dense
    }


def compression_for_bandwidth(bandwidth_fraction: float) -> float:
    """Scheduler policy: pick the top-k fraction so cross-pod gradient
    traffic fits the degraded link budget (identity at full bandwidth)."""
    if bandwidth_fraction >= 0.999:
        return 1.0
    # wire_fraction = 2k must be <= bandwidth_fraction
    return max(0.01, bandwidth_fraction / 2.0)

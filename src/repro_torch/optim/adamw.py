"""AdamW with dtype-configurable moments and global-norm clipping.

Hand-rolled, as the reference's ``repro.optim.adamw``: for >=30B-param
archs the moments are bf16 (halving optimizer memory) with fp32 update
math.  The reference returns new trees and lets XLA reuse the donated
buffers; ``apply`` here updates the parameters and moments in place under
``torch.no_grad()`` and returns the same tensors (a functional update of
internlm2-1.8b's 7.6 GB of fp32 parameters would need ~23 GB more).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, NamedTuple

import torch

from ..tree import tree_leaves, tree_map


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr_peak: float = 3e-4
    lr_min: float = 3e-5
    warmup_steps: int = 100
    decay_steps: int = 10_000
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    moment_dtype: str = "float32"


class OptState(NamedTuple):
    """The reference's fields, so checkpoints interoperate: ``step`` is a
    0-d int32 tensor on the parameters' device."""

    step: torch.Tensor
    mu: Any
    nu: Any


def _div(x, d):
    """``x / d`` as a true float32 division (on CUDA a Python divisor is
    applied as a reciprocal product, an ulp from the reference's divide)."""
    return x / torch.tensor(d, dtype=torch.float32, device=x.device)


def lr_at(cfg: AdamWConfig, step):
    """Linear warmup then cosine decay to lr_min (float32, on ``step``'s
    device; an int step gives a CPU tensor)."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = _div(cfg.lr_peak * step, max(cfg.warmup_steps, 1))
    prog = torch.clamp(
        _div(step - cfg.warmup_steps, max(cfg.decay_steps - cfg.warmup_steps, 1)), 0.0, 1.0
    )
    cos = cfg.lr_min + 0.5 * (cfg.lr_peak - cfg.lr_min) * (1 + torch.cos(math.pi * prog))
    return torch.where(step < cfg.warmup_steps, warm, cos)


def init(cfg: AdamWConfig, params) -> OptState:
    """Zero moments in ``cfg.moment_dtype`` on each parameter's device
    (``device="meta"`` parameters give an abstract state)."""
    dt = getattr(torch, cfg.moment_dtype)
    zeros = lambda p: torch.zeros(p.shape, dtype=dt, device=p.device)  # noqa: E731
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    return OptState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu=tree_map(zeros, params),
        nu=tree_map(zeros, params),
    )


def global_norm(tree) -> torch.Tensor:
    leaves = [torch.sum(torch.square(g.float())) for g in tree_leaves(tree)]
    return torch.sqrt(torch.sum(torch.stack(leaves)))


def _f32(t):
    """``t`` as float32: the tensor itself when it is one, else a copy."""
    return t if t.dtype == torch.float32 else t.float()


def _update(cfg: AdamWConfig, p, g, m, v, scale, lr, b1c, b2c) -> None:
    """One leaf's update in place, in the reference's float32 operation
    order, with three leaf-sized float32 temporaries (and a float32 copy of
    each of p, m and v that is not float32)."""
    g32 = g.float() * scale
    t = g32 * (1 - cfg.b1)
    m32 = _f32(m).mul_(cfg.b1).add_(t)
    torch.mul(g32, 1 - cfg.b2, out=t).mul_(g32)
    del g32
    v32 = _f32(v).mul_(cfg.b2).add_(t)
    d = torch.div(v32, b2c, out=t).sqrt_().add_(cfg.eps)     # sqrt(vhat) + eps
    u = torch.div(m32, b1c).div_(d)                           # mhat / (sqrt(vhat) + eps)
    p32 = _f32(p)
    u.add_(torch.mul(p32, cfg.weight_decay, out=d)).mul_(lr)  # lr * step_dir
    p32.sub_(u)
    for dst, src in ((p, p32), (m, m32), (v, v32)):
        if src is not dst:
            dst.copy_(src)


@torch.no_grad()
def apply(cfg: AdamWConfig, params, grads, state: OptState):
    """One AdamW update; returns (params, state, stats) with ``params``,
    the moments and ``state.step`` updated in place."""
    gnorm = global_norm(grads)
    clip = torch.tensor(cfg.clip_norm, dtype=torch.float32, device=gnorm.device)
    scale = torch.clamp(clip / torch.clamp_min(gnorm, 1e-9), max=1.0)
    state.step.add_(1)
    step = state.step.float()
    lr = lr_at(cfg, state.step)
    b1c = 1.0 - torch.pow(cfg.b1, step)
    b2c = 1.0 - torch.pow(cfg.b2, step)
    for p, g, m, v in zip(*(tree_leaves(t) for t in (params, grads, state.mu, state.nu))):
        _update(cfg, p, g, m, v, scale, lr, b1c, b2c)
    return params, state, {"grad_norm": gnorm, "lr": lr}

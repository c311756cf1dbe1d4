"""Train / serve step factories (the reference's ``repro.distributed.steps``).

``train_step``: gradient accumulation over microbatches (the remat'd model
inside), one AdamW update.  ``prefill_step`` / ``decode_step``: the serving
units.  On ``DTensor`` parameters and batches (placed by
``distributed.sharding``) the steps run under the caller's
``ctx.activation_axes``: the gradients come back as ``DTensor``s and the
update runs on each device's shards (``optim.adamw.apply``).
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..distributed.ctx import is_dtensor
from ..models import model as M
from ..models.config import ModelConfig
from ..optim import adamw
from ..tree import tree_leaves, tree_map, tree_unflatten


def _grad_tree(params):
    """``params`` with every leaf a grad-requiring alias of its storage, and
    the aliases in ``tree_leaves`` order."""
    tree = tree_map(lambda p: p.detach().requires_grad_(), params)
    return tree, tree_leaves(tree)


def micro_grads(cfg: ModelConfig, params, batch):
    """One microbatch's (loss, aux metrics, gradients in ``tree_leaves``
    order), detached."""
    tree, leaves = _grad_tree(params)
    with torch.enable_grad():
        l, aux = M.loss_fn(tree, cfg, batch)
        grads = torch.autograd.grad(l, leaves)
    return l.detach(), {k: v.detach() for k, v in aux.items()}, grads


def accumulators(params, dtype):
    """Zero gradient accumulators in ``dtype``, one a parameter leaf (with a
    ``DTensor`` leaf's placements)."""
    return [torch.zeros_like(p, dtype=dtype) if is_dtensor(p)
            else torch.zeros(p.shape, dtype=dtype, device=p.device)
            for p in tree_leaves(params)]


def accumulate(acc, grads, dtype) -> None:
    """``acc += grads`` in ``dtype``, leaf by leaf, in place."""
    for a, g in zip(acc, grads):
        a.add_(g.to(dtype))


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, n_microbatch: int):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    The batch (a dict of tensors on the parameters' device) is split into
    ``n_microbatch`` slices along dim 0; gradients accumulate in
    ``cfg.accum_dtype``, in microbatch order.  ``params`` and ``opt_state``
    are updated in place (``adamw.apply``) and returned; metrics are 0-d
    tensors on the device (nothing is read back to the host).
    """

    def micro(params, batch_slice):
        return micro_grads(cfg, params, batch_slice)

    def train_step(params, opt_state, batch):
        adt = getattr(torch, cfg.accum_dtype)
        if n_microbatch == 1:
            l, aux, grads = micro(params, batch)
            metrics = {"loss": l, **aux}
        else:
            B = batch["tokens"].shape[0]
            if B % n_microbatch:
                raise ValueError(f"batch {B} does not split into {n_microbatch} microbatches")
            mb = B // n_microbatch
            acc = accumulators(params, adt)
            lsum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            auxs = []
            for i in range(n_microbatch):
                bslice = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, aux, grads = micro(params, bslice)
                accumulate(acc, grads, adt)
                del grads
                lsum = lsum + l
                auxs.append(aux)
            n = torch.tensor(float(n_microbatch), dtype=adt, device=lsum.device)
            grads = [a.div_(n) for a in acc]
            metrics = {"loss": lsum / n.float()}
            metrics.update({k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]})
        grads = tree_unflatten(params, grads)
        new_params, new_opt, stats = adamw.apply(opt_cfg, params, grads, opt_state)
        metrics.update(stats)
        return new_params, new_opt, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, max_len: int):
    def prefill_step(params, batch: Dict[str, Any]):
        return M.prefill(
            params,
            cfg,
            batch["tokens"],
            max_len,
            extra_embeds=batch.get("extra_embeds"),
        )

    return prefill_step


def make_decode_step(cfg: ModelConfig):
    def decode_step(params, state: M.DecodeState, tokens):
        return M.decode_step(params, cfg, state, tokens)

    return decode_step

"""Train / serve step factories (the reference's ``repro.distributed.steps``).

``train_step``: gradient accumulation over microbatches (the remat'd model
inside), one AdamW update.  ``prefill_step`` / ``decode_step``: the serving
units.  No sharding hints: the port has no 2-D mesh until its distribution
slice.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from ..models import model as M
from ..models.config import ModelConfig
from ..optim import adamw
from ..tree import tree_leaves, tree_map, tree_unflatten


def _grad_tree(params):
    """``params`` with every leaf a grad-requiring alias of its storage, and
    the aliases in ``tree_leaves`` order."""
    tree = tree_map(lambda p: p.detach().requires_grad_(), params)
    return tree, tree_leaves(tree)


def make_train_step(cfg: ModelConfig, opt_cfg: adamw.AdamWConfig, n_microbatch: int):
    """Returns train_step(params, opt_state, batch) -> (params, opt, metrics).

    The batch (a dict of tensors on the parameters' device) is split into
    ``n_microbatch`` slices along dim 0; gradients accumulate in
    ``cfg.accum_dtype``, in microbatch order.  ``params`` and ``opt_state``
    are updated in place (``adamw.apply``) and returned; metrics are 0-d
    tensors on the device (nothing is read back to the host).
    """

    def micro(params, batch_slice):
        tree, leaves = _grad_tree(params)
        with torch.enable_grad():
            l, aux = M.loss_fn(tree, cfg, batch_slice)
            grads = torch.autograd.grad(l, leaves)
        return l.detach(), {k: v.detach() for k, v in aux.items()}, grads

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
            acc = [torch.zeros(p.shape, dtype=adt, device=p.device)
                   for p in tree_leaves(params)]
            lsum = torch.zeros((), dtype=torch.float32, device=batch["tokens"].device)
            auxs = []
            for i in range(n_microbatch):
                bslice = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
                l, aux, grads = micro(params, bslice)
                for a, g in zip(acc, grads):
                    a.add_(g.to(adt))
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

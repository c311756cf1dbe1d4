"""Sharding rules: parameter, optimizer, batch and cache specs (the
reference's ``repro.distributed.sharding``), mapped onto DTensor placements.

Scheme: TP over ``model`` for heads / ffn-hidden / experts / vocab; FSDP
over ``data`` on the complementary dimension of every large matrix; DP
gradient reduction over data (+pod) comes from the sharded-parameter <-
replicated-compute contraction.  The leading ``n_super`` axis of stacked
block params is never sharded.

Rules are *name- and shape-driven* so every architecture family (dense, MoE,
SSD, hybrid) resolves through one table.  A spec is a tuple with one entry
per tensor dimension: None, a mesh-axis name, or a tuple of names (the
entries of a ``jax.sharding.PartitionSpec``).  ``NamedSharding`` pairs it
with a mesh and gives its ``placements``: mesh axis ``a`` takes
``Shard(i)`` where entry ``i`` names ``a``, else ``Replicate()``; a
dimension sharded over two axes (``("data", "model")``) is split over both,
in the mesh's axis order, as JAX splits it.

The rules evaluate on a ``DeviceMesh`` or on an ``AbstractMesh`` (sizes and
names, no process group): the dry run and the tests read specs and
per-device shapes off the latter.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Tuple

import torch

from ..models.config import ModelConfig
from ..models.model import DecodeState, param_shapes
from ..tree import tree_map
from .ctx import mesh_axis_names, mesh_shape


@dataclasses.dataclass(frozen=True)
class AbstractMesh:
    """Axis sizes and names without devices (``jax.sharding.AbstractMesh``)."""

    axis_sizes: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.axis_sizes))

    @property
    def size(self) -> int:
        return math.prod(self.axis_sizes)


def partition_spec(*entries) -> tuple:
    """A spec, its entries as ``PartitionSpec`` keeps them: a one-name
    tuple is that name."""
    return tuple(e[0] if isinstance(e, (tuple, list)) and len(e) == 1
                 else tuple(e) if isinstance(e, list) else e for e in entries)


def _entry_axes(entry) -> tuple:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements_for(mesh, spec) -> tuple:
    """DTensor placements of ``spec`` on ``mesh`` (one per mesh axis).  An
    axis of size 1 shards nothing and is ``Replicate()`` (a 1 x 1 mesh runs
    the plain ops on whole tensors)."""
    from torch.distributed.tensor import Replicate, Shard

    names = mesh_axis_names(mesh)
    sizes = mesh_shape(mesh)
    out = [Replicate()] * len(names)
    for i, entry in enumerate(spec):
        for a in _entry_axes(entry):
            if sizes[a] > 1:
                out[names.index(a)] = Shard(i)
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``)."""

    mesh: Any
    spec: tuple

    @property
    def placements(self) -> tuple:
        return placements_for(self.mesh, self.spec)

    def shard_shape(self, global_shape) -> tuple:
        """One device's shape (each sharded dimension divided by its axes'
        sizes, rounded up, as an uneven last shard is padded)."""
        sizes = mesh_shape(self.mesh)
        out = list(global_shape)
        for i, entry in enumerate(self.spec):
            n = math.prod(sizes[a] for a in _entry_axes(entry))
            out[i] = -(-out[i] // n)
        return tuple(out)


def _fsdp_ok(dim: int, mesh) -> str | None:
    """Shard a dimension over `data` only when it divides evenly."""
    return "data" if dim % mesh_shape(mesh)["data"] == 0 else None


def param_spec(name: str, shape, cfg: ModelConfig, mesh, *, stacked: bool,
               flat_fsdp: bool = False) -> tuple:
    """Spec for one parameter leaf (shape excludes the scan axis).

    flat_fsdp: pure FSDP over the flattened (data, model) axes, no tensor
    parallelism — the scheme for small models where TP all-reduces
    dominate."""
    sizes = mesh_shape(mesh)
    model_n = sizes["model"]

    if flat_fsdp:
        axes = ("data", "model")
        n_all = sizes["data"] * sizes["model"]
        spec_l = [None] * len(shape)
        # shard the largest divisible dim over the flattened axes
        order = sorted(range(len(shape)), key=lambda i: -shape[i])
        for i in order:
            if shape[i] % n_all == 0:
                spec_l[i] = axes
                break
        else:
            for i in order:  # fall back to data-only
                if shape[i] % sizes["data"] == 0:
                    spec_l[i] = "data"
                    break
        if stacked:
            spec_l = [None] + spec_l
        return tuple(spec_l)

    def fsdp(dim):
        return _fsdp_ok(dim, mesh)

    def tp(dim):
        return "model" if dim % model_n == 0 else None

    if name == "embed":                          # (vocab, d)
        spec = (tp(shape[0]), fsdp(shape[1]))
    elif name == "lm_head":                      # (d, vocab)
        spec = (fsdp(shape[0]), tp(shape[1]))
    elif name in ("wq", "wk", "wv"):             # (d, H*hd)
        spec = (fsdp(shape[0]), tp(shape[1]))
    elif name == "wo":                           # (H*hd, d)
        spec = (tp(shape[0]), fsdp(shape[1]))
    elif name in ("w_gate", "w_up"):
        if len(shape) == 3:                      # MoE (E, d, ff)
            spec = (tp(shape[0]), fsdp(shape[1]), None)
        else:                                    # dense (d, ff)
            spec = (fsdp(shape[0]), tp(shape[1]))
    elif name == "w_down":
        if len(shape) == 3:                      # MoE (E, ff, d)
            spec = (tp(shape[0]), None, fsdp(shape[2]))
        else:                                    # dense (ff, d)
            spec = (tp(shape[0]), fsdp(shape[1]))
    elif name in ("shared_gate", "shared_up"):   # (d, sf)
        spec = (fsdp(shape[0]), tp(shape[1]))
    elif name == "shared_down":                  # (sf, d)
        spec = (tp(shape[0]), fsdp(shape[1]))
    elif name == "router":                       # (d, E) small
        spec = (None, None)
    elif name == "in_proj":                      # (d, 2*d_in + 2GS + H)
        spec = (fsdp(shape[0]), tp(shape[1]))
    elif name == "out_proj":                     # (d_in, d)
        spec = (tp(shape[0]), fsdp(shape[1]))
    elif name == "conv_w":                       # (K, conv_dim)
        spec = (None, tp(shape[1]))
    elif name == "conv_b":
        spec = (tp(shape[0]),)
    else:                                        # norms, A_log, dt_bias, D, ...
        spec = (None,) * len(shape)
    if stacked:
        spec = (None,) + tuple(spec)
    return tuple(spec)


def param_shardings(cfg: ModelConfig, mesh, flat_fsdp: bool = False):
    """``NamedSharding`` tree matching ``model.param_shapes(cfg)``."""
    shapes = param_shapes(cfg)

    def top(name):
        return NamedSharding(mesh, param_spec(name, tuple(shapes[name].shape), cfg, mesh,
                                              stacked=False, flat_fsdp=flat_fsdp))

    out = {name: top(name) for name in shapes if name != "blocks"}
    out["blocks"] = [
        {k: NamedSharding(mesh, param_spec(k, tuple(m.shape[1:]), cfg, mesh, stacked=True,
                                           flat_fsdp=flat_fsdp))
         for k, m in blk.items()}
        for blk in shapes["blocks"]
    ]
    return {k: out[k] for k in shapes}


def opt_shardings(param_sh, step_sharding):
    """Optimizer state shardings: moments follow their parameters."""
    from ..optim.adamw import OptState

    return OptState(step=step_sharding, mu=param_sh, nu=param_sh)


def _dp(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh_axis_names(mesh) else ("data",)


def batch_spec(mesh) -> tuple:
    return partition_spec(_dp(mesh), None)


def batch_shardings(cfg: ModelConfig, mesh, with_frontend: bool,
                    batch: int | None = None, dp=None):
    if dp is None:
        dp = _dp(mesh)
    if batch is not None:
        sizes = mesh_shape(mesh)
        n_dp = math.prod(sizes[a] for a in dp)
        if batch % n_dp != 0:
            dp = None  # tiny global batch (long-context decode): replicate
    out = {
        "tokens": NamedSharding(mesh, partition_spec(dp, None)),
        "labels": NamedSharding(mesh, partition_spec(dp, None)),
    }
    if with_frontend:
        out["extra_embeds"] = NamedSharding(mesh, partition_spec(dp, None, None))
    return out


def decode_state_shardings(cfg: ModelConfig, mesh, batch: int) -> DecodeState:
    """KV caches: batch over data(+pod) when divisible, kv-heads over model
    when divisible; otherwise the sequence axis takes the model sharding
    (long-context decode at batch 1)."""
    dp = _dp(mesh)
    sizes = mesh_shape(mesh)
    n_dp = math.prod(sizes[a] for a in dp)
    model_n = sizes["model"]
    b_ax = dp if batch % n_dp == 0 else None

    caches = []
    for spec in cfg.pattern:
        if spec.mixer == "attn":
            kv_ax = "model" if cfg.n_kv_heads % model_n == 0 else None
            seq_ax = None if kv_ax else "model"
            sh = NamedSharding(mesh, partition_spec(None, b_ax, seq_ax, kv_ax, None))
            caches.append({"k": sh, "v": sh})
        else:
            conv_dim = cfg.d_inner + 2 * cfg.ssm_state
            conv_ax = "model" if conv_dim % model_n == 0 else None
            head_ax = "model" if cfg.ssm_heads % model_n == 0 else None
            caches.append(
                {
                    "conv": NamedSharding(mesh, partition_spec(None, b_ax, None, conv_ax)),
                    "ssm": NamedSharding(mesh, partition_spec(None, b_ax, head_ax, None, None)),
                }
            )
    return DecodeState(caches=tuple(caches), pos=NamedSharding(mesh, ()))


def replicated(mesh):
    return NamedSharding(mesh, ())


def local_block(sh: NamedSharding, shape) -> tuple[tuple, tuple, tuple]:
    """This rank's block of a tensor of ``shape`` placed by ``sh``: its
    placements (the spec padded with None to the tensor's rank), and the
    block's start and length in each dimension, as ``distribute_tensor``
    cuts it (torch's chunks: uneven splits leave a short or empty last
    shard; a dimension split over two axes is cut in the mesh's order)."""
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    spec = tuple(sh.spec) + (None,) * (len(shape) - len(sh.spec))
    placements = placements_for(sh.mesh, spec)
    length, start = compute_local_shape_and_global_offset(tuple(shape), sh.mesh, placements)
    return placements, tuple(start), tuple(length)


def shard_leaf(t, sh: NamedSharding):
    """One tensor placed by ``sh`` on its ``DeviceMesh`` (``distribute_tensor``;
    real, fake or meta tensors alike).  A non-tensor leaf (a host int) is
    left as it is."""
    if not isinstance(t, torch.Tensor):
        return t
    from torch.distributed.tensor import DTensor, distribute_tensor

    spec = tuple(sh.spec) + (None,) * (t.dim() - len(sh.spec))
    placements = placements_for(sh.mesh, spec)
    if isinstance(t, DTensor):
        return t.redistribute(sh.mesh, placements)
    if t.device.type == "meta":
        # no data to scatter: a meta local shard of this device's shape
        local = torch.empty(NamedSharding(sh.mesh, spec).shard_shape(t.shape),
                            dtype=t.dtype, device="meta")
        return DTensor.from_local(local, sh.mesh, placements, run_check=False,
                                  shape=t.shape, stride=t.stride())
    return distribute_tensor(t, sh.mesh, placements)


def shard_tree(tree, shardings):
    """``tree`` with each tensor leaf placed by the ``NamedSharding`` at the
    same place of ``shardings`` (a tree of ``tree``'s structure; a ``None``
    sharding leaves its leaf as it is)."""
    return tree_map(lambda t, sh: t if sh is None else shard_leaf(t, sh), tree, shardings)

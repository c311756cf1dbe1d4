"""Activation-sharding context: lets model code place sharding constraints
without threading mesh objects through every layer (the reference's
``repro.distributed.ctx``).

The step builders (or the dry run) activate axes with ``activation_axes``;
model code calls ``constrain(x, dims)`` where dims names each dimension of
x as one of: "batch" (the data-parallel axes), "model", None.  Outside any
mesh context, on a plain tensor and on ``None`` a constraint is the
identity; on a ``DTensor`` it redistributes to the placements ``dims`` name
(the counterpart of ``with_sharding_constraint``).

Dims whose size does not divide the named mesh axis degrade to None
automatically, so one call site serves every architecture.
"""
from __future__ import annotations

import contextlib
import types
from typing import Optional, Sequence

import torch

#: Process-wide, not thread-local as the reference's: the autograd engine
#: runs a CUDA backward (and the recompute of a checkpointed block in it) on
#: its own device thread, which must see the caller's axes.
_state = types.SimpleNamespace(axes=None)


def _axes():
    return _state.axes


def current_axes():
    """Public view of the active activation-sharding context (or None):
    dict(mesh=..., batch=tuple_of_axis_names, model=name_or_None)."""
    return _axes()


def mesh_axis_names(mesh) -> tuple:
    """The axis names of a ``DeviceMesh`` or of a ``sharding.AbstractMesh``."""
    names = getattr(mesh, "mesh_dim_names", None)
    return tuple(names if names is not None else mesh.axis_names)


def mesh_shape(mesh) -> dict:
    """Axis name -> size, as ``jax.sharding.Mesh.shape`` gives it."""
    sizes = mesh.mesh.shape if hasattr(mesh, "mesh_dim_names") else mesh.axis_sizes
    return dict(zip(mesh_axis_names(mesh), (int(s) for s in sizes)))


@contextlib.contextmanager
def activation_axes(mesh, dp: Sequence[str] = ("data",), model: str = "model"):
    """Enable constraints inside the block.  dp may include 'pod'.  On a
    ``DeviceMesh`` the block also runs under DTensor's
    ``implicit_replication``."""
    prev = _axes()
    names = mesh_axis_names(mesh)
    _state.axes = {
        "mesh": mesh,
        "batch": tuple(a for a in dp if a in names),
        "model": model if model in names else None,
    }
    try:
        with contextlib.ExitStack() as stack:
            if hasattr(mesh, "mesh_dim_names"):
                # plain tensors a layer makes (zeros, masks, the loss's
                # counters) meet DTensors as replicated ones
                from torch.distributed.tensor.experimental import implicit_replication

                stack.enter_context(implicit_replication())
            yield
    finally:
        _state.axes = prev


def _axis_size(mesh, names) -> int:
    if names is None:
        return 1
    if isinstance(names, str):
        names = (names,)
    shape = mesh_shape(mesh)
    n = 1
    for a in names:
        n *= shape[a]
    return n


def spec_for(x_shape, dims: Sequence[Optional[str]], axes=None) -> tuple:
    """The spec ``constrain`` picks: per dimension an axis name, a tuple of
    them or None (a ``PartitionSpec``'s entries)."""
    axes = axes if axes is not None else _axes()
    mesh = axes["mesh"]
    spec = []
    for size, d in zip(x_shape, dims):
        name = axes.get(d) if d else None
        if name and size % _axis_size(mesh, name) == 0:
            # a one-name tuple is that name, as in a PartitionSpec
            spec.append(name[0] if isinstance(name, tuple) and len(name) == 1 else name)
        else:
            spec.append(None)
    return tuple(spec)


def constrain(x, dims: Sequence[Optional[str]]):
    """dims: per-dimension "batch" | "model" | None."""
    from torch.distributed.tensor import DTensor

    axes = _axes()
    if axes is None or x is None or not isinstance(x, DTensor):
        return x
    from .sharding import placements_for

    placements = placements_for(x.device_mesh, spec_for(x.shape, dims, axes))
    if tuple(x.placements) == placements:
        return x
    return x.redistribute(x.device_mesh, placements)


def is_dtensor(x) -> bool:
    if not isinstance(x, torch.Tensor):
        return False
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def replicate_like(t, like):
    """``t``, a plain tensor, as a replicated ``DTensor`` on ``like``'s mesh
    when ``like`` is a ``DTensor``; ``t`` itself otherwise (the positions,
    masks and tables a layer makes meet its sharded activations so)."""
    if not is_dtensor(like) or is_dtensor(t):
        return t
    from torch.distributed.tensor import DTensor, Replicate

    mesh = like.device_mesh
    return DTensor.from_local(t, mesh, [Replicate()] * mesh.ndim, run_check=False)


def pin_grad(x):
    """``x`` itself, but the gradient that comes back through it is placed
    as ``x`` is (a ``DTensor``'s ``to_local`` / ``from_local`` round trip);
    a plain tensor as it is."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor

    local = x.to_local(grad_placements=x.placements)
    return DTensor.from_local(local, x.device_mesh, x.placements, run_check=False,
                              shape=x.shape, stride=x.stride())

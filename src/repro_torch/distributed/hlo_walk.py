"""Per-device cost of one step, read off the ops it runs (the counterpart of
the reference's ``repro.distributed.hlo_walk``).

The reference parses the post-SPMD HLO of a compiled step.  The port runs
eagerly and has no HLO: ``Walker`` is a ``TorchDispatchMode`` that sees the
aten ops one step runs on a device's local shards (a ``DTensor`` op is let
through to its sharding rules, which run the local ops and the c10d
functional collectives the walker then sees), and accumulates per device:

  * dot and conv FLOPs, 2·m·n·k (``torch.utils.flop_counter``'s formulas
    for mm, bmm, addmm, baddbmm and convolutions: an einsum runs as these)
  * bytes at op granularity: each op's outputs plus its inputs (a view or
    a collective's wait moves nothing)
  * the count and ring wire bytes of each collective (all-gather,
    reduce-scatter, all-reduce, all-to-all), with the ranks of its group,
    so that its time is taken at that group's link bandwidth
  * the peak of live bytes the ops allocate (fake or real), held per
    storage until the last tensor on it is freed

Where the reference multiplies a loop body by its trip count, the caller
traces the body once under ``Walker.repeat(n)``: the dry run traces one
microbatch of a train step and multiplies it by the microbatch count, and
traces one and two super-blocks to take the per-super-block cost for the
other ``n_super - 1`` (``launch.dryrun``).

The reference's HLO-text parser (``Op``, ``Computation``,
``parse_computations``) has no counterpart: there is no text to parse.
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from .analysis import NODE_SIZE, CollectiveStats, _wire_bytes, link_bw

COLLECTIVE_OPS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)

#: c10d functional op -> the reference's collective name.
_C10D = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "all_to_all_single": "all-to-all",
}


@dataclasses.dataclass
class HloCost:
    flops: float = 0.0
    bytes: float = 0.0
    collective_wire_bytes: float = 0.0
    per_collective_bytes: Dict[str, float] = dataclasses.field(default_factory=dict)
    per_collective_ops: Dict[str, float] = dataclasses.field(default_factory=dict)
    collective_s: float = 0.0          # wire bytes over each group's link bandwidth
    peak_bytes: float = 0.0            # most live bytes the ops held at once
    n_ops: int = 0

    def as_dict(self):
        return dataclasses.asdict(self)

    def collective_stats(self) -> CollectiveStats:
        """The collectives seen, as ``analysis.CollectiveStats``."""
        return CollectiveStats(per_type_ops=dict(self.per_collective_ops),
                               per_type_bytes=dict(self.per_collective_bytes),
                               total_wire_bytes=self.collective_wire_bytes)

    def extrapolate(self, other: "HloCost", n: float) -> "HloCost":
        """``self + n * (other - self)`` field by field: the cost at ``n + 1``
        loop trips from traces at one (``self``) and two (``other``)."""
        def lin(a, b):
            return a + n * (b - a)

        out = HloCost()
        for f in ("flops", "bytes", "collective_wire_bytes", "collective_s", "peak_bytes"):
            setattr(out, f, lin(getattr(self, f), getattr(other, f)))
        out.n_ops = int(lin(self.n_ops, other.n_ops))
        for f in ("per_collective_bytes", "per_collective_ops"):
            a, b = getattr(self, f), getattr(other, f)
            setattr(out, f, {k: lin(a.get(k, 0.0), b.get(k, 0.0)) for k in sorted(set(a) | set(b))})
        return out


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for y in x for t in _tensors(y)]
    if isinstance(x, dict):
        return [t for y in x.values() for t in _tensors(y)]
    return []


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_ranks(name) -> list:
    import torch.distributed as dist
    from torch.distributed.distributed_c10d import _resolve_process_group

    return dist.get_process_group_ranks(_resolve_process_group(name))


class Walker(TorchDispatchMode):
    """Accumulates an ``HloCost`` of the ops run under it (see the module
    docstring); ``node_size`` ranks share an NVLink node."""

    def __init__(self, node_size: int = NODE_SIZE):
        super().__init__()
        self.cost = HloCost()
        self.node_size = node_size
        self._mult = 1.0
        self._live = 0
        self._refs: Dict[int, list] = {}
        self._suspended = 0
        self._restore = None

    def __enter__(self):
        self._hide_shape_propagation()
        return super().__enter__()

    def __exit__(self, *exc):
        try:
            return super().__exit__(*exc)
        finally:
            if self._restore is not None:
                self._restore()
                self._restore = None

    def _hide_shape_propagation(self):
        """DTensor derives an op's global output shape by running it on fake
        global-shape arguments (``ShardingPropagator``'s tensor-meta
        propagation, on a cache miss): not the step's work, so the walker
        counts nothing while it runs."""
        try:
            from torch.distributed.tensor._sharding_prop import ShardingPropagator
        except ImportError:
            return
        name = "_propagate_tensor_meta_non_cached"
        orig = ShardingPropagator.__dict__.get(name)
        if orig is None:
            return
        walker = self

        def hidden(prop, op_schema):
            walker._suspended += 1
            try:
                return orig(prop, op_schema)
            finally:
                walker._suspended -= 1

        setattr(ShardingPropagator, name, hidden)
        self._restore = lambda: setattr(ShardingPropagator, name, orig)

    @contextlib.contextmanager
    def repeat(self, n: float):
        """Count the ops inside ``n`` times (a loop body traced once)."""
        prev = self._mult
        self._mult = prev * n
        try:
            yield
        finally:
            self._mult = prev

    # live bytes: per storage, a count of the tensors on it and its size
    def _hold(self, t: torch.Tensor, fresh: bool):
        """Count ``t`` on its storage; a ``fresh`` op output's storage is new
        (a view's keeps a storage alive only if an op under us made it)."""
        try:
            key = t.untyped_storage()._cdata
        except (RuntimeError, NotImplementedError):
            return
        ref = self._refs.get(key)
        if ref is None:
            if not fresh:
                return
            ref = self._refs[key] = [0, t.untyped_storage().nbytes()]
            self._live += ref[1]
            self.cost.peak_bytes = max(self.cost.peak_bytes, float(self._live))
        ref[0] += 1
        weakref.finalize(t, self._release, key)

    def _release(self, key):
        ref = self._refs.get(key)
        if ref is None:
            return
        ref[0] -= 1
        if ref[0] == 0:
            self._live -= ref[1]
            del self._refs[key]

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented      # let DTensor run its local ops under us
        out = func(*args, **kwargs)
        # a fake-tensor kernel's own meta ops are not the step's work
        if not self._suspended and not any(
                t.device.type == "meta" for t in _tensors((args, kwargs, out))):
            self._account(func, args, kwargs, out)
        return out

    def _account(self, func, args, kwargs, out):
        from torch.utils.flop_counter import flop_registry

        c, m = self.cost, self._mult
        c.n_ops += 1
        packet = func.overloadpacket
        ns = func.namespace
        outs = _tensors(out)
        if packet in flop_registry:
            c.flops += m * float(flop_registry[packet](*args, **kwargs, out_val=out))
        name = packet.__name__
        if ns == "_c10d_functional" and name in _C10D:
            op = _C10D[name]
            group = args[-1]
            ranks = _group_ranks(group)
            g = len(ranks)
            ob = sum(_nbytes(t) for t in outs)
            wb = _wire_bytes(op, ob, g) * m
            c.per_collective_bytes[op] = c.per_collective_bytes.get(op, 0.0) + wb
            c.per_collective_ops[op] = c.per_collective_ops.get(op, 0.0) + m
            c.collective_wire_bytes += wb
            c.collective_s += wb / link_bw(ranks, self.node_size)
        aliases = func.is_view or any(r.alias_info is not None for r in func._schema.returns)
        if not aliases and not (ns == "_c10d_functional" and name == "wait_tensor"):
            c.bytes += m * (sum(_nbytes(t) for t in outs)
                            + sum(_nbytes(t) for t in _tensors((args, kwargs))))
        for t in outs:
            self._hold(t, not aliases)


def analyze(fn, *args, node_size: int = NODE_SIZE, **kwargs) -> HloCost:
    """``fn(*args, **kwargs)`` run under a ``Walker``; its cost."""
    walker = Walker(node_size)
    with walker:
        fn(*args, **kwargs)
    return walker.cost

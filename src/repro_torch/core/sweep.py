"""Declarative sweep engine: whole variation grids, with grid points
flattened into the kernels' trial axis.

The paper's results are shmoo grids: every point is one policy or scheme
evaluation at a different combination of variation-axis values::

    from repro_torch.core.sweep import SweepRequest, sweep
    from repro_torch.core.api import make_units
    from repro_torch.configs.wdm import WDM8_G200

    cfg = WDM8_G200
    units = make_units(cfg, seed=4, n_laser=100, n_ring=100)   # on CUDA

    # Fig. 4: AFP over a sigma_rLV x TR shmoo.
    res = sweep(SweepRequest(cfg=cfg, units=units, policy="ltc",
                             axes={"sigma_rlv": rlvs, "tr_mean": trs}))
    res.data                 # (len(rlvs), len(trs)) AFP grid
    res.axis("tr_mean")      # the coordinate values, carried with the result

    # Fig. 5/7/8: minimum tuning range along any registered axis.
    res = sweep(SweepRequest(cfg=cfg, units=units, policy="lta",
                             metric="min_tr", axes={"fsr_mean": fsrs}))

Valid axis and fixed names are the ``Variations`` axis registry's; an axis
registered with ``register_axis`` is sweepable at once.

Engine mechanics:

  * named axes are crossed into a flat (P, K) point list on the host;
  * ``chunked_map`` runs the points in chunks; a chunk of Pc points is ONE
    evaluation of Pc * T trials, each point's values given per point (1-D
    tensors, see ``sampling.instantiate``), so every kernel launch does the
    work of a whole chunk.  Per-trial results are exact per trial (every
    path is batch-independent), and each chunk is reduced over its (Pc, T)
    view: AFP, CAFP and the error shares as failure counts divided by T in
    float32, ``min_tr`` as a max over each point's trials;
  * the chunk size is bounded by a device-memory budget (``_CHUNK_BUDGET``
    over ``scheme_point_bytes`` / ``policy_point_bytes``), or ``chunk_size``;
  * results come back as grid-shaped tensors on the units' device (leading
    dims = axis lengths, in the order of the ``axes`` mapping).

The device of the unit samples selects the path, as everywhere in the port:
CUDA units go through the hand-written kernels, CPU units through their
plain versions.  Fabric sweeps (``fabric=``, ``repro_torch.fabric``) give
each grid point its own copy of the fabric's links, so a chunk of points is
one batch of links, and each link chunk one batch of 2 trials a link.
``mesh=`` (a 1-D ``repro_torch.launch.SweepMesh``, e.g. from
``make_sweep_mesh``) splits the chunk axis of grid points over devices
(``chunked_map``): bit-identical to the unsharded engine and invariant to the
mesh size.  Under an installed ``repro_torch.obs.phase``
recorder a sweep is one ``sweep.request`` span, notes its chunk plan
(``sweep.plan``, and ``chunked_map.sweep_points``) and runs its points
through ``measured_call`` (an ``execute`` span, and the device watermark
under ``measure_memory``).

``sweep_reference`` is the per-point loop over the single-point entry
points: the engine's oracle, consuming the same validated ``SweepRequest``.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch

from .api import (
    EvalResult,
    evaluate_policy,
    evaluate_scheme,
    policy_min_tr,
    policy_trial_min_tr,
    policy_trials,
    scheme_trials,
)
from .grid import ArbitrationConfig
from .sampling import UnitSamples
from .search_table import max_entries_for
from .temporal import TemporalStats, Timeline, run_timeline_impl
from .variations import Variations, _maybe_validate, axis_names, axis_spec
from ..launch.mesh import SweepMesh, check_mesh
from ..obs.phase import current_recorder, measured_call, note, span

#: Per-chunk device-memory budget for automatic chunk sizing [bytes]: 4 GiB,
#: 5 % of an 80 GB card.
_CHUNK_BUDGET = 4 * 1024 ** 3


def __getattr__(name: str):
    # The pre-registry engine exposed its axis names as a module-level tuple;
    # served live, so that axes registered later show through the old name.
    if name == "AXIS_NAMES":
        return axis_names()
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def _tree_map(fn: Callable, *trees):
    """``fn`` over the tensors of equal-structured (named) tuples; a None
    leaf stays None."""
    first = trees[0]
    if first is None:
        return None
    if isinstance(first, tuple):
        out = [_tree_map(fn, *leaves) for leaves in zip(*trees)]
        return type(first)(*out) if hasattr(first, "_fields") else tuple(out)
    return fn(*trees)


def _leaves(tree) -> list:
    if tree is None:
        return []
    if isinstance(tree, tuple):
        return [leaf for sub in tree for leaf in _leaves(sub)]
    return [tree]


def _to(tree, device):
    """Every tensor of ``tree`` on ``device`` (a no-op where it lies there,
    or where ``device`` is None); other leaves as they are."""
    if device is None:
        return tree
    return _tree_map(lambda a: a.to(device) if isinstance(a, torch.Tensor) else a, tree)


def _home_device(trees, default: torch.device) -> torch.device:
    """The device results come back to: the first tensor's among ``trees``,
    else ``default``."""
    for leaf in _leaves(trees):
        if isinstance(leaf, torch.Tensor):
            return leaf.device
    return default


def _on(device):
    """Make ``device`` current while a chunk runs there (the kernel wrappers
    launch on their inputs' device in any case)."""
    if device is not None and device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def chunked_map(fn: Callable, xs, *, chunk: int, mesh: SweepMesh | None = None,
                broadcast: tuple = (), tag: str | None = None):
    """Run ``fn(*broadcast, item)`` on chunks of ``chunk`` items of ``xs`` and
    concatenate the results along their leading axis.

    ``xs`` is a tensor, an array, or a (named, nested) tuple of them sharing
    the leading axis (the fabric layer's ``FabricUnits``), each chunk sliced
    alike; ``broadcast`` trees are passed whole to every chunk.  The results
    are tensors or (named) tuples of tensors, each with the chunk's leading
    axis, None leaves staying None.  Peak memory is one chunk's; the last
    chunk is simply smaller (nothing is padded).

    With ``mesh`` the chunk count is rounded up to a multiple of
    ``mesh.size`` and device d takes the contiguous chunks [d k, (d + 1) k)
    of the k each, as the reference's ``shard_map`` splits them; chunks past
    the end are empty and skipped.  A chunk's slice of ``xs`` (and
    ``broadcast``, once a device) moves to its device, runs there, and its
    result comes back to the device of ``xs`` (of the first tensor).  The
    chunks are those of the unsharded path and every path is exact per
    trial, so the result is bit-identical for every mesh.  Chunks are issued
    in device order from the calling thread.  Only meshes that repeat one
    device have been run; distinct cards, and any overlap between them, are
    not yet run or measured (ROADMAP queue 2).

    ``tag`` names the plan note ``chunked_map.<tag>`` (items, chunk and the
    rounded n_chunks) for an installed phase recorder.  The port runs
    eagerly, so the note is made once per call (the reference's, once per
    compilation).
    """
    if chunk < 1:
        raise ValueError(f"chunk must be >= 1, got {chunk}")
    size = _leaves(xs)[0].shape[0]
    devices = (None,) if mesh is None else mesh.devices  # None: stay where xs lies
    per_device = -(-int(size) // (int(chunk) * len(devices)))  # whole chunks per device
    n_chunks = per_device * len(devices)
    if tag is not None:
        note(f"chunked_map.{tag}", items=int(size), chunk=int(chunk), n_chunks=n_chunks)

    home = None if mesh is None else _home_device((xs, broadcast), devices[0])
    outs = []
    for d, device in enumerate(devices):
        starts = [c * chunk for c in range(d * per_device, (d + 1) * per_device)
                  if c * chunk < size]
        if not starts:
            continue
        with _on(device):
            shared = _to(broadcast, device)
            for start in starts:
                part = _tree_map(lambda a: a[start:start + chunk], xs)
                outs.append(_to(fn(*shared, _to(part, device)), home))
    return _tree_map(lambda *parts: torch.cat(parts), *outs)


def _check_names(names, *, metric: str) -> None:
    valid = axis_names()
    for name in names:
        if name not in valid:
            raise ValueError(f"unknown sweep axis {name!r}; valid: {valid}")
    if metric == "min_tr" and "tr_mean" in names:
        raise ValueError("min_tr sweeps solve for TR; 'tr_mean' cannot be an axis")


def _validate_request(names, fixed, *, metric: str, policy, scheme) -> None:
    """Shared request validation: the engine and the reference loop consume
    the same validated ``SweepRequest``, so they accept and reject alike."""
    if (policy is None) == (scheme is None):
        raise ValueError("exactly one of policy/scheme required")
    if metric not in ("eval", "min_tr"):
        raise ValueError(f"unknown metric {metric!r}")
    if metric == "min_tr" and policy is None:
        raise ValueError("min_tr sweeps are policy sweeps")
    _check_names(names, metric=metric)
    _check_names(fixed, metric=metric)
    overlap = set(names) & set(fixed)
    if overlap:
        raise ValueError(f"axes and fixed overlap: {sorted(overlap)}")


@dataclasses.dataclass(frozen=True, eq=False)
class SweepRequest:
    """A complete, validated description of one grid evaluation.

    axes:   ordered mapping axis name -> 1-D coordinate values; the result's
            leading dims follow this order.
    policy/scheme: exactly one; the evaluation target.
    metric: "eval" (AFP for a policy / EvalResult for a scheme) or
            "min_tr" (policy only; minimum mean TR for complete success).
    fixed:  scalar overrides applied at every point (a mapping or a
            ``Variations``), rounded to float32 as the axis values are.
    chunk_size: grid points per chunk (None = automatic, from the memory
            budget).
    tr_fast: policy-eval sweeps with a ``tr_mean`` axis collapse that axis
            to a threshold comparison against one per-trial min-TR
            evaluation per remaining point (``_afp_from_trial_min_tr``).
            Disable to force the direct path.
    timeline: optional ``core.temporal.Timeline``.  Each grid point then
            runs the temporal re-arbitration (``run_timeline`` defaults)
            instead of a one-shot evaluation, and the result grids are
            trial-mean ``TemporalStats`` fields with a trailing step axis.
            Requires a ``protocol_*`` scheme and ``metric="eval"``.
    fabric: optional ``repro_torch.fabric.FabricSpec``.  Each grid point
            then brings up the whole fabric (per-link scheme arbitration +
            the network-level wavelength-assignment constraints) and the
            result grids are ``FabricStats`` fields.  Requires a scheme,
            ``metric="eval"`` and ``units`` from ``make_fabric_units``
            matching the spec.  The link axis is chunked inside each chunk
            of points against the same memory budget.  With a
            ``FabricTimeline`` as ``timeline`` each grid point runs a whole
            chaos timeline (``run_fabric_timeline`` defaults) and the grids
            are link-mean ``FabricChaosStats`` fields with a trailing step
            axis; any scheme is accepted.  A per-transceiver ``Timeline``
            with ``fabric=``, or a ``FabricTimeline`` without it, is
            rejected at construction.
    mesh:   optional 1-D ``repro_torch.launch.SweepMesh``; the chunk axis of
            grid points is split over its devices (``chunked_map``),
            bit-identical to the unsharded engine and invariant to the mesh
            size.  A fabric sweep's inner link chunks stay unsharded.
            ``sweep_reference`` ignores it.

    Validation happens at construction, so an invalid request never reaches
    the engine (or the reference loop).
    """

    cfg: ArbitrationConfig
    units: UnitSamples
    axes: Mapping[str, np.ndarray]
    policy: str | None = None
    scheme: str | None = None
    metric: str = "eval"
    fixed: Mapping[str, float] | Variations | None = None
    chunk_size: int | None = None
    tr_fast: bool = True
    mesh: Any = None
    timeline: Any = None
    fabric: Any = None

    def __post_init__(self):
        axes = {
            str(k): np.asarray(v, np.float32).reshape(-1)
            for k, v in dict(self.axes).items()
        }
        fixed = self.fixed
        if isinstance(fixed, Variations):
            fixed = dict(fixed.items())
        fixed = {str(k): v for k, v in dict(fixed or {}).items()}
        object.__setattr__(self, "axes", axes)
        object.__setattr__(self, "fixed", fixed)
        if self.fabric is not None:
            self._check_fabric()
        _validate_request(
            tuple(axes), tuple(fixed),
            metric=self.metric, policy=self.policy, scheme=self.scheme,
        )
        if not axes:
            raise ValueError("at least one sweep axis required")
        for name, values in axes.items():
            spec = axis_spec(name)
            for v in values:
                _maybe_validate(spec, v)
        for name, v in fixed.items():
            _maybe_validate(axis_spec(name), v)
        check_mesh(self.mesh)
        if self.chunk_size is not None and self.chunk_size < 1:
            raise ValueError(f"chunk_size must be >= 1, got {self.chunk_size}")
        if self.timeline is not None and self.fabric is None:
            from ..fabric.chaos import FabricTimeline  # local: fabric imports this module

            if isinstance(self.timeline, FabricTimeline):
                raise ValueError(
                    "a FabricTimeline carries per-link faults but no "
                    "topology; pass the matching fabric=FabricSpec(...) "
                    "alongside it"
                )
            if not isinstance(self.timeline, Timeline):
                raise ValueError(
                    "timeline sweeps take a core.temporal.Timeline, got "
                    f"{type(self.timeline).__name__}")
            if self.scheme is None or not self.scheme.startswith("protocol_"):
                raise ValueError(
                    "timeline sweeps run incremental re-arbitration and "
                    f"need a protocol_* scheme; got scheme={self.scheme!r}"
                )
            if self.metric != "eval":
                raise ValueError("timeline sweeps require metric='eval'")
            n_ch = int(self.timeline.n_ch)
            if n_ch != len(self.cfg.s):
                raise ValueError(
                    f"timeline has {n_ch} channels but cfg has {len(self.cfg.s)}"
                )

    def _check_fabric(self) -> None:
        """Fabric-specific diagnostics, ahead of the generic metric and
        policy checks: a fabric request that also trips e.g. the min_tr rule
        says what is wrong with the *fabric* usage."""
        from ..fabric.chaos import FabricTimeline  # local: fabric imports this module
        from ..fabric.sampling import FabricUnits

        if self.scheme is None:
            raise ValueError(
                "fabric sweeps arbitrate every link with an oblivious "
                "scheme; pass scheme=..., not policy=..."
            )
        if self.metric != "eval":
            raise ValueError("fabric sweeps require metric='eval'")
        if self.timeline is not None:
            if not isinstance(self.timeline, FabricTimeline):
                raise ValueError(
                    "fabric sweeps compose with a fabric-scoped "
                    "FabricTimeline (repro_torch.fabric.make_fabric_timeline); "
                    "a per-transceiver Timeline has no link addressing "
                    f"at fabric scale (got {type(self.timeline).__name__})"
                )
            if self.timeline.n_links != self.fabric.n_links:
                raise ValueError(
                    f"timeline spans {self.timeline.n_links} links but "
                    f"the fabric spec describes {self.fabric.n_links}"
                )
            if self.timeline.n_ch != len(self.cfg.s):
                raise ValueError(
                    f"timeline has {self.timeline.n_ch} channels but "
                    f"cfg has {len(self.cfg.s)}"
                )
        if not isinstance(self.units, FabricUnits):
            raise ValueError(
                "fabric sweeps take FabricUnits from "
                "repro_torch.fabric.make_fabric_units, not UnitSamples"
            )
        if self.units.n_links != self.fabric.n_links:
            raise ValueError(
                f"units carry {self.units.n_links} links but the spec "
                f"describes {self.fabric.n_links}"
            )

    def replace(self, **kw) -> "SweepRequest":
        return dataclasses.replace(self, **kw)


class SweepResult(NamedTuple):
    """Grid(s) plus the axis metadata they were evaluated over.

    ``data`` is the grid tensor (policy and min_tr requests), an
    ``EvalResult`` whose fields are grids (scheme requests; ``alg_success``
    and ``ideal_ok`` carry a trailing trial axis) or a ``TemporalStats`` of
    grids with a trailing step axis (timeline requests); leading dims follow
    ``axis_names``, with ``coords[i]`` holding axis i's coordinate values.
    """

    data: Any
    axis_names: tuple
    coords: tuple

    def axis(self, name: str) -> np.ndarray:
        """Coordinate values of the named axis."""
        try:
            return self.coords[self.axis_names.index(name)]
        except ValueError:
            raise ValueError(
                f"result has no axis {name!r}; axes: {self.axis_names}"
            ) from None


def _grid_points(axes: Mapping[str, np.ndarray]):
    """Cross the named axes into a flat (P, K) float32 point array."""
    names = tuple(axes)
    values = [np.asarray(v, np.float32).reshape(-1) for v in axes.values()]
    shape = tuple(len(v) for v in values)
    mesh = np.meshgrid(*values, indexing="ij")
    points = np.stack([m.reshape(-1) for m in mesh], axis=-1)  # (P, K)
    return names, points, shape


def scheme_point_bytes(cfg: ArbitrationConfig, n_trials: int) -> int:
    """Per-grid-point working-set estimate [bytes] of a *scheme* sweep, the
    quantity ``_auto_chunk`` budgets against.

    The (T, N, E) search tables (float32 delta + int32 wl) and n_valid,
    counted three times: once for the tables, twice for the arbiters'
    transients (masked copies of the tables' rows, the protocol engine's
    states); plus the (T, N, N) float32 residual of the LtA ideal and the
    four (T, N) float32 system fields.  ``chip_smoke.py`` prints the card's
    peak beside it.
    """
    n = cfg.grid.n_ch
    e = max_entries_for(n)
    tables = n_trials * n * (e * 8 + 4)
    return 3 * tables + n_trials * n * n * 4 + 4 * n_trials * n * 4


def policy_point_bytes(cfg: ArbitrationConfig, n_trials: int) -> int:
    """Per-grid-point working-set estimate [bytes] of a *policy* sweep: the
    (T, N, N) float32 residual tensor of the LtA path (bottleneck weights,
    reach matrix), three live copies, plus the four (T, N) system fields.
    The LtD/LtC kernel reads only the (T, N) fields, so this bounds it."""
    n = cfg.grid.n_ch
    return n_trials * n * n * 4 * 3 + 4 * n_trials * n * 4


def _auto_chunk(cfg: ArbitrationConfig, units: UnitSamples, n_points: int,
                scheme: str | None) -> int:
    """Largest chunk whose per-point working set fits the memory budget."""
    trials = units.u_rlv.shape[0] * units.u_go.shape[0]
    per_point = (scheme_point_bytes(cfg, trials) if scheme is not None
                 else policy_point_bytes(cfg, trials))
    return int(np.clip(_CHUNK_BUDGET // max(per_point, 1), 1, n_points))


def _trial_mean(x: torch.Tensor, n_trials: int) -> torch.Tensor:
    """(..., T) bool or integer -> (...,) float32 trial mean: the integer sum
    over T divided by T in float32 (a true division on every device; a CUDA
    division by a host scalar would multiply by its reciprocal)."""
    t = torch.tensor(float(n_trials), dtype=torch.float32, device=x.device)
    return x.sum(dim=-1).to(torch.float32) / t


def _eval_chunk(cfg, units, fixed, timeline, points, *, names, metric, policy,
                scheme):
    """One chunk of Pc grid points as one batch of Pc * T trials -> per-point
    results with a leading (Pc,) axis."""
    over = dict(fixed)
    over.update({name: torch.from_numpy(np.ascontiguousarray(points[:, i]))
                 for i, name in enumerate(names)})
    var = Variations(**over)
    n_points = points.shape[0]
    if timeline is not None:
        _, stats = run_timeline_impl(cfg, units, timeline, var, scheme=scheme)
        # trial mean per point and step: (S, Pc * T) -> (Pc, S)
        return TemporalStats(*(
            _trial_mean(a.reshape(a.shape[0], n_points, -1), a.shape[1] // n_points).T
            for a in stats))
    if metric in ("min_tr", "trial_min_tr"):
        per_trial = policy_trial_min_tr(cfg, units, policy, var).reshape(n_points, -1)
        return per_trial if metric == "trial_min_tr" else per_trial.amax(dim=-1)
    if policy is not None:
        ok = policy_trials(cfg, units, policy, var).reshape(n_points, -1)
        return _trial_mean(~ok, ok.shape[1])
    r = scheme_trials(cfg, units, scheme, var)
    alg, ok, lock, order = (x.reshape(n_points, -1) for x in r)
    t = ok.shape[1]
    return EvalResult(
        afp=_trial_mean(~ok, t),
        cafp=_trial_mean(~alg & ok, t),
        lock_err=_trial_mean(lock, t),
        order_err=_trial_mean(order, t),
        alg_success=alg,
        ideal_ok=ok,
    )


def _fabric_chunk(cfg, units, spec, fixed, timeline, points, *, names, scheme,
                  link_chunk):
    """One chunk of Pc grid points of a fabric sweep as Pc copies of the
    fabric's K links (point-major), each link carrying its point's values,
    so every batch holds Pc * link_chunk links -> per-point ``FabricStats``
    (or link-mean ``FabricChaosStats`` with a trailing step axis) with a
    leading (Pc,) axis."""
    from ..fabric.bringup import fabric_stats_impl  # local: fabric imports this module
    from ..fabric.chaos import FabricTimeline, _run_chaos, summarize_chaos
    from ..fabric.sampling import FabricUnits

    n_points, k = points.shape[0], spec.n_links
    over = dict(fixed)
    over.update({name: torch.from_numpy(np.ascontiguousarray(points[:, i])).repeat_interleave(k)
                 for i, name in enumerate(names)})
    var = Variations(**over)
    tiled = FabricUnits(*(u.repeat((n_points,) + (1,) * (u.dim() - 1)) for u in units))
    if timeline is None:
        return fabric_stats_impl(cfg, tiled, spec, var, scheme=scheme,
                                 link_chunk=n_points * link_chunk)
    tl = FabricTimeline(*(a.repeat((1, n_points) + (1,) * (a.dim() - 2)) for a in timeline))
    _, cs = _run_chaos(cfg, tiled, spec, tl, var, n_points=n_points, scheme=scheme, warm=True,
                       transactional=True, patience=4, hysteresis=0.0,
                       link_chunk=n_points * link_chunk)
    # link means per point and step: (S, Pc) -> (Pc, S)
    return _tree_map(lambda a: a.movedim(0, -1), summarize_chaos(cs))


def _afp_from_trial_min_tr(trial_min_tr: torch.Tensor, tr_values) -> torch.Tensor:
    """(..., T) per-trial min TR x (L,) TR axis -> (..., L) AFP grid.

    Exact against evaluating each TR point: ideal success at t is
    ``trial_min_tr <= t`` for every policy, and the AFP is the failure
    count over T, divided in float32 as the direct path divides it.
    """
    tr = torch.as_tensor(tr_values, dtype=torch.float32, device=trial_min_tr.device)
    ok = trial_min_tr[..., None, :] <= tr[:, None]
    return _trial_mean(~ok, trial_min_tr.shape[-1])


def sweep(request: SweepRequest) -> SweepResult:
    """Evaluate a ``SweepRequest``: the engine's single entry point
    (``sweep_policy`` / ``sweep_scheme`` / ``sweep_min_tr`` / ``sweep_grid``
    wrap it).  Returns the grid(s) and the axis metadata.  Under a phase
    recorder the whole call is the request's root span, ``sweep.request``."""
    with span("sweep.request"):
        return _sweep(request)


def _sweep(request: SweepRequest) -> SweepResult:
    cfg, units = request.cfg, request.units
    policy, scheme, metric = request.policy, request.scheme, request.metric
    names, points, shape = _grid_points(request.axes)
    coords = tuple(request.axes[n] for n in names)

    tr_idx = None
    if (policy is not None and metric == "eval" and request.tr_fast
            and "tr_mean" in names):
        # TR fast path: one per-trial min-TR evaluation per non-TR point,
        # then the whole TR axis is a broadcast threshold comparison.
        metric = "trial_min_tr"
        tr_idx = names.index("tr_mean")
        names = tuple(n for n in names if n != "tr_mean")
        shape = shape[:tr_idx] + shape[tr_idx + 1:]
        if names:
            points = _grid_points({n: request.axes[n] for n in names})[1]
        else:
            points = np.zeros((1, 0), np.float32)  # a single all-defaults point

    fixed = {k: np.float32(v) for k, v in request.fixed.items()}
    if request.fabric is not None:
        # Budget the *link* axis first (one fabric point is a 2 * link_chunk-
        # trial scheme evaluation), then fit grid points over it.
        from ..fabric.bringup import auto_link_chunk  # local: fabric imports this module

        link_chunk = auto_link_chunk(cfg, request.fabric.n_links)
        per_point = scheme_point_bytes(cfg, 2 * link_chunk)
        chunk = request.chunk_size or int(
            np.clip(_CHUNK_BUDGET // max(per_point, 1), 1, points.shape[0]))
        evaluate = lambda u, tl, pts: _fabric_chunk(  # noqa: E731
            cfg, u, request.fabric, fixed, tl, pts, names=names, scheme=scheme,
            link_chunk=link_chunk)
    else:
        link_chunk = 0
        chunk = request.chunk_size or _auto_chunk(cfg, units, points.shape[0], scheme)
        evaluate = lambda u, tl, pts: _eval_chunk(  # noqa: E731
            cfg, u, fixed, tl, pts, names=names, metric=metric, policy=policy,
            scheme=scheme)
    rec = current_recorder()
    if rec is not None:
        if request.fabric is None:
            trials = units.u_rlv.shape[0] * units.u_go.shape[0]
            per_point = (scheme_point_bytes(cfg, trials) if scheme is not None
                         else policy_point_bytes(cfg, trials))
        rec.note(
            "sweep.plan", points=int(points.shape[0]), chunk=int(chunk),
            n_chunks=-(-int(points.shape[0]) // int(chunk)),
            link_chunk=int(link_chunk), per_point_bytes=int(per_point),
            budget=_CHUNK_BUDGET, metric=metric,
            target=scheme if scheme is not None else policy,
        )
    out = measured_call("sweep", chunked_map, (evaluate, points),
                        {"chunk": chunk, "mesh": request.mesh,
                         "broadcast": (units, request.timeline), "tag": "sweep_points"},
                        budget=_CHUNK_BUDGET)
    if tr_idx is not None:
        afp = _afp_from_trial_min_tr(out.reshape(shape + out.shape[1:]),
                                     request.axes["tr_mean"])
        data = torch.movedim(afp, -1, tr_idx)
    else:
        data = _tree_map(lambda a: a.reshape(shape + a.shape[1:]), out)
    return SweepResult(data=data, axis_names=tuple(request.axes), coords=coords)


def sweep_grid(
    cfg: ArbitrationConfig,
    units: UnitSamples,
    axes: Mapping[str, np.ndarray],
    *,
    policy: str | None = None,
    scheme: str | None = None,
    metric: str = "eval",
    fixed: Mapping[str, float] | None = None,
    chunk_size: int | None = None,
    tr_fast: bool = True,
    mesh=None,
):
    """Bare-grid wrapper over ``sweep``: builds the ``SweepRequest`` and
    returns ``SweepResult.data`` only."""
    return sweep(SweepRequest(
        cfg=cfg, units=units, axes=axes, policy=policy, scheme=scheme,
        metric=metric, fixed=fixed, chunk_size=chunk_size, tr_fast=tr_fast,
        mesh=mesh,
    )).data


def sweep_policy(cfg, units, policy, axes, **kw):
    """Grid of AFP values for an ideal policy.  See ``SweepRequest``."""
    return sweep_grid(cfg, units, axes, policy=policy, **kw)


def sweep_scheme(cfg, units, scheme, axes, **kw) -> EvalResult:
    """EvalResult whose fields are grids, for an oblivious scheme."""
    return sweep_grid(cfg, units, axes, scheme=scheme, **kw)


def sweep_min_tr(cfg, units, policy, axes, **kw):
    """Grid of minimum mean tuning ranges for an ideal policy."""
    return sweep_grid(cfg, units, axes, policy=policy, metric="min_tr", **kw)


def sweep_reference(request: SweepRequest) -> SweepResult:
    """Per-point loop over the single-point entry points: the engine's
    oracle and a readable spec of what it computes.  Consumes the same
    validated ``SweepRequest``.  Its AFP and CAFP are the entry points'
    ``1 - mean`` and ``mean``, which equal the engine's counts over T as
    counts.  Never use on a hot path."""
    cfg, units = request.cfg, request.units
    policy, scheme = request.policy, request.scheme
    if request.timeline is not None:
        raise NotImplementedError(
            "sweep_reference has no temporal path; run_timeline is itself "
            "the per-point primitive a timeline sweep maps; compare against "
            "direct run_timeline calls instead"
        )
    if request.fabric is not None:
        raise NotImplementedError(
            "sweep_reference has no fabric path; its per-point primitive is "
            "fabric.bringup, and the per-link oracle one flat "
            "oblivious_arbitrate over every link's trials"
        )
    names, points, shape = _grid_points(request.axes)
    outs = []
    for vals in points:
        over = {k: np.float32(v) for k, v in request.fixed.items()}
        over.update({name: np.float32(v) for name, v in zip(names, vals)})
        var = Variations(**over)
        if request.metric == "min_tr":
            outs.append(policy_min_tr(cfg, units, policy, var))
        elif policy is not None:
            outs.append(evaluate_policy(cfg, units, policy, variations=var))
        else:
            outs.append(evaluate_scheme(cfg, units, scheme, variations=var))
    stacked = _tree_map(lambda *xs: torch.stack(xs), *outs)
    data = _tree_map(lambda a: a.reshape(shape + a.shape[1:]), stacked)
    return SweepResult(data=data, axis_names=names,
                       coords=tuple(request.axes[n] for n in names))


def sweep_grid_reference(
    cfg: ArbitrationConfig,
    units: UnitSamples,
    axes: Mapping[str, np.ndarray],
    *,
    policy: str | None = None,
    scheme: str | None = None,
    metric: str = "eval",
    fixed: Mapping[str, float] | None = None,
):
    """Bare-grid wrapper over ``sweep_reference`` (see there)."""
    return sweep_reference(SweepRequest(
        cfg=cfg, units=units, axes=axes, policy=policy, scheme=scheme,
        metric=metric, fixed=fixed,
    )).data

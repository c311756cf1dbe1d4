"""Declarative device-variation overrides: the ``Variations`` mapping and the
axis registry that makes variation sources first-class.

``register_axis(name, default, ...)``
    One registration makes a variation axis known everywhere at once: it is
    a valid ``Variations`` key and, through an optional ``transform`` hook,
    applied during ``instantiate``.

``Variations(**overrides)``
    A frozen name -> value mapping.  ``None`` means "use the config
    default" and is dropped at construction.  A value is a scalar, or a 1-D
    (P,) tensor holding one value per grid point (the sweep engine's
    flattened points; see ``sampling.instantiate``).

Resolution order for an axis value: the override in the ``Variations``
instance, else the registry default evaluated against the
``ArbitrationConfig`` (``sigma_rlv`` falls back to ``cfg.var.sigma_rlv``,
``tr_mean`` to ``cfg.grid.tr_mean``).
"""
from __future__ import annotations

import warnings
from typing import Any, Callable, Mapping, NamedTuple

import numpy as np
import torch


class AxisSpec(NamedTuple):
    """Registry record for one variation/TR axis.

    ``default``   cfg -> default value used when no override is present.
    ``validate``  optional check run on scalar override values.
    ``transform`` optional ``(sys, value, cfg) -> sys`` hook applied by
                  ``instantiate`` after the core sampling math whenever the
                  axis is overridden.
    """

    name: str
    default: Callable[[Any], Any]
    doc: str = ""
    validate: Callable[[float], None] | None = None
    transform: Callable[[Any, Any, Any], Any] | None = None


_AXIS_REGISTRY: dict[str, AxisSpec] = {}


def register_axis(
    name: str,
    default: Callable[[Any], Any],
    *,
    doc: str = "",
    validate: Callable[[float], None] | None = None,
    transform: Callable[[Any, Any, Any], Any] | None = None,
) -> AxisSpec:
    """Register a variation axis; re-binding a name is an error."""
    if not isinstance(name, str) or not name.isidentifier():
        raise ValueError(f"axis name must be an identifier, got {name!r}")
    if name in _AXIS_REGISTRY:
        raise ValueError(f"variation axis {name!r} already registered")
    spec = AxisSpec(name=name, default=default, doc=doc, validate=validate,
                    transform=transform)
    _AXIS_REGISTRY[name] = spec
    return spec


def axis_names() -> tuple[str, ...]:
    """Registered axis names, in registration order."""
    return tuple(_AXIS_REGISTRY)


def axis_spec(name: str) -> AxisSpec:
    try:
        return _AXIS_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown variation axis {name!r}; registered: {axis_names()}"
        ) from None


def _maybe_validate(spec: AxisSpec, value) -> None:
    """Run the axis check on a scalar value, and on each value of a per-point
    (P,) tensor; other arrays (per-channel offsets) are not checked."""
    if spec.validate is None:
        return
    if is_per_point(value):
        for v in value.tolist():
            spec.validate(float(v))
        return
    try:
        concrete = float(value)
    except (TypeError, ValueError, RuntimeError):
        return  # non-scalar value (e.g. a per-channel offset); nothing to check
    spec.validate(concrete)


def is_per_point(value) -> bool:
    """A 1-D tensor override holds one value per grid point."""
    return isinstance(value, torch.Tensor) and value.dim() == 1


def point_count(variations) -> int:
    """P, the length shared by the per-point overrides; 1 if there are none."""
    lengths = {name: v.shape[0] for name, v in variations.items() if is_per_point(v)}
    if len(set(lengths.values())) > 1:
        raise ValueError(f"per-point overrides differ in length: {lengths}")
    return next(iter(lengths.values()), 1)


def transform_axes() -> tuple[str, ...]:
    """The registered axes that carry a ``transform`` hook."""
    return tuple(name for name, spec in _AXIS_REGISTRY.items() if spec.transform is not None)


class Variations:
    """Frozen axis-name -> override mapping (see the module docstring)."""

    __slots__ = ("_overrides",)

    def __init__(self, **overrides):
        clean = {}
        for name in sorted(overrides):  # canonical key order
            value = overrides[name]
            if value is None:
                continue
            spec = axis_spec(name)
            _maybe_validate(spec, value)
            clean[name] = value
        object.__setattr__(self, "_overrides", clean)

    def __setattr__(self, name, value):
        raise AttributeError("Variations is immutable; use .replace(...)")

    @property
    def names(self) -> tuple[str, ...]:
        return tuple(self._overrides)

    def get(self, name: str, default=None):
        axis_spec(name)  # typo guard
        return self._overrides.get(name, default)

    def items(self) -> tuple:
        return tuple(self._overrides.items())

    def __contains__(self, name: str) -> bool:
        return name in self._overrides

    def __len__(self) -> int:
        return len(self._overrides)

    def __repr__(self) -> str:
        body = ", ".join(f"{k}={v!r}" for k, v in self._overrides.items())
        return f"Variations({body})"

    def replace(self, **overrides) -> "Variations":
        """New instance with overrides added/updated (``None`` removes)."""
        merged = dict(self._overrides)
        for name, value in overrides.items():
            if value is None:
                merged.pop(name, None)
            else:
                merged[name] = value
        return Variations(**merged)

    def merge(self, other) -> "Variations":
        """Union with a mapping/``Variations``; duplicate axes are an error."""
        items = dict(other.items()) if isinstance(other, Variations) else dict(other)
        items = {k: v for k, v in items.items() if v is not None}
        dup = sorted(set(items) & set(self._overrides))
        if dup:
            raise ValueError(f"variation axes specified twice: {dup}")
        return self.replace(**items)

    def resolve(self, name: str, cfg):
        """Override if present, else the registry default under ``cfg``."""
        spec = axis_spec(name)
        value = self._overrides.get(name)
        return spec.default(cfg) if value is None else value


def as_variations(value) -> Variations:
    """Coerce ``None`` / mapping / ``Variations`` to a ``Variations``."""
    if value is None:
        return Variations()
    if isinstance(value, Variations):
        return value
    if isinstance(value, Mapping):
        return Variations(**dict(value))
    raise TypeError(
        f"expected a Variations, mapping, or None, got {type(value).__name__}: "
        f"{value!r} — pass overrides as Variations(sigma_rlv=...) (the "
        "sigma_*= keywords remain as deprecated shims)"
    )


#: Keyword names of the pre-``Variations`` sampling and evaluation API, kept
#: as deprecated shims (in the order of the old ``instantiate`` signature).
LEGACY_SIGMA_KWARGS = (
    "sigma_rlv",
    "sigma_go",
    "sigma_llv_frac",
    "sigma_fsr_frac",
    "sigma_tr_frac",
    "fsr_mean",
)


def merge_legacy_overrides(variations, legacy: Mapping[str, Any], *,
                           caller: str, stacklevel: int = 3) -> Variations:
    """Fold deprecated ``sigma_*=`` keyword overrides into a ``Variations``.

    Emits one ``DeprecationWarning`` naming the keywords actually given;
    the result is the same ``Variations`` as passing those values in it, so
    results are bit-identical.  An axis given both ways is an error
    (``Variations.merge``).  ``stacklevel`` attributes the warning: 3 names
    the caller of a function that calls this directly (``instantiate``);
    evaluators with a frame in between pass 4, so that the warning names the
    user's call site.
    """
    base = as_variations(variations)
    given = {k: v for k, v in legacy.items() if v is not None}
    if not given:
        return base
    warnings.warn(
        f"{caller}: the {sorted(given)} keyword overrides are deprecated; "
        "pass variations=Variations(...) instead",
        DeprecationWarning,
        stacklevel=stacklevel,
    )
    return base.merge(given)


def apply_axis_transforms(sys, variations, cfg):
    """Run the ``transform`` hook of every overridden axis that has one, in
    axis registration order; axes without an override are skipped.
    ``variations`` is a ``Variations`` or a plain name -> value mapping; a
    value broadcasts against the (T, N) rows, so it may be a scalar, a
    per-channel (N,) offset or a per-trial (T, 1) column."""
    for name, spec in _AXIS_REGISTRY.items():
        if spec.transform is not None and name in variations:
            sys = spec.transform(sys, variations.get(name), cfg)
    return sys


# Built-in axes (paper §II-C, Table I).  Registration order is the
# engine-facing axis order.

def _nonneg(name: str) -> Callable[[float], None]:
    def check(v: float) -> None:
        if v < 0.0:
            raise ValueError(f"axis {name!r} must be >= 0, got {v}")
    return check


def _positive(name: str) -> Callable[[float], None]:
    def check(v: float) -> None:
        if v <= 0.0:
            raise ValueError(f"axis {name!r} must be > 0, got {v}")
    return check


def _llv_frac_check(v: float) -> None:
    if not 0.0 <= v < 0.5:
        raise ValueError(
            "axis 'sigma_llv_frac' must be in [0, 0.5) to keep the laser "
            f"grid monotone (paper §II-C), got {v}"
        )


def _offset(value, like: torch.Tensor):
    """A scalar stays a Python number (rounded to float32 by the op, as in
    the reference); an array-valued offset (per channel (N,), or per trial
    (T, 1) in a batch of grid points) becomes a tensor beside ``like``."""
    if isinstance(value, (int, float)):
        return value
    return torch.as_tensor(value, dtype=like.dtype, device=like.device)


def _aging_tilt(sys, value, cfg):
    # i / (N - 1) in float32 on the host: a CUDA divide by a host scalar
    # multiplies by its reciprocal, which is not the reference's division.
    n = sys.ring.shape[-1]
    tilt = np.arange(n, dtype=np.float32) / np.float32(max(1, n - 1))
    tilt = torch.from_numpy(tilt).to(sys.ring.device)
    return sys._replace(ring=sys.ring + _offset(value, sys.ring) * tilt)


register_axis(
    "tr_mean", lambda cfg: cfg.grid.tr_mean,
    doc="mean tuning range lambda_TR [nm] (the shmoo x-axis of Figs. 4/14-16)",
    validate=_positive("tr_mean"),
)
register_axis(
    "sigma_rlv", lambda cfg: cfg.var.sigma_rlv,
    doc="ring local resonance variation half-range [nm] (Table I)",
    validate=_nonneg("sigma_rlv"),
)
register_axis(
    "sigma_go", lambda cfg: cfg.var.sigma_go,
    doc="grid offset half-range sigma_lGV + sigma_rGV [nm] (Table I)",
    validate=_nonneg("sigma_go"),
)
register_axis(
    "sigma_llv_frac", lambda cfg: cfg.var.sigma_llv_frac,
    doc="laser local variation half-range, fraction of grid spacing",
    validate=_llv_frac_check,
)
register_axis(
    "sigma_fsr_frac", lambda cfg: cfg.var.sigma_fsr_frac,
    doc="FSR variation half-range, fraction of the FSR mean",
    validate=_nonneg("sigma_fsr_frac"),
)
register_axis(
    "sigma_tr_frac", lambda cfg: cfg.var.sigma_tr_frac,
    doc="tuning-range variation half-range, fraction of the TR mean",
    validate=_nonneg("sigma_tr_frac"),
)
register_axis(
    "fsr_mean", lambda cfg: cfg.grid.fsr,
    doc="mean free spectral range lambda_FSR [nm] (Fig. 8 design axis)",
    validate=_positive("fsr_mean"),
)
# Post-paper axis: a uniform thermal red-shift of every ring resonance.
register_axis(
    "thermal_drift", lambda cfg: 0.0,
    doc="uniform thermal red-shift of every ring resonance [nm]",
    transform=lambda sys, value, cfg: sys._replace(
        ring=sys.ring + _offset(value, sys.ring)),
)
# Drift sources of the temporal layer, also usable as static offsets.
register_axis(
    "comb_wander", lambda cfg: 0.0,
    doc="uniform comb-source wander: shift of every laser line [nm]",
    transform=lambda sys, value, cfg: sys._replace(
        laser=sys.laser + _offset(value, sys.laser)),
)
register_axis(
    "ring_aging", lambda cfg: 0.0,
    doc=("differential aging tilt across the ring row [nm]: ring i "
         "red-shifts by value * i / (N - 1)"),
    transform=_aging_tilt,
)

"""High-level arbitration API: the paper's LtC main path.

    from repro_torch.core.api import evaluate_scheme, make_units
    from repro_torch.configs.wdm import WDM8_G200
    units = make_units(WDM8_G200, seed=0, n_laser=100, n_ring=100)   # on CUDA
    r = evaluate_scheme(WDM8_G200, units, "vtrs_ssm", 8.96)

Overrides travel in one ``Variations`` mapping; ``tr_mean`` may also be
given positionally as the operating point.  The device of the unit samples
selects the path: CUDA tensors go through the hand-written kernels, CPU
tensors through their plain PyTorch versions.

Schemes are pluggable: ``register_scheme`` adds a wavelength-oblivious
arbiter, ``register_scheme_family`` stamps out parametrized variants.  The
port registers every scheme of the reference: the LtC schemes ``seq``,
``rs_ssm`` and ``vtrs_ssm``, the beyond-paper LtA arbiter ``seq_retry`` with
its retry-budget family, and the protocol-engine schemes ``protocol_lta``
(with its chain-depth family ``_h1``/``_h2``/``_h4``) and ``protocol_ltd``.
"""
from __future__ import annotations

from collections.abc import Mapping as _MappingABC
from collections.abc import Sequence as _SequenceABC
from typing import Any, Callable, Mapping, NamedTuple

import torch

from ..obs.phase import span
from . import ideal, metrics, prng
from .grid import ArbitrationConfig
from .lta_retry import sequential_retry
from .outcomes import classify
from .protocol import run_protocol
from .relation import chain_spec, relation_search
from .sampling import (SystemBatch, UnitSamples, draw_unit_samples, instantiate,
                       per_trial, resolve_device)
from .search_table import build_search_tables
from .sequential import sequential_tuning
from .ssm import Assignment, single_step_matching
from .variations import Variations, as_variations, merge_legacy_overrides, point_count

# An arbiter maps (cfg, tables, spec) -> Assignment using only oblivious
# primitives (entry indices and masking events; never wavelength values).
Arbiter = Callable[..., Assignment]

class SchemeSpec(NamedTuple):
    """Registry record for a wavelength-oblivious arbitration scheme.

    ``params`` carries the static parameters a parametrized variant was
    built with (introspection only; the values are baked into the arbiter).
    """

    name: str
    arbiter: Arbiter
    policy: str  # conditioning ideal policy for CAFP: "ltc" | "lta" | "ltd"
    params: tuple = ()


_SCHEME_REGISTRY: dict[str, SchemeSpec] = {}


def register_scheme(
    name: str,
    arbiter: Arbiter,
    *,
    policy: str = "ltc",
    params: Mapping[str, Any] | None = None,
) -> SchemeSpec:
    """Register an oblivious arbitration scheme under ``name``.

    ``policy`` selects the ideal arbiter the scheme is scored against (CAFP
    conditioning event).  Duplicate registration is an error.
    """
    if name in _SCHEME_REGISTRY:
        raise ValueError(f"scheme {name!r} already registered")
    if policy not in ("ltd", "ltc", "lta"):
        raise ValueError(f"unknown conditioning policy {policy!r}")
    frozen = tuple(sorted(dict(params or {}).items()))
    spec = SchemeSpec(name=name, arbiter=arbiter, policy=policy, params=frozen)
    _SCHEME_REGISTRY[name] = spec
    return spec


def register_scheme_family(
    base: str,
    factory: Callable[..., Arbiter],
    variants: Mapping[str, Mapping[str, Any]],
    *,
    policy: str = "ltc",
) -> tuple[SchemeSpec, ...]:
    """Register ``f"{base}_{suffix}"`` for each variant, with
    ``factory(**params)`` as its arbiter."""
    return tuple(
        register_scheme(f"{base}_{suffix}", factory(**dict(params)),
                        policy=policy, params=params)
        for suffix, params in variants.items()
    )


def scheme_spec(name: str) -> SchemeSpec:
    try:
        return _SCHEME_REGISTRY[name]
    except KeyError:
        raise ValueError(
            f"unknown scheme {name!r}; registered: {registered_schemes()}"
        ) from None


def registered_schemes() -> tuple[str, ...]:
    return tuple(_SCHEME_REGISTRY)


class _SchemeNamesView(_SequenceABC):
    """Live, read-only sequence view of the registered scheme names (a
    scheme registered later shows through it)."""

    def __getitem__(self, i):
        return tuple(_SCHEME_REGISTRY)[i]

    def __len__(self) -> int:
        return len(_SCHEME_REGISTRY)

    def __contains__(self, name) -> bool:
        return name in _SCHEME_REGISTRY

    def __iter__(self):
        return iter(tuple(_SCHEME_REGISTRY))

    def __eq__(self, other):
        try:
            return tuple(self) == tuple(other)
        except TypeError:
            return NotImplemented

    __hash__ = None

    def __repr__(self) -> str:
        return f"SCHEMES{tuple(_SCHEME_REGISTRY)}"


class _SchemePolicyView(_MappingABC):
    """Live, read-only mapping view: scheme name -> conditioning policy."""

    def __getitem__(self, name: str) -> str:
        return _SCHEME_REGISTRY[name].policy

    def __len__(self) -> int:
        return len(_SCHEME_REGISTRY)

    def __iter__(self):
        return iter(tuple(_SCHEME_REGISTRY))

    def __repr__(self) -> str:
        return f"SCHEME_POLICY({dict(self)})"


SCHEMES = _SchemeNamesView()
SCHEME_POLICY = _SchemePolicyView()


register_scheme("seq", lambda cfg, tables, spec: sequential_tuning(tables, spec))
register_scheme(
    "rs_ssm",
    lambda cfg, tables, spec: single_step_matching(
        tables, relation_search(tables, spec, variation_tolerant=False), spec
    ),
)
register_scheme(
    "vtrs_ssm",
    lambda cfg, tables, spec: single_step_matching(
        tables, relation_search(tables, spec, variation_tolerant=True), spec
    ),
)


def make_seq_retry(n_rounds: int | None = None,
                   constrained_first: bool = True) -> Arbiter:
    """Factory for retry-budgeted oblivious LtA arbiters (§V-E future work).

    ``n_rounds`` caps the conflict-retry sweeps (None = N_ch, enough for
    convergence); ``constrained_first`` picks the lock order.
    """
    def arbiter(cfg, tables, spec):
        return sequential_retry(
            tables, n_rounds=n_rounds, constrained_first=constrained_first
        )
    return arbiter


# Beyond-paper oblivious LtA: the full-budget arbiter plus a retry-budget
# family for the budget/CAFP trade-off study (fig17).
register_scheme("seq_retry", make_seq_retry(), policy="lta")
register_scheme_family(
    "seq_retry",
    make_seq_retry,
    {
        "r1": {"n_rounds": 1},
        "r2": {"n_rounds": 2},
        "r4": {"n_rounds": 4},
        "phys": {"n_rounds": None, "constrained_first": False},
    },
    policy="lta",
)


def make_protocol(depth: int | None = None, n_rounds: int | None = None,
                  order: str = "constrained") -> Arbiter:
    """Factory for protocol-engine arbiters (``core.protocol``).

    ``depth`` bounds the displacement chains (None = N, full multi-hop; 0 =
    probe/release only), ``n_rounds`` the round budget, ``order`` the
    probe-phase controller order.  The arbiter carries these settings as
    ``protocol_kwargs``, which re-arbitration (``core.temporal``) passes to
    ``run_protocol`` with its own warm-start options.
    """
    kwargs = {"order": order, "depth": depth, "n_rounds": n_rounds}

    def arbiter(cfg, tables, spec):
        return run_protocol(tables, spec, **kwargs)
    arbiter.protocol_kwargs = kwargs
    return arbiter


# Protocol-engine schemes: multi-hop augmenting LtA (it closes seq_retry's
# residual mid-TR CAFP), its chain-depth family for the probe-budget
# trade-off (fig19), and the LtD-conditioned chain-order variant.
register_scheme("protocol_lta", make_protocol(), policy="lta")
register_scheme_family(
    "protocol_lta",
    make_protocol,
    {
        "h1": {"depth": 1},
        "h2": {"depth": 2},
        "h4": {"depth": 4},
    },
    policy="lta",
)
register_scheme(
    "protocol_ltd",
    make_protocol(depth=0, n_rounds=1, order="chain"),
    policy="ltd",
)


def _eval_variations(variations, tr_mean, legacy: dict, *, caller: str,
                     allow_tr: bool = True) -> Variations:
    """Normalize an evaluator's (tr_mean, variations, legacy keyword) inputs."""
    # stacklevel 4: this helper adds a frame between the user and the warning
    over = merge_legacy_overrides(variations, legacy, caller=caller, stacklevel=4)
    if tr_mean is not None:
        if "tr_mean" in over:
            raise ValueError(
                f"{caller}: tr_mean passed both positionally and in variations"
            )
        over = over.replace(tr_mean=tr_mean)
    if not allow_tr and "tr_mean" in over:
        raise ValueError(
            f"{caller}: min-TR evaluation solves for the tuning range; "
            "'tr_mean' cannot be overridden"
        )
    return over


def oblivious_arbitrate(
    cfg: ArbitrationConfig,
    sys: SystemBatch,
    tr_mean,
    scheme: str,
    *,
    visible=None,
) -> Assignment:
    """Run a wavelength-oblivious arbitration scheme on a system batch.

    ``visible`` ((T, N_wl) or (T, N_ring, N_wl) bool) runs the scheme on
    masked re-search tables — the arbitration a late-joining ring performs
    while earlier locks have already captured lines.
    """
    arbiter = scheme_spec(scheme).arbiter
    tables = build_search_tables(sys, tr_mean, visible=visible,
                                 max_alias=cfg.max_fsr_alias)
    with span("arbiters.scheme", scheme=scheme):
        return arbiter(cfg, tables, chain_spec(cfg.s))


class EvalResult(NamedTuple):
    afp: torch.Tensor          # policy-level failure probability (ideal policy)
    cafp: torch.Tensor         # conditional algorithmic failure (Eq. 6)
    lock_err: torch.Tensor     # CAFP portion from zero/dup lock errors
    order_err: torch.Tensor    # CAFP portion from lane-order errors
    alg_success: torch.Tensor  # (T,) bool
    ideal_ok: torch.Tensor     # (T,) bool


class SchemeTrials(NamedTuple):
    """Per-trial outcomes of a scheme evaluation, all (T,) bool."""

    alg_success: torch.Tensor  # the oblivious scheme arbitrated correctly
    ideal_ok: torch.Tensor     # the ideal arbiter of its policy succeeds
    lock_err: torch.Tensor     # ideal succeeds, scheme left a zero/dup lock
    order_err: torch.Tensor    # ideal succeeds, scheme broke the lane order


def _trial_tr(over: Variations, cfg: ArbitrationConfig, sys: SystemBatch):
    """The operating point: a scalar, or one per trial for per-point values."""
    return per_trial(over.resolve("tr_mean", cfg), point_count(over), sys.n_trials,
                     sys.laser.device)


def scheme_trials(
    cfg: ArbitrationConfig,
    units: UnitSamples,
    scheme: str,
    variations: Variations | None = None,
) -> SchemeTrials:
    """The per-trial body of ``evaluate_scheme``: instantiate, arbitrate,
    classify against the scheme's ideal policy.  With per-point variations
    (1-D tensors, see ``sampling.instantiate``) every point's trials run in
    one batch, point-major."""
    with span("sampling.scheme_trials"):
        over = as_variations(variations)
        policy = scheme_spec(scheme).policy
        sys = instantiate(cfg, units, over)
        tr = _trial_tr(over, cfg, sys)
        ideal_ok = ideal.success(sys, policy, cfg.s, tr)
        assign = oblivious_arbitrate(cfg, sys, tr, scheme)
        out = classify(assign, cfg.s, policy=policy)
        return SchemeTrials(
            alg_success=out.success,
            ideal_ok=ideal_ok,
            lock_err=(out.zero_lock | out.dup_lock) & ideal_ok,
            order_err=out.order_err & ideal_ok,
        )


def evaluate_scheme(
    cfg: ArbitrationConfig,
    units: UnitSamples,
    scheme: str,
    tr_mean=None,
    variations: Variations | None = None,
    sigma_rlv=None,
    sigma_fsr_frac=None,
    sigma_tr_frac=None,
    sigma_go=None,
    sigma_llv_frac=None,
    fsr_mean=None,
) -> EvalResult:
    """Instantiate systems, run the scheme, and score CAFP against the
    scheme's ideal policy (Eq. 6).  The ``sigma_*=`` and ``fsr_mean=``
    keywords are deprecated shims: they warn, and give the results of the
    same values passed in ``variations``."""
    over = _eval_variations(
        variations, tr_mean,
        dict(sigma_rlv=sigma_rlv, sigma_fsr_frac=sigma_fsr_frac,
             sigma_tr_frac=sigma_tr_frac, sigma_go=sigma_go,
             sigma_llv_frac=sigma_llv_frac, fsr_mean=fsr_mean),
        caller="evaluate_scheme",
    )
    r = scheme_trials(cfg, units, scheme, over)
    return EvalResult(
        afp=metrics.afp(r.ideal_ok),
        cafp=metrics.cafp(r.alg_success, r.ideal_ok),
        lock_err=torch.mean(r.lock_err.to(torch.float32)),
        order_err=torch.mean(r.order_err.to(torch.float32)),
        alg_success=r.alg_success,
        ideal_ok=r.ideal_ok,
    )


def policy_trials(
    cfg: ArbitrationConfig,
    units: UnitSamples,
    policy: str,
    variations: Variations | None = None,
) -> torch.Tensor:
    """The per-trial body of ``evaluate_policy``: (T,) bool ideal success."""
    with span("sampling.policy_trials"):
        over = as_variations(variations)
        sys = instantiate(cfg, units, over)
        return ideal.success(sys, policy, cfg.s, _trial_tr(over, cfg, sys))


def evaluate_policy(
    cfg: ArbitrationConfig,
    units: UnitSamples,
    policy: str,
    tr_mean=None,
    variations: Variations | None = None,
    sigma_rlv=None,
    sigma_go=None,
    sigma_llv_frac=None,
    sigma_fsr_frac=None,
    sigma_tr_frac=None,
    fsr_mean=None,
) -> torch.Tensor:
    """Ideal-model policy evaluation: AFP at a given mean tuning range (the
    ``sigma_*=`` keywords as in ``evaluate_scheme``)."""
    over = _eval_variations(
        variations, tr_mean,
        dict(sigma_rlv=sigma_rlv, sigma_go=sigma_go, sigma_llv_frac=sigma_llv_frac,
             sigma_fsr_frac=sigma_fsr_frac, sigma_tr_frac=sigma_tr_frac,
             fsr_mean=fsr_mean),
        caller="evaluate_policy",
    )
    return metrics.afp(policy_trials(cfg, units, policy, over))


def policy_trial_min_tr(
    cfg: ArbitrationConfig,
    units: UnitSamples,
    policy: str,
    variations: Variations | None = None,
    sigma_rlv=None,
    sigma_go=None,
    sigma_llv_frac=None,
    sigma_fsr_frac=None,
    sigma_tr_frac=None,
    fsr_mean=None,
) -> torch.Tensor:
    """(T,) per-trial ideal minimum mean TR at the given variation overrides
    (every point's trials, for per-point overrides; the ``sigma_*=``
    keywords as in ``evaluate_scheme``)."""
    with span("sampling.policy_trial_min_tr"):
        over = _eval_variations(
            variations, None,
            dict(sigma_rlv=sigma_rlv, sigma_go=sigma_go, sigma_llv_frac=sigma_llv_frac,
                 sigma_fsr_frac=sigma_fsr_frac, sigma_tr_frac=sigma_tr_frac,
                 fsr_mean=fsr_mean),
            caller="policy_min_tr", allow_tr=False,
        )
        sys = instantiate(cfg, units, over)
        return ideal.min_tr(sys, policy, cfg.s)


def policy_min_tr(
    cfg: ArbitrationConfig,
    units: UnitSamples,
    policy: str,
    variations: Variations | None = None,
    sigma_rlv=None,
    sigma_go=None,
    sigma_llv_frac=None,
    sigma_fsr_frac=None,
    sigma_tr_frac=None,
    fsr_mean=None,
) -> torch.Tensor:
    """Minimum mean TR for complete arbitration success over the batch (the
    ``sigma_*=`` keywords as in ``evaluate_scheme``)."""
    over = _eval_variations(
        variations, None,
        dict(sigma_rlv=sigma_rlv, sigma_go=sigma_go, sigma_llv_frac=sigma_llv_frac,
             sigma_fsr_frac=sigma_fsr_frac, sigma_tr_frac=sigma_tr_frac,
             fsr_mean=fsr_mean),
        caller="policy_min_tr", allow_tr=False,
    )
    return metrics.min_tr_for_complete_success(policy_trial_min_tr(cfg, units, policy, over))


def make_units(cfg: ArbitrationConfig, seed: int, n_laser: int, n_ring: int,
               device=None, *, partitionable: bool = True) -> UnitSamples:
    """The reference's unit samples for ``seed``, bit for bit: its threefry
    draws (``core.prng``) made on the CPU, then moved to ``device`` (CUDA
    unless named).  ``partitionable=True`` is JAX's default counter layout,
    the one the reference's ``make_units`` draws under; ``False`` is the
    earlier layout, under which ``BENCH_sweep.json`` was recorded."""
    dev = resolve_device(device)
    key = prng.key_from_seed(seed)
    units = draw_unit_samples(key, cfg.grid.n_ch, n_laser, n_ring,
                              partitionable=partitionable)
    return UnitSamples(*(u.to(dev) for u in units))


def shmoo(
    cfg: ArbitrationConfig,
    units: UnitSamples,
    sigma_rlv_values,
    tr_values,
    *,
    policy: str | None = None,
    scheme: str | None = None,
) -> torch.Tensor:
    """AFP (policy) or CAFP (scheme) over a sigma_rLV x TR grid (Fig. 4/14),
    through the sweep engine (see ``core.sweep``)."""
    from .sweep import SweepRequest, sweep  # local: sweep imports this module

    if (policy is None) == (scheme is None):
        raise ValueError("exactly one of policy/scheme required")
    res = sweep(SweepRequest(
        cfg=cfg, units=units, policy=policy, scheme=scheme,
        axes={"sigma_rlv": sigma_rlv_values, "tr_mean": tr_values},
    ))
    return res.data if policy is not None else res.data.cafp

"""Declarative fabric topology: pods, link bundles, comb groups, routes.

The port's copy of the reference's ``fabric/spec.py`` (pure numpy), with
the ``comb_coupling`` axis registered in the port's own axis registry.

A ``FabricSpec`` describes a DWDM fabric the way the network-level related
work frames it (*Scheduling Light-trails on WDM Rings*, *Multi-Path RWA* —
PAPERS.md): pods connected by *bundles* of point-to-point DWDM links, each
link a pair of N-ring transceivers sharing one comb's light, with routes as
pod sequences subject to per-hop availability and wavelength-continuity
constraints.  The spec is a frozen, hashable dataclass, like
``ArbitrationConfig``, and all derived topology arrays (link -> pod pair,
comb group, route hop maps) are host-side numpy.

Comb-source sharing is the fabric-level coupling knob: links in one comb
group draw *correlated* laser variations, blended by the ``comb_coupling``
variation axis registered below (0 = fully private draws, the constraints-
off limit that is bit-identical to independent per-link arbitration; 1 =
identical group draws).  ``comb_group`` picks the sharing topology:

  "link"    one comb per link (no coupling; mixing is the identity)
  "bundle"  all links of a pod pair share one comb
  "pod"     all bundles out of the lower-numbered pod share one comb
  "fabric"  a single comb bank drives every link
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..core.variations import axis_names, register_axis

_COMB_GROUPS = ("link", "bundle", "pod", "fabric")


def _coupling_check(v: float) -> None:
    if not 0.0 <= v <= 1.0:
        raise ValueError(
            f"axis 'comb_coupling' must be in [0, 1], got {v}"
        )


# Fabric-level variation axis, registered through the axis registry: one call makes it a valid ``Variations`` key and a sweepable
# ``SweepRequest`` axis with no engine edits.  No ``transform`` hook — the
# fabric sampler consumes it directly when blending comb-group draws
# (a per-link quantity, invisible to the single-transceiver sampler).
if "comb_coupling" not in axis_names():  # idempotent under module reload
    register_axis(
        "comb_coupling", lambda cfg: 0.0,
        doc=("shared-comb coupling strength in [0, 1]: laser variation "
             "draws blend (1-c)*private + c*group within a comb group"),
        validate=_coupling_check,
    )


@dataclasses.dataclass(frozen=True)
class FabricSpec:
    """A complete fabric topology description (frozen and hashable).

    pods:           number of pods; every unordered pod pair gets a bundle.
    links_per_pair: links (transceiver pairs) per pod-pair bundle.
    comb_group:     comb-source sharing topology (see module docstring).
    routes:         tuple of routes, each a tuple of >= 2 pod ids whose
                    consecutive pairs name the bundles the route traverses.
                    Route metrics (``FabricStats.route_up`` /
                    ``route_cont``) are vacuously 1.0 when empty.
    fallbacks:      optional per-route alternatives for graceful
                    degradation: empty, or one tuple per primary route,
                    each a (possibly empty) tuple of alternative routes
                    sharing the primary's endpoints.  The degraded-mode
                    metrics (``FabricStats.route_served`` /
                    ``route_cont_served`` / ``route_bandwidth``) score a
                    route by its best alternative; the primary-only
                    ``route_up`` / ``route_cont`` metrics ignore them.
    """

    pods: int = 2
    links_per_pair: int = 8
    comb_group: str = "link"
    routes: tuple = ()
    fallbacks: tuple = ()

    def _check_route(self, route) -> None:
        if len(route) < 2:
            raise ValueError(f"route {route} needs >= 2 pods")
        for a, b in zip(route, route[1:]):
            if a == b:
                raise ValueError(f"route {route} repeats pod {a}")
            if not (0 <= a < self.pods and 0 <= b < self.pods):
                raise ValueError(
                    f"route {route} names a pod outside 0..{self.pods - 1}"
                )

    def __post_init__(self):
        object.__setattr__(self, "routes",
                           tuple(tuple(int(p) for p in r) for r in self.routes))
        object.__setattr__(self, "fallbacks", tuple(
            tuple(tuple(int(p) for p in alt) for alt in alts)
            for alts in self.fallbacks
        ))
        if self.pods < 2:
            raise ValueError(f"a fabric needs >= 2 pods, got {self.pods}")
        if self.links_per_pair < 1:
            raise ValueError(
                f"links_per_pair must be >= 1, got {self.links_per_pair}"
            )
        if self.comb_group not in _COMB_GROUPS:
            raise ValueError(
                f"unknown comb_group {self.comb_group!r}; valid: {_COMB_GROUPS}"
            )
        for route in self.routes:
            self._check_route(route)
        if self.fallbacks and len(self.fallbacks) != len(self.routes):
            raise ValueError(
                f"fallbacks must be empty or one tuple per route: got "
                f"{len(self.fallbacks)} for {len(self.routes)} routes"
            )
        for route, alts in zip(self.routes, self.fallbacks):
            for alt in alts:
                self._check_route(alt)
                if (alt[0], alt[-1]) != (route[0], route[-1]):
                    raise ValueError(
                        f"fallback {alt} does not share route {route}'s "
                        f"endpoints ({route[0]}, {route[-1]})"
                    )

    # ---------------------------------------------------------- topology
    @property
    def pairs(self) -> tuple:
        """Unordered pod pairs (a < b), bundle index order."""
        return tuple(
            (a, b)
            for a in range(self.pods)
            for b in range(a + 1, self.pods)
        )

    @property
    def n_pairs(self) -> int:
        return self.pods * (self.pods - 1) // 2

    @property
    def n_links(self) -> int:
        return self.n_pairs * self.links_per_pair

    def link_pair(self) -> np.ndarray:
        """(n_links,) int: bundle (pod-pair) index of each link."""
        return np.repeat(np.arange(self.n_pairs), self.links_per_pair)

    def link_pods(self) -> tuple:
        """((n_links,) src pod, (n_links,) dst pod) with src < dst."""
        pairs = np.asarray(self.pairs, np.int64).reshape(-1, 2)
        lp = self.link_pair()
        return pairs[lp, 0], pairs[lp, 1]

    def link_in_pair(self) -> np.ndarray:
        """(n_links,) int: index of each link within its bundle."""
        return np.tile(np.arange(self.links_per_pair), self.n_pairs)

    # -------------------------------------------------------- comb groups
    def link_group(self) -> np.ndarray:
        """(n_links,) int: comb group of each link (see ``n_groups``)."""
        if self.comb_group == "link":
            return np.arange(self.n_links)
        if self.comb_group == "bundle":
            return self.link_pair()
        if self.comb_group == "pod":
            return self.link_pods()[0]
        return np.zeros(self.n_links, np.int64)  # "fabric"

    @property
    def n_groups(self) -> int:
        return int(self.link_group().max()) + 1

    # ------------------------------------------------------------- routes
    @property
    def max_hops(self) -> int:
        return max((len(r) - 1 for r in self.routes), default=0)

    def route_hops(self) -> np.ndarray:
        """(n_routes, max_hops) int: bundle index per hop, -1 padding."""
        pair_index = {p: i for i, p in enumerate(self.pairs)}
        hops = np.full((len(self.routes), max(self.max_hops, 1)), -1, np.int64)
        for ri, route in enumerate(self.routes):
            for hi, (a, b) in enumerate(zip(route, route[1:])):
                hops[ri, hi] = pair_index[(min(a, b), max(a, b))]
        return hops

    def route_alternatives(self) -> tuple:
        """Per-route alternative sets for the degraded-mode metrics.

        Returns ``(hops, valid)``: ``hops`` is (n_routes, n_alts, max_hops)
        int with bundle index per hop (-1 padding), alternative 0 always the
        primary route; ``valid`` is (n_routes, n_alts) bool marking real
        alternatives (routes with fewer fallbacks are padded with invalid
        rows).  With no fallbacks declared every route has exactly its
        primary (``hops[:, :1] == route_hops()[:, None]``).
        """
        pair_index = {p: i for i, p in enumerate(self.pairs)}
        alts_per = [
            (route,) + (self.fallbacks[ri] if self.fallbacks else ())
            for ri, route in enumerate(self.routes)
        ]
        n_alts = max((len(a) for a in alts_per), default=1)
        max_h = max(
            (len(r) - 1 for alts in alts_per for r in alts), default=1
        )
        hops = np.full((len(self.routes), n_alts, max(max_h, 1)), -1, np.int64)
        valid = np.zeros((len(self.routes), n_alts), bool)
        for ri, alts in enumerate(alts_per):
            for ai, route in enumerate(alts):
                valid[ri, ai] = True
                for hi, (a, b) in enumerate(zip(route, route[1:])):
                    hops[ri, ai, hi] = pair_index[(min(a, b), max(a, b))]
        return hops, valid

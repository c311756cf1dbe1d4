"""Named fabric topologies for tests, demos and the fig21 benchmark.

Each preset pairs a WDM config key with a ``FabricSpec`` (see
``repro_torch.fabric.spec``).  Link counts: a ``pods``-pod fabric has
``pods*(pods-1)/2`` bundles of ``links_per_pair`` links each.
"""
from __future__ import annotations

from repro_torch.fabric.spec import FabricSpec


def ring_routes(pods: int, hops: int = 2) -> tuple:
    """One ``hops``-hop route starting at every pod around the pod ring.

    The WDM-ring scheduling topology of the related work (*Scheduling
    Light-trails on WDM Rings*): route i traverses pods
    ``i, i+1, ..., i+hops`` modulo ``pods`` — every hop a distinct bundle,
    every bundle covered, so the route-continuity metric exercises the
    whole fabric.
    """
    if not 1 <= hops < pods:
        raise ValueError(f"ring routes need 1 <= hops < pods, got {hops}")
    return tuple(
        tuple((i + j) % pods for j in range(hops + 1)) for i in range(pods)
    )


# Tiny fabric for tests and smoke runs: 3 bundles x 2 links,
# shared combs per bundle, one 2-hop route (WDM8: 6 links, 12 trials).
FABRIC_TINY = FabricSpec(
    pods=3, links_per_pair=2, comb_group="bundle",
    routes=ring_routes(3, 1) + ((0, 1, 2),),
)

# The fig21 headline fabric: 8 pods, 28 bundles x 36 links = 1008 links
# (2016 transceiver trials, one chunk at WDM16; the >= 1k-link acceptance
# scale), bundle-shared combs, 2-hop ring routes.
FABRIC_1K = FabricSpec(
    pods=8, links_per_pair=36, comb_group="bundle", routes=ring_routes(8, 2),
)

# Pod-level comb sharing at 10k links (16 pods, 120 bundles x 84 links) —
# the 10k-100k regime of the scalability argument; the link axis chunks
# internally, so memory stays at one chunk regardless of fabric size.
FABRIC_10K = FabricSpec(
    pods=16, links_per_pair=84, comb_group="pod", routes=ring_routes(16, 3),
)

# Mid-size chaos fabric for the fig22 scenario gates: 4 pods x 6 bundles
# x 8 links = 48 links at WDM16 — big enough that a comb outage takes a
# whole bundle down, small enough for per-scenario warm-vs-cold gates in
# CI.  Every 2-hop ring route declares the opposite-way fallback around
# the pod ring, so the degraded-mode metrics have a real reroute to find
# when a bundle dies.
FABRIC_MID = FabricSpec(
    pods=4, links_per_pair=8, comb_group="bundle",
    routes=ring_routes(4, 2),
    fallbacks=tuple(
        (tuple((i + j) % 4 for j in (0, 3, 2)),) for i in range(4)
    ),
)

FABRIC_CONFIGS = {
    "tiny-wdm8": ("wdm8-g200", FABRIC_TINY),
    "mid-wdm16": ("wdm16-g200", FABRIC_MID),
    "fabric1k-wdm16": ("wdm16-g200", FABRIC_1K),
    "fabric10k-wdm16": ("wdm16-g200", FABRIC_10K),
}

# --- fabric chaos scenarios (fig22: fault injection + warm re-lock)
#
# Each entry: (fabric config key, timeline spec).  Drift magnitudes are
# multiples of the config's grid spacing, resolved to nm by
# ``chaos_timeline`` exactly like ``wdm.drift_timeline``; events are the
# ``repro_torch.fabric.chaos.make_fabric_timeline`` forms, with liveness
# persisting from the event's step onward.
CHAOS_SCENARIOS = {
    # kill-and-heal: one link flaps dead for two steps mid-ramp — post-heal
    # bandwidth must recover to the pre-fault value (the fig22 heal gate)
    "mid-linkflap": (
        "mid-wdm16",
        dict(n_steps=6, thermal=0.3, events=((2, "link_flap", 3, 2),)),
    ),
    # comb-source outage: bundle (0,1)'s comb dies and every link drawing
    # its light loses all lines together, then the spare comb comes up —
    # the two primary routes crossing that bundle go down (``route_up``
    # dips) but ``route_served`` rides the declared fallbacks through the
    # outage
    "mid-combout": (
        "mid-wdm16",
        dict(n_steps=6, comb=(0.2, 6.0),
             events=((2, "comb_kill", 0), (4, "comb_heal", 0))),
    ),
    # correlated pod heating: every link touching pod 1 ramps together
    # while the rest of the fabric idles — only the hot links re-lock
    "mid-podheat": (
        "mid-wdm16",
        dict(n_steps=6, pod_thermal={1: 0.8}),
    ),
    # ring death: two rings on one endpoint die permanently under a mild
    # fabric-wide ramp; the link degrades but its survivors stay locked
    "mid-ringdeath": (
        "mid-wdm16",
        dict(n_steps=6, thermal=0.3,
             events=((2, "ring_kill", 5, 0, 3), (2, "ring_kill", 5, 0, 9))),
    ),
    # tiny WDM8 kill-and-heal for smoke runs and tests
    "tiny-flap": (
        "tiny-wdm8",
        dict(n_steps=4, thermal=0.2, events=((1, "link_flap", 1, 2),)),
    ),
}


def chaos_timeline(name: str, device=None):
    """Resolve a ``CHAOS_SCENARIOS`` entry -> (cfg, spec, FabricTimeline)
    with drift multipliers scaled by the config's grid spacing [nm]; the
    timeline lies on CUDA unless ``device`` names another."""
    from repro_torch.fabric.chaos import make_fabric_timeline  # avoid an import cycle

    from .wdm import WDM_CONFIGS

    fab_key, tspec = CHAOS_SCENARIOS[name]
    cfg_key, spec = FABRIC_CONFIGS[fab_key]
    cfg = WDM_CONFIGS[cfg_key]
    sp = cfg.grid.grid_spacing
    kw = dict(tspec)
    n_steps = kw.pop("n_steps")
    if "thermal" in kw:
        kw["thermal"] = kw["thermal"] * sp
    if "pod_thermal" in kw:
        kw["pod_thermal"] = {
            pod: prof * sp for pod, prof in kw["pod_thermal"].items()
        }
    if "comb" in kw:
        amp, period = kw["comb"]
        kw["comb"] = (amp * sp, period)
    return cfg, spec, make_fabric_timeline(
        spec, n_steps, cfg.grid.n_ch, device=device, **kw
    )

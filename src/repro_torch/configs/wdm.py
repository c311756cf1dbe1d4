"""The paper's own DWDM system configurations (Table I / Fig. 5)."""
from repro_torch.core.grid import wdm_config

WDM8_G200 = wdm_config(n_ch=8, ghz=200)     # paper default (Table I)
WDM8_G400 = wdm_config(n_ch=8, ghz=400)
WDM16_G200 = wdm_config(n_ch=16, ghz=200)
WDM16_G400 = wdm_config(n_ch=16, ghz=400)
# Beyond-paper scale (§V scaling discussion): 32 and 64 channels.
WDM32_G200 = wdm_config(n_ch=32, ghz=200)
WDM32_G400 = wdm_config(n_ch=32, ghz=400)
WDM64_G200 = wdm_config(n_ch=64, ghz=200)
WDM64_G400 = wdm_config(n_ch=64, ghz=400)

WDM_CONFIGS = {
    "wdm8-g200": WDM8_G200,
    "wdm8-g400": WDM8_G400,
    "wdm16-g200": WDM16_G200,
    "wdm16-g400": WDM16_G400,
    "wdm32-g200": WDM32_G200,
    "wdm32-g400": WDM32_G400,
    "wdm64-g200": WDM64_G200,
    "wdm64-g400": WDM64_G400,
}

# Temporal drift scenarios (re-arbitration under drift, aging and failure).
# Each entry: (wdm config key, timeline spec).  Drift magnitudes are
# multiples of the config's grid spacing, so a scenario means the same thing
# at 200 and 400 GHz; ``drift_timeline`` resolves them to nm.  Events are
# (step, kind, channel), liveness changes persisting from ``step`` on.
DRIFT_SCENARIOS = {
    # slow uniform thermal ramp: every lock drifts red-ward together
    "wdm16-thermal": ("wdm16-g200", dict(n_steps=8, thermal=0.6)),
    # differential aging tilt: high-index rings outrun their locks first
    "wdm16-aging": ("wdm16-g200", dict(n_steps=8, aging=0.5)),
    # comb-source wander: sinusoidal, locks break then become feasible again
    "wdm16-comb": ("wdm16-g200", dict(n_steps=8, comb=(0.4, 8.0))),
    # mild ramp plus a lane failure and hot-swap recovery mid-timeline
    "wdm16-hotswap": (
        "wdm16-g200",
        dict(n_steps=8, thermal=0.3,
             events=((3, "lane_kill", 5), (6, "lane_swap", 5))),
    ),
    "wdm32-thermal": ("wdm32-g200", dict(n_steps=6, thermal=0.6)),
    "wdm32-hotswap": (
        "wdm32-g200",
        dict(n_steps=6, comb=(0.3, 6.0),
             events=((2, "lane_kill", 11), (4, "lane_swap", 11))),
    ),
}


def drift_timeline(name: str, device=None):
    """Resolve a ``DRIFT_SCENARIOS`` entry -> (cfg, Timeline) with drift
    multipliers scaled by the config's grid spacing [nm]; the timeline lies
    on CUDA unless ``device`` names another."""
    from repro_torch.core.temporal import make_timeline  # local: avoid an import cycle

    cfg_key, spec = DRIFT_SCENARIOS[name]
    cfg = WDM_CONFIGS[cfg_key]
    sp = cfg.grid.grid_spacing
    kw = dict(spec)
    n_steps = kw.pop("n_steps")
    for key in ("thermal", "aging"):
        if key in kw:
            kw[key] = kw[key] * sp
    if "comb" in kw:
        amp, period = kw["comb"]
        kw["comb"] = (amp * sp, period)
    return cfg, make_timeline(n_steps, len(cfg.s), device=device, **kw)

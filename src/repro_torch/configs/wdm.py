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

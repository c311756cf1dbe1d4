"""``device.idle_pct``: the share of the traced window in which no
operation ran on the card (one minus the union of the device operations'
intervals over the window), in percent."""


def read(data):
    if data.window_s <= 0:
        return None
    return 100.0 * (1.0 - data.busy_s / data.window_s)

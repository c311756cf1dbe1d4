"""``bottleneck_roofline``: the ``bottleneck`` kernel's share of its roofline, in percent
(``costs.roofline_pct``: the bound from each launch's shapes over the
kernel's device time per launch in the traced window)."""
import costs


def read(data):
    return costs.roofline_pct(data, "bottleneck")

"""``protocol.probe_launches_per_grid``: the protocol engine's masked
re-searches a grid, from the port's counter
``kernels.probe.masked_research.launches`` over the traced window."""


def read(data):
    launches = data.counters.get("kernels.probe.masked_research.launches")
    if not launches or data.grids == 0:
        return None
    return launches / data.grids

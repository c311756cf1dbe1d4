"""``device.launches_per_grid``: kernels the card ran in the traced window
(copies and fills left out) over the grids completed in it."""


def read(data):
    if data.grids == 0:
        return None
    return data.kernel_launches / data.grids

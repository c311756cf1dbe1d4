"""``sweep.chunks_per_grid``: the chunks the sweep engine split each grid
into under its memory budget, from the plans it notes (``sweep.plan``) to
the port's phase recorder in the traced window."""


def read(data):
    plans = [n for n in data.notes if n.get("name") == "sweep.plan"]
    if not plans or data.grids == 0:
        return None
    return sum(int(n["n_chunks"]) for n in plans) / data.grids

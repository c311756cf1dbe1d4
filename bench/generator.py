"""The one traffic generator: reads a mix's parameters and makes its grids.

A traffic file (``bench/traffic/<name>.json``) names the requests a caller
sends in turn (a scheme or a policy, with a spectral order), the grid's axes
in units of the configuration's grid spacing, how many unit sets the seed
draws, and how many of the window's answers the check compares.  Every seed
gives the same grids, sizes and request order; only the Monte-Carlo units
differ.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import NamedTuple

import numpy as np

from reference import prng


class Request(NamedTuple):
    kind: str          # "scheme" or "policy"
    target: str        # scheme or policy name
    order: str         # "natural" or "permuted"
    axes: dict         # axis name -> float32 values, in the file's order

    @property
    def label(self) -> str:
        return f"{self.target}/{self.order}"

    @property
    def shape(self) -> tuple:
        return tuple(len(v) for v in self.axes.values())

    @property
    def points(self) -> int:
        return int(np.prod(self.shape))


class Traffic(NamedTuple):
    requests: list     # Request, in the order the caller sends them
    unit_sets: list    # per set: (u_go, u_llv, u_rlv, u_fsr, u_tr) float32 arrays
    trials: int        # trials a grid point
    check: dict        # {"grids_per_request": k, "points_per_grid": m}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def axis_values(spec: dict, n_ch: int, spacing: float) -> np.ndarray:
    """float32 axis values from a spec in grid spacings: ``times_spacing``
    (a list) or ``linspace_times_spacing`` ([start, stop, num], stop a number
    or "n_ch"), computed as the paper's benchmark scripts compute them."""
    if "times_spacing" in spec:
        return np.array(spec["times_spacing"], dtype=np.float32) * spacing
    if "linspace_times_spacing" in spec:
        start, stop, num = spec["linspace_times_spacing"]
        stop = n_ch if stop == "n_ch" else stop
        return np.linspace(start * spacing, stop * spacing, int(num)).astype(np.float32)
    raise ValueError(f"unknown axis spec {spec!r}")


def build(traffic: dict, config: dict, seed: int, *, n_laser: int | None = None,
          n_ring: int | None = None) -> Traffic:
    """The mix's grids for this seed.  ``n_laser`` / ``n_ring`` shrink the
    units for tests; runs take the configuration's."""
    n_ch, spacing = int(config["n_ch"]), float(config["grid_spacing_nm"])
    n_l = int(n_laser or config["n_laser"])
    n_r = int(n_ring or config["n_ring"])
    axes = {name: axis_values(spec, n_ch, spacing) for name, spec in traffic["axes"].items()}
    requests = []
    for req in traffic["requests"]:
        kind = "scheme" if "scheme" in req else "policy"
        requests.append(Request(kind, req[kind], req.get("order", "natural"), axes))
    units = prng.unit_sets(seed, int(traffic["unit_sets"]), n_ch, n_l, n_r)
    return Traffic(requests, units, n_l * n_r, dict(traffic["check"]))


def schedule(traffic: Traffic, i: int) -> tuple[int, int]:
    """The i-th grid of the window: (request index, unit-set index).  The
    requests turn fastest, so each unit set meets every request."""
    n_req = len(traffic.requests)
    return i % n_req, (i // n_req) % len(traffic.unit_sets)

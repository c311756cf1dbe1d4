"""The yardstick of the kernel rooflines: the card's peaks, and each kernel's
bytes and operations for one launch, from the launch's shapes.

Frozen copies of the cost functions the port's bring-up measured its kernels
with (``chip_smoke.py``: ``feasibility_cost``, ``table_cost``,
``bottleneck_cost``).  The ``probe`` and ``match`` kernels have none here:
what they read depends on the data at each launch, which the launch's
arguments do not hold.

A launch's bound is max(bytes / peak bytes/s, operations / peak float32
operations/s): no kernel runs faster, so a share of it cannot pass 100 %.
"""
from __future__ import annotations

#: NVIDIA H100 SXM data sheet: HBM3 bandwidth, float32 rate outside the
#: tensor cores (at the full 700 W power limit).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_PER_S = 67e12


def feasibility_cost(t: int, n: int) -> tuple[float, float]:
    """Bytes: 4 (T, N) float32 inputs and s read, 2 (T,) outputs written.
    Operations: sub, remainder, divide and max per residual; min per shift."""
    return 4 * t * n * 4 + n * 4 + 2 * t * 4, 4 * t * n * n + t * n


def table_cost(t: int, n: int, e: int, n_j: int, vis_bytes: int = 0) -> tuple[float, float]:
    """Bytes: 4 (T, N) float32 inputs (+ mask) read; delta, wl (T, N, E) and
    n_valid (T, N) written.  Operations: laser - ring per (ring, line), then
    j * fsr, a subtraction and two window compares per candidate."""
    return (4 * t * n * 4 + vis_bytes + t * n * e * 8 + t * n * 4,
            t * n * n + 4 * t * n * n * n_j)


def bottleneck_cost(t: int, n: int) -> tuple[float, float]:
    """Bytes: (T, N, N) float32 weights read, (T,) written.  Operations: the
    first selection of each ring, N compares, N rings; the search's further
    steps depend on the data and are not counted."""
    return t * n * n * 4 + t * 4, t * n * n


def bound_ms(n_bytes: float, n_ops: float) -> float:
    return max(n_bytes / PEAK_BYTES_PER_S, n_ops / PEAK_F32_PER_S) * 1e3


def launch_bound_ms(kernel: str, args: tuple) -> float | None:
    """The bound of one launch from its C entry point's arguments (the
    ``*_launch`` functions of the port's kernel library), or None where the
    arguments do not read as that entry point's shapes."""
    try:
        if kernel == "feasibility":
            return bound_ms(*feasibility_cost(int(args[5]), int(args[6])))
        if kernel == "table_build":
            t, n, max_alias, e = (int(a) for a in args[7:11])
            vis = 0 if args[4] is None else (t * n * n if args[6] else t * n)
            return bound_ms(*table_cost(t, n, e, 2 * max_alias + 1, vis))
        if kernel == "bottleneck":
            return bound_ms(*bottleneck_cost(int(args[1]), int(args[2])))
    except (IndexError, TypeError, ValueError):
        return None
    return None


def roofline_pct(data, kernel: str) -> float | None:
    """A kernel's share of its roofline over a traced window: its mean bound
    per launch (from the launches' shapes) over its mean device time per
    launch (from the profiler, by the kernel's name), in percent.  None
    where the window launched it not at all or a launch's shapes do not
    read."""
    logged = data.launches.get(kernel) or []
    bounds = [launch_bound_ms(kernel, args) for args in logged]
    device_s, count = data.kernel_time(f"{kernel}_kernel")
    if not bounds or None in bounds or count == 0 or device_s <= 0:
        return None
    return 100.0 * (sum(bounds) / len(bounds)) / (device_s * 1e3 / count)

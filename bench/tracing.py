"""What a ``--trace 1`` run records, and the reduction of it that the
per-layer metric readers (``bench/metrics/<name>.py``) read.

Around the traced window the harness installs, from its own files only:

* ``torch.profiler`` with CPU and CUDA activities: every device operation
  with its interval, and the host's operations beside them;
* the port's phase recorder (``repro_torch.obs.phase.use_recorder``), so the
  sweep notes its chunk plan (``sweep.plan``);
* a log of the arguments of every launch of the kernels in ``ENTRY_POINTS``,
  taken at the port's C entry points (``kernels._build.library()``);
* the port's launch counters (``<wrapper>.launches``), read before and after.
"""
from __future__ import annotations

import contextlib
import importlib
import sys
import time
from dataclasses import dataclass

#: The port's kernel launch entry points whose shapes bound a launch
#: (``costs.launch_bound_ms``): kernel -> C function name.
ENTRY_POINTS = {
    "feasibility": "feasibility_launch",
    "table_build": "table_build_launch",
    "bottleneck": "bottleneck_launch",
}

#: The port's launch counters: name -> (module, wrapper function).
COUNTERS = {
    "kernels.feasibility.feasibility.launches": ("repro_torch.kernels.feasibility", "feasibility"),
    "kernels.table_build.build_tables.launches": ("repro_torch.kernels.table_build", "build_tables"),
    "kernels.bitmask_match.perfect_matching.launches": ("repro_torch.kernels.bitmask_match",
                                                        "perfect_matching"),
    "kernels.bitmask_match.bottleneck_threshold.launches": ("repro_torch.kernels.bitmask_match",
                                                            "bottleneck_threshold"),
    "kernels.probe.masked_research.launches": ("repro_torch.kernels.probe", "masked_research"),
}

WINDOW = "bench.window"
GRID = "bench.grid"
TO_HOST = "bench.to_host"
SPANS = (WINDOW, GRID, TO_HOST)

#: The longest traced window: the profiler's cost of keeping and reading a
#: window's events grows with its length, and a traced run must end within
#: its time limit.
TRACE_SECONDS = 10.0


def read_counters() -> dict:
    return {name: int(getattr(importlib.import_module(module), fn).launches)
            for name, (module, fn) in COUNTERS.items()}


@dataclass
class TraceData:
    """One traced window, reduced.  Times in seconds."""

    grids: int                       # grids completed in the window
    window_s: float                  # the traced window's length
    busy_s: float                    # union of device-operation intervals in it
    device_ops: list                 # (name, seconds, count) of each device op name
    idle_gaps: list                  # (host context, seconds, count) of idle gaps
    device_events: int               # device operations in the window
    kernel_launches: int             # of them kernels (not copies or fills)
    notes: list                      # the phase recorder's notes
    launches: dict                   # kernel -> list of launch argument tuples
    counters: dict                   # counter -> increase over the window

    def kernel_time(self, fragment: str) -> tuple[float, int]:
        """(device seconds, launches) of the device ops whose name holds ``fragment``."""
        secs = sum(s for name, s, _ in self.device_ops if fragment in name)
        count = sum(c for name, _, c in self.device_ops if fragment in name)
        return secs, count


class LaunchLog:
    """Records each launch's arguments at the ``ENTRY_POINTS``."""

    def __init__(self):
        self.launches: dict = {k: [] for k in ENTRY_POINTS}
        self._lib = None
        self._orig: dict = {}

    def __enter__(self):
        from repro_torch.kernels import _build

        self._lib = _build.library()
        for kernel, fn_name in ENTRY_POINTS.items():
            orig = getattr(self._lib, fn_name)
            self._orig[fn_name] = orig
            log = self.launches[kernel]

            def wrapper(*args, _orig=orig, _log=log):
                _log.append(args)
                return _orig(*args)
            setattr(self._lib, fn_name, wrapper)
        return self

    def __exit__(self, *exc):
        for fn_name, orig in self._orig.items():
            setattr(self._lib, fn_name, orig)
        return False


@contextlib.contextmanager
def traced_window(cuda: bool):
    """Profiler, phase recorder, launch log and counters around the window;
    yields a dict that holds them, filled in as the window closes.  Launches
    are logged on the card only: the plain versions on the CPU launch none."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.obs.phase import PhaseRecorder, use_recorder

    state: dict = {"counters_before": read_counters()}
    rec = PhaseRecorder()
    log = LaunchLog()
    with log if cuda else contextlib.nullcontext(), use_recorder(rec):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            yield state
            if cuda:
                torch.cuda.synchronize()
            t_stop = time.perf_counter()
        print(f"bench: profiler stopped in {time.perf_counter() - t_stop:.1f} s",
              file=sys.stderr)
    after = read_counters()
    state.update(prof=prof, notes=list(rec.notes), launches=log.launches,
                 counters={k: after[k] - v for k, v in state["counters_before"].items()})


def _merge(intervals: list) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def _host_context(cpu: list, points: list) -> list:
    """For each time in ``points`` (ascending), the name of the innermost host
    operation of the window's thread open at that time.  ``cpu`` holds
    (start, end, name) sorted by start, properly nested."""
    labels, stack, i = [], [], 0
    for p in points:
        while i < len(cpu) and cpu[i][0] <= p:
            while stack and stack[-1][1] <= cpu[i][0]:
                stack.pop()
            stack.append(cpu[i])
            i += 1
        while stack and stack[-1][1] <= p:
            stack.pop()
        labels.append(stack[-1][2] if stack else "none")
    return labels


def reduce(state: dict, grids: int) -> TraceData:
    """The traced window's device busy time, top device ops and idle gaps."""
    from torch.autograd import DeviceType

    t0 = time.perf_counter()
    events = state["prof"].profiler.kineto_results.events()
    t1 = time.perf_counter()
    window = [e for e in events if e.name() == WINDOW]
    if not window:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    w0, w1 = window[0].start_ns(), window[0].end_ns()
    thread = window[0].start_thread_id()
    dev, cpu = [], []
    ops: dict = {}
    for e in events:
        s, d = e.start_ns(), e.duration_ns()
        if e.device_type() == DeviceType.CUDA:
            # The harness's spans are mirrored on the device's timeline as
            # annotations of the same names; they are not device work.
            if s + d <= w0 or s >= w1 or e.name() in SPANS:
                continue
            dev.append((max(s, w0), min(s + d, w1)))
            slot = ops.setdefault(e.name(), [0, 0])
            slot[0] += d
            slot[1] += 1
        elif e.start_thread_id() == thread and w0 <= s < w1:
            cpu.append((s, s + d, e.name()))
    print(f"bench: trace of {len(events)} events read in {t1 - t0:.1f} s, "
          f"reduced in {time.perf_counter() - t1:.1f} s", file=sys.stderr)
    busy = _merge(dev)
    busy_ns = sum(e - s for s, e in busy)
    gaps = [(a[1], b[0]) for a, b in zip([[w0, w0]] + busy, busy + [[w1, w1]]) if b[0] > a[1]]
    cpu.sort(key=lambda x: (x[0], -x[1]))   # a parent before the children it opens
    labels = _host_context(cpu, [(s + e) // 2 for s, e in gaps])
    by_label: dict = {}
    for (s, e), label in zip(gaps, labels):
        slot = by_label.setdefault(label, [0, 0])
        slot[0] += e - s
        slot[1] += 1
    return TraceData(
        grids=grids, window_s=(w1 - w0) / 1e9, busy_s=busy_ns / 1e9,
        device_ops=sorted(((n, v[0] / 1e9, v[1]) for n, v in ops.items()),
                          key=lambda x: -x[1]),
        idle_gaps=sorted(((n, v[0] / 1e9, v[1]) for n, v in by_label.items()),
                         key=lambda x: -x[1]),
        device_events=len(dev),
        kernel_launches=sum(c for n, (_, c) in ops.items()
                            if not n.startswith(("Memcpy", "Memset"))),
        notes=state["notes"], launches=state["launches"],
        counters=state["counters"])


def breakdown(data: TraceData, top: int = 10) -> dict:
    """The result line's ``breakdown``: the device ops that took most time and
    the idle gaps by what the host was doing, at most ``top`` each."""
    short = lambda name: name if len(name) <= 160 else name[:157] + "..."  # noqa: E731
    return {"device_ops": [[short(n), s] for n, s, _ in data.device_ops[:top]],
            "idle_gaps": [[short(n), s] for n, s, _ in data.idle_gaps[:top]]}


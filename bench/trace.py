"""The traced run: ``torch.profiler`` recording the card's activity
(CUPTI) over a window the path chooses, read back from its Chrome trace
into plain lists.

Only the device's activity is recorded: recording the host's operators
as well costs microseconds an operator and, on paths that launch
thousands of kernels a round, makes idle time that an untraced run does
not have. The window runs from a synchronized start to a synchronized
stop on the host's clock, so every device operation of the window lies
inside it. Busy time is the union of the device's intervals, so kernels
that overlap count once.
"""
from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@dataclass
class TraceData:
    """One traced window: its length, the device's operations inside it
    (microseconds of the trace's clock), the program's kernel launch
    counters over it, the timed steps it holds, the host-clock seconds
    of as many steps run just before it without the profiler
    (``plain_s``), and what the path adds (``extras``)."""
    cell: object
    window_s: float
    plain_s: float = 0.0
    kernels: list = field(default_factory=list)    # (name, start, dur)
    device: list = field(default_factory=list)     # (start, end)
    launches: dict = field(default_factory=dict)   # counter deltas
    steps: int = 0
    extras: dict = field(default_factory=dict)

    @property
    def busy_s(self) -> float:
        """Seconds in which some device operation ran."""
        return sum(b - a for a, b in union(self.device)) * 1e-6

    def kernel_times(self, *patterns) -> list:
        """Durations (s) of the kernels whose name holds any pattern."""
        return [d * 1e-6 for n, _, d in self.kernels
                if any(p in n for p in patterns)]


def union(intervals) -> list:
    """Sorted, disjoint (start, end) pairs covering ``intervals``."""
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [tuple(x) for x in out]


def gaps(t: TraceData) -> list:
    """(start, end) of the stretches between device operations."""
    u = union(t.device)
    return [(a[1], b[0]) for a, b in zip(u, u[1:])]


def breakdown(t: TraceData, top: int = 10) -> dict:
    """{"device_ops": the kernels that took most device time, summed by
    name; "idle_gaps": the window's idle time summed by the device
    operation each gap waited for ("before <kernel>"), and the idle time
    at the window's two ends}, each [[name, seconds], ...] of at most
    ``top``."""
    ops = {}
    for n, _, d in t.kernels:
        ops[n[:120]] = ops.get(n[:120], 0.0) + d * 1e-6
    starts = {}
    for n, s, _ in t.kernels:
        starts.setdefault(s, n)
    idle, inner = {}, 0.0
    for a, b in gaps(t):
        k = "before " + starts.get(b, "a copy")[:100]
        idle[k] = idle.get(k, 0.0) + (b - a) * 1e-6
        inner += (b - a) * 1e-6
    edges = t.window_s - t.busy_s - inner
    if edges > 0:
        idle["the window's ends (host work before the first and after "
             "the last device operation)"] = edges
    rank = lambda d: sorted(([k, v] for k, v in d.items()),  # noqa: E731
                            key=lambda kv: -kv[1])[:top]
    return {"device_ops": rank(ops), "idle_gaps": rank(idle)}


def idle_share(t: TraceData):
    """Percent of the steps' time in which no device operation ran: the
    traced steps' busy seconds over the host-clock seconds of as many
    steps without the profiler (which slows the host's launches)."""
    if t.plain_s <= 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.plain_s)


def roofline_share(t: TraceData, bound_s: float, patterns, launches: str,
                   calls: int):
    """Percent of the least time over the time the kernels took:
    ``bound_s`` of all ``calls`` calls over the summed device time of
    the kernels whose names hold ``patterns``. None where the trace
    holds none of them, or where the program's launch counter
    (``launches``) disagrees with ``calls``."""
    import sys

    times = t.kernel_times(*patterns)
    if not times:
        return None
    got = t.launches.get(launches, 0)
    if got != calls:
        print(f"bench: {launches} counted {got} launches, expected {calls}",
              file=sys.stderr)
        return None
    return 100.0 * bound_s / sum(times)


def read_chrome(path, cell, window_s: float) -> TraceData:
    """A :class:`TraceData` of the device operations of an exported
    Chrome trace."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    t = TraceData(cell=cell, window_s=window_s)
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            s, d = float(e["ts"]), float(e["dur"])
            t.device.append((s, s + d))
            if e["cat"] == "kernel":
                t.kernels.append((e["name"], s, d))
    return t


class Tracer:
    """Times the plain steps (:meth:`plain`, then :meth:`start`), then
    starts and stops ``torch.profiler`` around the traced window (the
    device synchronized at each end) and reads the result into
    :attr:`data`."""

    def __init__(self, cell, out_dir):
        self.cell, self.out_dir = cell, Path(out_dir)
        self.data = None
        self._prof = None
        self._t0 = self._plain0 = 0.0
        self._plain_s = 0.0
        self._launches = {}

    @staticmethod
    def _sync():
        import torch
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def plain(self):
        """Start timing the untraced steps that precede the window."""
        self._sync()
        self._plain0 = time.perf_counter()

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile
        from repro_torch.kernels.interface import LAUNCHES

        cuda = torch.cuda.is_available()
        self._sync()
        self._plain_s = time.perf_counter() - self._plain0
        self._launches = dict(LAUNCHES)
        self._prof = profile(activities=[ProfilerActivity.CUDA if cuda
                                         else ProfilerActivity.CPU])
        self._prof.start()
        self._t0 = time.perf_counter()

    def stop(self):
        import torch
        from repro_torch.kernels.interface import LAUNCHES

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        window_s = time.perf_counter() - self._t0
        self._prof.stop()
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / f"trace-{os.getpid()}.json"
        self._prof.export_chrome_trace(str(path))
        self._prof = None
        try:
            self.data = read_chrome(path, self.cell, window_s)
        finally:
            path.unlink(missing_ok=True)
        self.data.plain_s = self._plain_s
        self.data.launches = {k: v - self._launches.get(k, 0)
                              for k, v in LAUNCHES.items()
                              if v - self._launches.get(k, 0)}

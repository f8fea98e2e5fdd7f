"""Device time by the program's spans.

:class:`SpanTracer` is :class:`bench.trace.Tracer` with the program's
spans (``repro_torch.obs.spans``: ``tier_round``, ``local_step``,
``forward``, ``backward``, ``prox_step``, ...): a span log of its own is
active over the traced window alone, after the untimed steps that
:meth:`~bench.trace.Tracer.plain` times, and the window's launch events
are kept. The program stamps its spans on the host clock of
``torch.profiler``'s exported trace, so spans and launches land on one
clock (:class:`Window`). ``bench/run.py`` traces with the plain
``Tracer`` and records no span; ``scripts/tier_spans.py`` traces a cell
with this one.

Each device operation belongs to the innermost span that was open on
the host when the host launched it: its ``args.correlation`` names the
launch, a ``cuda_runtime`` or ``cuda_driver`` event, and the launch's
start is looked up among the spans. Attribution goes by time, not by
thread: autograd launches the backward's kernels from a thread of its
own while the caller waits inside ``backward``. An operation without a
launch event, or launched while no span was open, belongs to none.
"""
from __future__ import annotations

import bisect
import contextlib
import gc
import json
import os
import time
from dataclasses import dataclass, field

from bench.trace import DEVICE_CATS, Tracer, gaps, read_chrome

# the host's calls that launch device work
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
# kernel families by name, the first match deciding
FAMILIES = (("gemm", ("nvjet", "gemm", "xmma", "cutlass")),
            ("attention", ("attn_wgmma", "delta_kernel", "dq_kernel",
                           "dkv_kernel")),
            ("prox", ("prox_kernel",)),
            ("copy", ("Memcpy", "Memset", "direct_copy", "copy_")),
            ("reduce", ("reduce_kernel",)),
            ("elementwise", ("elementwise_kernel",)))
# what :attr:`SpanTracer.host` counts over a window: the process's CPU
# seconds, the garbage collector's full collections, and the caching
# allocator's retries (each frees its cached blocks, which waits for the
# card) and its cudaMalloc and cudaFree calls
HOST = ("cpu_s", "gc_full", "num_alloc_retries", "num_device_alloc",
        "num_device_free")


@dataclass
class Window:
    """A traced window in microseconds of the trace's clock: the device
    operations (name, start, duration, correlation id), the host's
    start of each correlation id's launch, and the program's closed
    spans (path, start, end, attributes); a path names the span and
    its parents (``tier_round/local_step/backward``)."""
    ops: list = field(default_factory=list)
    launched: dict = field(default_factory=dict)
    spans: list = field(default_factory=list)


def read(trace: dict, log=None) -> Window:
    """The :class:`Window` of an exported Chrome trace, with the closed
    spans of ``log`` (a ``repro_torch.obs.spans.SpanLog``) moved onto
    the trace's clock."""
    w = Window()
    for e in trace["traceEvents"]:
        if e.get("ph") != "X":
            continue
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") in DEVICE_CATS:
            w.ops.append((e["name"], float(e["ts"]), float(e["dur"]), corr))
        elif e.get("cat") in LAUNCH_CATS and corr is not None:
            w.launched[corr] = float(e["ts"])
    if log is not None:
        # microseconds from the trace's base to the log's epoch
        shift = (log.epoch_ns - int(trace.get("baseTimeNanoseconds", 0))) \
            * 1e-3
        w.spans = [(sp.path, shift + sp.t0 * 1e6,
                    shift + (sp.t0 + sp.dur) * 1e6, dict(sp.attrs))
                   for sp in log.spans if sp.dur is not None]
    return w


class SpanTracer(Tracer):
    """:class:`bench.trace.Tracer` that also keeps the window's launches
    and, unless ``log`` is false, records the program's spans over the
    window into a log of its own; :attr:`window` holds both after
    :meth:`stop`, and :attr:`host` what the host did over the window
    (:data:`HOST`). Use it as a context around the path's ``traced``:
    leaving the context closes the log and stops the profiler where the
    path raised inside the window."""

    def __init__(self, cell, out_dir, log: bool = True):
        from repro_torch.obs.spans import SpanLog

        super().__init__(cell, out_dir)
        self.log = SpanLog() if log else None
        self.window = None
        self.host = {}
        self._host0 = {}
        self._active = contextlib.ExitStack()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        self._active.close()
        if self._prof is not None:
            self._prof.stop()
            self._prof = None
        return False

    def start(self):
        super().start()
        self._host0 = host_counts()
        if self.log is not None:
            self._active.enter_context(self.log.activate())

    def stop(self):
        from repro_torch.kernels.interface import LAUNCHES

        self._sync()
        window_s = time.perf_counter() - self._t0
        self.host = {k: v - self._host0[k] for k, v in host_counts().items()}
        self._active.close()
        prof, self._prof = self._prof, None
        prof.stop()
        self.out_dir.mkdir(parents=True, exist_ok=True)
        path = self.out_dir / f"trace-{os.getpid()}.json"
        prof.export_chrome_trace(str(path))
        try:
            self.data = read_chrome(path, self.cell, window_s)
            self.window = read(json.loads(path.read_text()), self.log)
        finally:
            path.unlink(missing_ok=True)
        self.data.plain_s = self._plain_s
        self.data.launches = {k: v - self._launches.get(k, 0)
                              for k, v in LAUNCHES.items()
                              if v - self._launches.get(k, 0)}


def host_counts() -> dict:
    """What the host has done so far (:data:`HOST`)."""
    import torch

    mem = torch.cuda.memory_stats() if torch.cuda.is_available() else {}
    return {"cpu_s": time.process_time(),
            "gc_full": gc.get_stats()[2]["collections"],
            **{k: mem.get(k, 0) for k in HOST[2:]}}


def span_at(spans: list):
    """A function of a time giving the innermost span of ``spans`` open
    at that time (start <= time < end), or None. Spans nest, so of those
    open the innermost started last (the deeper one where two started
    together)."""
    marks = sorted({s for _, s, _, _ in spans} | {e for _, _, e, _ in spans})
    owner = []
    for m in marks:
        open_ = [sp for sp in spans if sp[1] <= m < sp[2]]
        owner.append(max(open_, key=lambda sp: (sp[1], sp[0].count("/")))
                     if open_ else None)

    def at(when):
        i = bisect.bisect_right(marks, when) - 1
        return owner[i] if i >= 0 else None
    return at


def attribute(w: Window) -> list:
    """(operation, its span or None) for each device operation of
    ``w``, by its launch's host time."""
    at = span_at(w.spans)
    out = []
    for op in w.ops:
        host = w.launched.get(op[3])
        out.append((op, None if host is None else at(host)))
    return out


def coverage(w: Window):
    """Percent of the window's device time (operations' durations
    summed) that belongs to a span; None without device operations."""
    total = sum(op[2] for op in w.ops)
    if total <= 0:
        return None
    return 100.0 * sum(op[2] for op, sp in attribute(w)
                       if sp is not None) / total


def under(path: str, names) -> bool:
    """Whether a span path passes through a span named in ``names``."""
    return not set(path.split("/")).isdisjoint(names)


def device_seconds(w: Window, *names) -> float:
    """Seconds of device time of the operations whose span is, or lies
    inside, a span named in ``names``."""
    return 1e-6 * sum(op[2] for op, sp in attribute(w)
                      if sp is not None and under(sp[0], names))


def rounds(w: Window) -> list:
    """The window's ``tier_round`` spans."""
    return [sp for sp in w.spans if sp[0] == "tier_round"]


def idle_by_span(t, w: Window) -> dict:
    """Seconds of the window's idle gaps between device operations
    (:func:`bench.trace.gaps` of the :class:`bench.trace.TraceData`
    ``t``), summed by the path of the innermost span open on the host
    when each gap began (None where no span was open)."""
    at, out = span_at(w.spans), {}
    for a, b in gaps(t):
        sp = at(a)
        k = sp and sp[0]
        out[k] = out.get(k, 0.0) + (b - a) * 1e-6
    return out


def family(name: str) -> str:
    """The kernel family (:data:`FAMILIES`) of a device operation's
    name, or ``"other"``."""
    for fam, keys in FAMILIES:
        if any(k in name for k in keys):
            return fam
    return "other"

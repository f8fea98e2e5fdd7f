"""Nestable host-side spans with Chrome-trace-event export.

The run-event log (`repro_torch.obs.events`) answers *what happened* at
each eval point; spans answer *where the wall-clock went*. A `SpanLog`
is a per-run collector of named, nested host-side intervals -- build,
the first round ("compile": kernel build and load, cuBLAS warm-up), the
later rounds ("dispatch"), eval on the training side; store export, save
and load and replay batches on the serving side -- written out as Chrome
trace-event JSON that loads into Perfetto or ``chrome://tracing``.

Instrumented library code never creates a log itself: it calls the
module-level :func:`span` context manager, which records into whichever
`SpanLog` is *active* (a contextvar set by :meth:`SpanLog.activate`) and
is a null context when none is. The outermost caller --
``run_experiment(trace_dir=...)``, ``run_scenario``, the scenarios CLI's
``serve --trace-dir`` -- owns the log: it activates one around the whole
operation, so nested layers (scenario build -> engine rounds -> store
export -> replay batches) all land in a single trace, and saves it next
to the JSONL event log. ``python -m repro_torch.obs report DIR`` joins
the result with events, metrics and health.

Spans carry free-form attributes (``span("compile", round=1)``) and the
yielded `Span` accepts late ones via :meth:`Span.set` -- the engine
stamps the first round's FLOP count onto its compile span. Each span
knows its parent, and the export names the parent's path
(``tier_round/local_step``) in the event's ``args``. A span times the
host: where it must time the card, the code inside it ends in a copy
to the host or a synchronize.

Spans are stamped with ``time.time_ns()``, the realtime clock that
``torch.profiler``'s exported trace uses on the host (an event at
``baseTimeNanoseconds`` + ``ts`` microseconds), so a span's bounds and
the launches a profiler recorded inside it compare directly. The export
gives its own ``baseTimeNanoseconds`` (``ts`` counts microseconds from
it, the log's start) and names the clock in ``otherData``.
"""
from __future__ import annotations

import contextlib
import contextvars
import json
import os
import pathlib
import time
from dataclasses import dataclass, field
from typing import Optional

__all__ = ["Span", "SpanLog", "current_log", "owned_log", "span"]

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_span_log", default=None)
# the clock every span is stamped on (module docstring)
CLOCK = "time.time_ns (CLOCK_REALTIME, torch.profiler's host clock)"


@dataclass
class Span:
    """One named host-side interval: begin/duration (seconds, relative to
    the owning log's epoch), nesting depth, free-form attributes, and the
    span it opened inside (None at the top)."""
    name: str
    t0: float                       # start, seconds since log epoch
    depth: int = 0                  # nesting level at begin time
    dur: Optional[float] = None     # seconds; None while still open
    attrs: dict = field(default_factory=dict)
    parent: Optional["Span"] = field(default=None, repr=False,
                                     compare=False)

    def set(self, **attrs) -> "Span":
        """Attach (or overwrite) attributes; usable after the span closed
        -- attrs serialize at export time, so late annotations still land
        in the trace."""
        self.attrs.update(attrs)
        return self

    @property
    def path(self) -> str:
        """The names from the outermost span down to this one, joined by
        ``/`` (``tier_round/local_step/backward``)."""
        names, sp = [], self
        while sp is not None:
            names.append(sp.name)
            sp = sp.parent
        return "/".join(reversed(names))


class _Recording:
    """The context :meth:`SpanLog.span` returns: opens its span on entry
    and closes it on exit (exceptions propagate)."""
    __slots__ = ("_log", "_name", "_attrs", "_span")

    def __init__(self, log, name, attrs):
        self._log, self._name, self._attrs = log, name, attrs

    def __enter__(self) -> Span:
        log = self._log
        parent = log._stack[-1] if log._stack else None
        sp = Span(name=self._name,
                  t0=(time.time_ns() - log.epoch_ns) * 1e-9,
                  depth=len(log._stack), attrs=self._attrs, parent=parent)
        log.spans.append(sp)
        log._stack.append(sp)
        self._span = sp
        return sp

    def __exit__(self, *exc) -> bool:
        sp = self._span
        sp.dur = (time.time_ns() - self._log.epoch_ns) * 1e-9 - sp.t0
        self._log._stack.pop()
        return False


class SpanLog:
    """Collector for one run's spans, exportable as Chrome trace events.

    Use :meth:`span` directly, or :meth:`activate` the log so library
    code's module-level :func:`span` calls feed it. Spans nest via a
    stack; the export encodes each as a complete ("X") trace event whose
    ``tid`` is the nesting depth, which Perfetto renders as a flame-like
    track per level.
    """

    def __init__(self, meta: Optional[dict] = None):
        """meta: free-form identity recorded in the exported trace's
        ``metadata`` section (run id, scenario name, ...)."""
        self.meta = dict(meta or {})
        self.spans: list = []
        self._stack: list = []
        # the log's start on the clock the spans are stamped on
        self.epoch_ns = time.time_ns()

    def __len__(self):
        return len(self.spans)

    def span(self, name: str, **attrs):
        """Record one nested interval; the context yields the open `Span`
        so callers can :meth:`Span.set` more attributes. Exceptions
        propagate after the span is closed, so aborted phases still show
        in the trace."""
        return _Recording(self, name, attrs)

    @contextlib.contextmanager
    def activate(self):
        """Make this the active log for the dynamic extent: every
        module-level :func:`span` call inside records here. One owner at
        a time -- activating while another log is active raises (nested
        layers contribute spans via :func:`span` instead of owning a
        second log)."""
        if _ACTIVE.get() is not None:
            raise RuntimeError(
                "a SpanLog is already active; nested layers should "
                "record via span(...) instead of activating their own")
        token = _ACTIVE.set(self)
        try:
            yield self
        finally:
            _ACTIVE.reset(token)

    def to_chrome(self) -> dict:
        """Chrome trace-event JSON object: ``{"traceEvents": [...],
        "baseTimeNanoseconds", "otherData": {"clock"}, "metadata": ...}``
        with one complete ("X") event per closed span (timestamps in
        microseconds from ``baseTimeNanoseconds``, durations in
        microseconds; ``args["parent"]``, the parent's path, where the
        span has a parent)."""
        pid = os.getpid()
        events = []
        for sp in self.spans:
            if sp.dur is None:          # still open
                continue
            args = {k: v for k, v in sp.attrs.items()
                    if isinstance(v, (str, int, float, bool, type(None)))}
            if sp.parent is not None:
                args["parent"] = sp.parent.path
            events.append({
                "name": sp.name, "cat": "repro", "ph": "X",
                "ts": sp.t0 * 1e6, "dur": sp.dur * 1e6,
                "pid": pid, "tid": sp.depth, "args": args,
            })
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "baseTimeNanoseconds": self.epoch_ns,
                "otherData": {"clock": CLOCK}, "metadata": self.meta}

    def save(self, trace_dir, tag: str = "run") -> pathlib.Path:
        """Write the Chrome-trace JSON to
        ``<trace_dir>/spans-<tag>-<pid>.trace.json`` and return the path
        (parent directories are created)."""
        safe = "".join(c if c.isalnum() or c in "-_." else "_"
                       for c in str(tag))
        path = pathlib.Path(trace_dir) / \
            f"spans-{safe}-{os.getpid()}.trace.json"
        path.parent.mkdir(parents=True, exist_ok=True)
        path.write_text(json.dumps(self.to_chrome(), sort_keys=True))
        return path

    def summary(self) -> dict:
        """Per-name aggregate over closed spans: ``{name: {count,
        total_ms, mean_ms}}``."""
        out: dict = {}
        for sp in self.spans:
            if sp.dur is None:
                continue
            agg = out.setdefault(sp.name, {"count": 0, "total_ms": 0.0})
            agg["count"] += 1
            agg["total_ms"] += sp.dur * 1e3
        for agg in out.values():
            agg["mean_ms"] = agg["total_ms"] / agg["count"]
        return out


class _NullSpan:
    """No-op stand-in :func:`span` returns when no log is active: its own
    context, yielding itself. One object serves every call."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs):
        """Discard attributes (no log to record them)."""
        return self


_NULL_SPAN = _NullSpan()


def current_log() -> Optional[SpanLog]:
    """The `SpanLog` activated for the current context, or None."""
    return _ACTIVE.get()


@contextlib.contextmanager
def owned_log(trace_dir, meta: dict, tag: str):
    """The ownership rule as a context: when ``trace_dir`` is set and no
    caller's log is active, a new `SpanLog` (``meta``) is activated over
    the body and saved into ``trace_dir`` under ``tag`` after it, also
    when the body raises; otherwise nothing (the spans land in the
    caller's log, or nowhere)."""
    if trace_dir is None or _ACTIVE.get() is not None:
        yield
        return
    log = SpanLog(meta=meta)
    with log.activate():
        try:
            yield
        finally:
            log.save(trace_dir, tag)


def span(name: str, **attrs):
    """Record a span into the active log, or do nothing when none is
    active: one contextvar read, and the one shared no-op context."""
    log = _ACTIVE.get()
    if log is None:
        return _NULL_SPAN
    return _Recording(log, name, attrs)

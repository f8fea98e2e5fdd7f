"""Per-layer metric readers, one file a metric, named by the metric:
each defines ``read(trace) -> float or None`` over a
:class:`bench.trace.TraceData` (None when it finds nothing to read)."""

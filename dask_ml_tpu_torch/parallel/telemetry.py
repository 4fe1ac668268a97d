"""Telemetry of the PyTorch port: hierarchical spans, a metrics registry,
trace export (the counterpart of ``dask_ml_tpu/parallel/telemetry.py``).

- **Spans** — :func:`span` is a context manager that records wall time,
  optional device-sync time (``sp.sync(tree)`` measures the wait for the
  card's stream) and the parent/child structure (a stack per thread)
  into one bounded ring for the process. Each recorded span is also a
  ``torch.profiler.record_function`` range, so a ``torch.profiler`` trace
  of a fit shows the phases by name.
- **Metrics** — thread-safe named counters, gauges and histograms with
  labels (:func:`counter` / :func:`gauge` / :func:`histogram`); a
  histogram keeps a sliding window of raw samples for its percentiles.
- **Export** — :func:`telemetry_report` (one nested dict, JSON round
  trip exact), :func:`render_report` (its text view) and
  :func:`export_chrome_trace` (Chrome trace events, for Perfetto).

Everything is behind the thread-local ``telemetry`` config knob: with it
off (the default) :func:`span` returns a shared null context manager and
the metric helpers a shared null metric, and nothing is recorded.

:func:`counters` reads every counter as ``{name: value}`` (labelled
ones rendered ``name{k=v}``), :func:`reset_counters` clears them and
:func:`render_counters` prints them: a search's
``shared_fit_report()`` appends that text.

The report's ``compile`` section is
:func:`~dask_ml_tpu_torch.parallel.shapes.compile_stats`: eager PyTorch
compiles nothing per shape, so there it counts ``nvcc`` builds and first
loads of the kernel libraries.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import threading
import time
from collections import deque
from typing import Any, Optional

from dask_ml_tpu_torch.config import get_config

__all__ = [
    "span",
    "Span",
    "enabled",
    "metrics",
    "counter",
    "gauge",
    "histogram",
    "counters",
    "reset_counters",
    "render_counters",
    "spans",
    "span_summary",
    "reset_telemetry",
    "telemetry_report",
    "render_report",
    "export_chrome_trace",
    "MetricsRegistry",
]

PROFILE_DIR_ENV = "DASK_ML_TPU_PROFILE_DIR"

#: trace epoch: span timestamps (and the Chrome trace ``ts`` axis) are
#: seconds since this module was imported
_T0 = time.perf_counter()

_DEFAULT_RING_CAPACITY = 8192


def enabled() -> bool:
    """Whether telemetry recording is on for this thread (the
    ``telemetry`` config knob)."""
    return bool(get_config()["telemetry"])


# ---------------------------------------------------------------------------
# metrics registry
# ---------------------------------------------------------------------------


class _NullMetric:
    """Shared no-op metric returned by the module helpers when the knob is
    off: the disabled path allocates nothing and takes no lock."""

    __slots__ = ()

    def inc(self, v=1) -> None:
        pass

    def set(self, v) -> None:
        pass

    def observe(self, v) -> None:
        pass


_NULL_METRIC = _NullMetric()


class Counter:
    """A named count (mirrors may subtract where the surface they shadow
    rolls back)."""

    __slots__ = ("_lock", "value")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.value = 0

    def inc(self, v=1) -> None:
        with self._lock:
            self.value += v


class Gauge:
    """Last value, with min, max and the number of samples."""

    __slots__ = ("_lock", "last", "min", "max", "n_samples")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.last = None
        self.min = None
        self.max = None
        self.n_samples = 0

    def set(self, v) -> None:
        v = float(v)
        with self._lock:
            self.last = v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.n_samples += 1


#: raw samples a histogram keeps: percentiles run over the most recent
#: this many observations (below the cap, over all of them)
HISTOGRAM_SAMPLE_CAP = 8192


class Histogram:
    """Count, sum, min, max, power-of-two buckets (``le_2^e`` holds
    observations in ``(2^(e-1), 2^e]``, nonpositive ones land in ``0``)
    and a window of the :data:`HISTOGRAM_SAMPLE_CAP` most recent raw
    samples, which :meth:`percentiles` reads."""

    __slots__ = ("_lock", "count", "total", "min", "max", "buckets",
                 "samples")

    def __init__(self, lock: threading.Lock):
        self._lock = lock
        self.count = 0
        self.total = 0.0
        self.min = None
        self.max = None
        self.buckets: dict = {}
        self.samples: deque = deque(maxlen=HISTOGRAM_SAMPLE_CAP)

    @staticmethod
    def bucket_of(v: float) -> str:
        if v <= 0:
            return "0"
        return f"le_2^{int(math.ceil(math.log2(v)))}"

    def observe(self, v) -> None:
        v = float(v)
        b = self.bucket_of(v)
        with self._lock:
            self.count += 1
            self.total += v
            self.min = v if self.min is None else min(self.min, v)
            self.max = v if self.max is None else max(self.max, v)
            self.buckets[b] = self.buckets.get(b, 0) + 1
            self.samples.append(v)

    def percentiles(self, q=(50, 90, 99)) -> dict:
        """``{"p50": ..., "p90": ..., "p99": ...}`` over the sample
        window, numpy's default linear interpolation (equal to
        ``np.percentile(samples, q)`` below the cap). An empty histogram
        gives ``None`` for each."""
        # copy under the lock, sort outside it: a sort of the whole window
        # must not stall the dispatch threads' writers
        with self._lock:
            data = list(self.samples)
        data.sort()
        out: dict = {}
        for qq in q:
            key = f"p{qq:g}"
            if not data:
                out[key] = None
                continue
            pos = (len(data) - 1) * (float(qq) / 100.0)
            lo = math.floor(pos)
            hi = math.ceil(pos)
            out[key] = data[lo] + (data[hi] - data[lo]) * (pos - lo)
        return out


class MetricsRegistry:
    """Thread-safe named counters, gauges and histograms with labels. A
    metric is identified by ``(name, sorted labels)``; the snapshot
    renders labelled ones ``name{k=v,...}``. One instance for the process
    (:func:`metrics`) backs the module helpers; tests may make their
    own."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counters: dict = {}
        self._gauges: dict = {}
        self._histograms: dict = {}

    @staticmethod
    def _key(name: str, labels: dict) -> tuple:
        return (str(name),
                tuple(sorted((str(k), str(v)) for k, v in labels.items())))

    def _get(self, table: dict, cls, name: str, labels: dict):
        key = self._key(name, labels)
        with self._lock:
            m = table.get(key)
            if m is None:
                m = table[key] = cls(self._lock)
        return m

    def counter(self, name: str, **labels) -> Counter:
        return self._get(self._counters, Counter, name, labels)

    def gauge(self, name: str, **labels) -> Gauge:
        return self._get(self._gauges, Gauge, name, labels)

    def histogram(self, name: str, **labels) -> Histogram:
        return self._get(self._histograms, Histogram, name, labels)

    @staticmethod
    def _render_key(key: tuple) -> str:
        name, labels = key
        if not labels:
            return name
        return name + "{" + ",".join(f"{k}={v}" for k, v in labels) + "}"

    def counter_values(self) -> dict:
        """``{rendered name: value}`` of every counter, sorted."""
        with self._lock:
            return {self._render_key(k): c.value
                    for k, c in sorted(self._counters.items())}

    def snapshot(self) -> dict:
        """Every metric as plain dicts, keyed by rendered name (JSON
        serializable)."""
        counters = self.counter_values()
        with self._lock:
            gauges = {
                self._render_key(k): {
                    "last": g.last, "min": g.min, "max": g.max,
                    "n_samples": g.n_samples,
                }
                for k, g in sorted(self._gauges.items())
            }
            hist_items = sorted(self._histograms.items())
        # each histogram's percentiles take the lock on their own, so a
        # large window never holds the whole snapshot's lock
        histograms = {}
        for k, h in hist_items:
            with self._lock:
                rec = {
                    "count": h.count,
                    "sum": h.total,
                    "min": h.min,
                    "max": h.max,
                    "mean": (h.total / h.count) if h.count else None,
                    "buckets": dict(h.buckets),
                    "n_samples_retained": len(h.samples),
                }
            rec.update(h.percentiles())
            histograms[self._render_key(k)] = rec
        return {"counters": counters, "gauges": gauges,
                "histograms": histograms}

    def reset_counters(self) -> None:
        with self._lock:
            self._counters.clear()

    def reset(self) -> None:
        with self._lock:
            self._counters.clear()
            self._gauges.clear()
            self._histograms.clear()


_registry = MetricsRegistry()


def metrics() -> MetricsRegistry:
    """The process-wide registry, without the enabled check: for sites
    that already made one :func:`enabled` call, and for reading."""
    return _registry


def counter(name: str, **labels):
    """The named counter, or the shared null metric when telemetry is
    off."""
    if not enabled():
        return _NULL_METRIC
    return _registry.counter(name, **labels)


def gauge(name: str, **labels):
    """The named gauge, or the shared null metric when telemetry is off."""
    if not enabled():
        return _NULL_METRIC
    return _registry.gauge(name, **labels)


def histogram(name: str, **labels):
    """The named histogram, or the shared null metric when telemetry is
    off."""
    if not enabled():
        return _NULL_METRIC
    return _registry.histogram(name, **labels)


def counters() -> dict:
    """``{name: value}`` of every counter recorded so far."""
    return _registry.counter_values()


def reset_counters() -> None:
    """Clear the counters (gauges, histograms and spans stay)."""
    _registry.reset_counters()


def render_counters() -> str:
    """The counters as text, one ``name value`` line each."""
    rows = counters()
    if not rows:
        return "telemetry counters: none recorded"
    width = max(len(k) for k in rows)
    return "\n".join(["telemetry counters:"]
                     + [f"  {k:<{width}}  {v}" for k, v in rows.items()])


# ---------------------------------------------------------------------------
# hierarchical spans
# ---------------------------------------------------------------------------


def _sync_tree(tree) -> None:
    """Wait for the current stream of every CUDA device a tensor of
    ``tree`` (a tensor, or lists / tuples / dicts of them) lies on."""
    import torch

    seen = set()
    stack = [tree]
    while stack:
        t = stack.pop()
        if isinstance(t, dict):
            stack.extend(t.values())
        elif isinstance(t, (list, tuple)):
            stack.extend(t)
        elif isinstance(t, torch.Tensor) and t.is_cuda \
                and t.device not in seen:
            seen.add(t.device)
            torch.cuda.current_stream(t.device).synchronize()


class Span:
    """One live span: :meth:`set` adds attributes, :meth:`sync` measures a
    wait for the card. Finished spans land in the ring as plain dicts
    (:func:`spans`)."""

    __slots__ = ("name", "attrs", "sid", "parent_id", "depth", "tid",
                 "thread_name", "ts", "dur", "sync_seconds")

    def __init__(self, name, attrs, sid, parent_id, depth, tid, thread_name):
        self.name = name
        self.attrs = attrs
        self.sid = sid
        self.parent_id = parent_id
        self.depth = depth
        self.tid = tid
        self.thread_name = thread_name
        self.ts = 0.0
        self.dur = 0.0
        self.sync_seconds = 0.0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def sync(self, tree):
        """Wait for the streams ``tree``'s CUDA tensors are queued on, the
        wait recorded as this span's ``sync_seconds`` (how much of the
        span the host spent waiting for the card). Returns ``tree``.

        For measurement only: on a disabled span it returns at once
        without waiting, so no call site may rely on it to order work."""
        t0 = time.perf_counter()
        _sync_tree(tree)
        self.sync_seconds += time.perf_counter() - t0
        return tree


class _NullSpan:
    """The span on the disabled path: ``set`` and ``sync`` do nothing
    (``sync`` does not wait — see :meth:`Span.sync`)."""

    __slots__ = ()

    def set(self, **attrs) -> None:
        pass

    def sync(self, tree):
        return tree


_NULL_SPAN = _NullSpan()


class _NullSpanCtx:
    """The shared context manager of the disabled path without a logger:
    one knob read and this singleton's empty enter and exit."""

    __slots__ = ()

    def __enter__(self):
        return _NULL_SPAN

    def __exit__(self, *exc):
        return False


_NULL_SPAN_CTX = _NullSpanCtx()

_lock = threading.Lock()
_ring: deque = deque(maxlen=_DEFAULT_RING_CAPACITY)
_dropped = 0
_next_id = 0
_tls = threading.local()


def _stack() -> list:
    s = getattr(_tls, "stack", None)
    if s is None:
        s = _tls.stack = []
    return s


def _alloc_id() -> int:
    global _next_id
    with _lock:
        _next_id += 1
        return _next_id


def _record(sp: Span) -> None:
    global _dropped
    rec = {
        "name": sp.name,
        "ts": sp.ts,
        "dur": sp.dur,
        "sync_seconds": sp.sync_seconds,
        "tid": sp.tid,
        "thread": sp.thread_name,
        "id": sp.sid,
        "parent": sp.parent_id,
        "depth": sp.depth,
        "attrs": dict(sp.attrs),
    }
    with _lock:
        if _ring.maxlen is not None and len(_ring) == _ring.maxlen:
            _dropped += 1
        _ring.append(rec)


def _range_label(name: str, attrs: dict) -> str:
    if not attrs:
        return name
    return name + "[" + ",".join(
        f"{k}={v}" for k, v in sorted(attrs.items())) + "]"


def span(name: str, *, logger=None, **attrs):
    """Hierarchical span around a phase, a block or a request.

    With the ``telemetry`` knob on it records the wall time, the parent
    span of this thread and ``**attrs`` into the ring, inside a
    ``torch.profiler.record_function`` range named ``name[k=v,...]``.
    With the knob off and no ``logger`` it is one config read and a
    shared null context manager.

    ``logger`` keeps the ``profile_phase`` contract whatever the knob:
    the phase always gets its profiler range and a DEBUG line of its wall
    time, and when ``DASK_ML_TPU_PROFILE_DIR`` is set the outermost such
    span of a thread runs a ``torch.profiler`` capture and writes it as a
    Chrome trace into that directory (logged at INFO).

    The yielded :class:`Span` takes ``sp.set(key=value)`` and
    ``sp.sync(tree)``."""
    if logger is None and not enabled():
        return _NULL_SPAN_CTX
    return _span_impl(name, logger, attrs)


@contextlib.contextmanager
def _span_impl(name: str, logger, attrs: dict):
    import torch

    rec = enabled()
    trace_dir = (os.environ.get(PROFILE_DIR_ENV) if logger is not None
                 else None)
    own_trace = bool(trace_dir) and not getattr(_tls, "trace_active", False)
    prof = None
    if own_trace:
        _tls.trace_active = True
        prof = torch.profiler.profile()
        prof.__enter__()
    sp = _NULL_SPAN
    stack = None
    if rec:
        stack = _stack()
        parent = stack[-1] if stack else None
        th = threading.current_thread()
        sp = Span(
            name=str(name), attrs=dict(attrs), sid=_alloc_id(),
            parent_id=(parent.sid if parent is not None else None),
            depth=(parent.depth + 1 if parent is not None else 0),
            tid=th.ident, thread_name=th.name,
        )
        stack.append(sp)
    t0 = time.perf_counter()
    try:
        with torch.profiler.record_function(_range_label(str(name), attrs)):
            yield sp
    finally:
        dt = time.perf_counter() - t0
        if rec:
            if stack and stack[-1] is sp:
                stack.pop()
            else:  # a leaked inner generator: drop by identity, not order
                try:
                    stack.remove(sp)
                except ValueError:
                    pass
            sp.ts = t0 - _T0
            sp.dur = dt
            _record(sp)
        if own_trace:
            _tls.trace_active = False
            prof.__exit__(None, None, None)
            os.makedirs(trace_dir, exist_ok=True)
            path = os.path.join(
                trace_dir, f"{name}-{os.getpid()}-{time.time_ns()}.json")
            prof.export_chrome_trace(path)
            if logger is not None:
                logger.info("phase %s: %.3fs (trace -> %s)", name, dt, path)
        elif logger is not None:
            logger.debug("phase %s: %.3fs", name, dt)


def spans() -> list:
    """Finished spans, oldest first, each a plain dict with
    ``name/ts/dur/sync_seconds/tid/thread/id/parent/depth/attrs``."""
    with _lock:
        return list(_ring)


def span_summary() -> dict:
    """Per name over the recorded spans: count, total and largest wall
    seconds, total device-sync seconds."""
    out: dict = {}
    for r in spans():
        s = out.setdefault(r["name"], {
            "count": 0, "total_seconds": 0.0, "max_seconds": 0.0,
            "sync_seconds": 0.0,
        })
        s["count"] += 1
        s["total_seconds"] += r["dur"]
        s["max_seconds"] = max(s["max_seconds"], r["dur"])
        s["sync_seconds"] += r["sync_seconds"]
    for s in out.values():
        for k in ("total_seconds", "max_seconds", "sync_seconds"):
            s[k] = round(s[k], 6)
    return out


def reset_telemetry(ring_capacity: Optional[int] = None) -> None:
    """Clear the span ring and the metrics registry (the compile counts
    are :func:`~dask_ml_tpu_torch.parallel.shapes.reset_compile_stats`'s
    to reset); ``ring_capacity`` resizes the ring."""
    global _ring, _dropped
    with _lock:
        cap = _ring.maxlen if ring_capacity is None else int(ring_capacity)
        if cap is not None and cap < 1:
            raise ValueError(f"ring_capacity must be >= 1, got {cap}")
        _ring = deque(maxlen=cap)
        _dropped = 0
    _registry.reset()


# ---------------------------------------------------------------------------
# export
# ---------------------------------------------------------------------------


def telemetry_report() -> dict:
    """Span aggregates, every registry metric and the live compile counts
    (:func:`~dask_ml_tpu_torch.parallel.shapes.compile_stats`) in one dict;
    ``json.loads(json.dumps(telemetry_report()))`` reproduces it."""
    from dask_ml_tpu_torch.parallel.shapes import compile_stats

    with _lock:
        n_recorded, n_dropped, cap = len(_ring), _dropped, _ring.maxlen
    return {
        "enabled": enabled(),
        "spans": {
            "by_name": span_summary(),
            "n_recorded": n_recorded,
            "n_dropped": n_dropped,
            "ring_capacity": cap,
        },
        "metrics": _registry.snapshot(),
        "compile": dict(compile_stats()),
    }


def render_report(max_rows: int = 12) -> str:
    """Text view of :func:`telemetry_report`."""
    rep = telemetry_report()
    sp = rep["spans"]
    lines = [
        f"telemetry: {sp['n_recorded']} spans recorded"
        + (f" ({sp['n_dropped']} dropped)" if sp["n_dropped"] else ""),
    ]
    by_name = sorted(sp["by_name"].items(),
                     key=lambda kv: -kv[1]["total_seconds"])
    if by_name:
        lines.append(f"  {'total_s':>9}  {'count':>6}  {'sync_s':>8}  span")
        for name, s in by_name[:max_rows]:
            lines.append(f"  {s['total_seconds']:>9.3f}  {s['count']:>6}"
                         f"  {s['sync_seconds']:>8.3f}  {name}")
    m = rep["metrics"]
    for name, v in list(m["counters"].items())[:max_rows]:
        lines.append(f"  counter {name} = {v}")
    for name, g in list(m["gauges"].items())[:max_rows]:
        lines.append(f"  gauge {name}: last={g['last']} min={g['min']} "
                     f"max={g['max']} n={g['n_samples']}")
    for name, h in list(m["histograms"].items())[:max_rows]:
        mean = "n/a" if h["mean"] is None else f"{h['mean']:.4g}"
        pcts = "".join(
            f" {k}={h[k]:.4g}" for k in ("p50", "p90", "p99")
            if h.get(k) is not None)
        lines.append(f"  histogram {name}: count={h['count']} mean={mean} "
                     f"min={h['min']} max={h['max']}{pcts}")
    c = rep["compile"]
    lines.append(f"  compile: {c['n_compiles']} nvcc builds "
                 f"({c['compile_seconds']:.2f}s), {c['n_loads']} kernel "
                 f"library loads ({c['load_seconds']:.2f}s)")
    return "\n".join(lines)


def _json_safe(v: Any):
    if isinstance(v, (str, int, float, bool)) or v is None:
        return v
    return str(v)


def export_chrome_trace(path: str) -> str:
    """Write the recorded spans as Chrome trace-event JSON (the
    ``traceEvents`` array), loadable in Perfetto or ``chrome://tracing``.
    Each span is one complete (``"ph": "X"``) event on its thread's track;
    ``args`` holds its attributes, its id and parent id and its
    device-sync seconds. Returns ``path``."""
    recs = spans()
    pid = os.getpid()
    events: list = [{
        "ph": "M", "pid": pid, "tid": 0, "name": "process_name",
        "args": {"name": "dask_ml_tpu_torch"},
    }]
    seen_tids: set = set()
    for r in recs:
        if r["tid"] not in seen_tids:
            seen_tids.add(r["tid"])
            events.append({
                "ph": "M", "pid": pid, "tid": r["tid"],
                "name": "thread_name", "args": {"name": r["thread"]},
            })
        args = {k: _json_safe(v) for k, v in r["attrs"].items()}
        args["span_id"] = r["id"]
        if r["parent"] is not None:
            args["parent_span_id"] = r["parent"]
        if r["sync_seconds"]:
            args["sync_seconds"] = round(r["sync_seconds"], 6)
        events.append({
            "name": r["name"],
            "cat": "dask_ml_tpu_torch",
            "ph": "X",
            "pid": pid,
            "tid": r["tid"],
            "ts": round(r["ts"] * 1e6, 3),
            "dur": round(r["dur"] * 1e6, 3),
            "args": args,
        })
    path = os.fspath(path)
    with open(path, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    return path

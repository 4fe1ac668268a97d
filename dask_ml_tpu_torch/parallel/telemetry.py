"""Phase spans and counters for the PyTorch port (the part of
``dask_ml_tpu/parallel/telemetry.py`` the estimators and the search driver
call).

With the ``telemetry`` knob off (the default) :func:`span` returns a shared
null context manager and :func:`counter` a shared null counter: nothing
is recorded. With it on, each span is a ``torch.profiler.record_function``
range, so a ``torch.profiler`` trace of a fit shows the init / Lloyd /
finalize phases by name, and each counter adds to a process-wide
registry that :func:`counters` reads and :func:`render_counters` prints
(the search driver's ``shared_fit_report()`` appends it). Counters in use:
``search.cell_timeouts`` (cells cut by ``cell_timeout``),
``checkpoint.cells_journaled`` and ``checkpoint.cells_restored`` (the
search's cell journal).
"""

from __future__ import annotations

import contextlib
import threading

from dask_ml_tpu_torch.config import get_config

_NULL_SPAN = contextlib.nullcontext()


def enabled() -> bool:
    return bool(get_config()["telemetry"])


def span(name: str, **attrs):
    """Context manager around one phase. ``attrs`` are appended to the
    range name as ``key=value`` pairs when telemetry is on."""
    if not enabled():
        return _NULL_SPAN
    import torch

    label = name if not attrs else name + "[" + ",".join(
        f"{k}={v}" for k, v in sorted(attrs.items())) + "]"
    return torch.profiler.record_function(label)


class Counter:
    """A named monotone count, safe to add to from several threads."""

    def __init__(self, name: str):
        self.name = name
        self.value = 0
        self._lock = threading.Lock()

    def inc(self, v=1) -> None:
        with self._lock:
            self.value += v


class _NullCounter:
    value = 0

    def inc(self, v=1) -> None:
        pass


_NULL_COUNTER = _NullCounter()
_counters: dict = {}
_counters_lock = threading.Lock()


def counter(name: str):
    """The named counter, or the shared null counter when telemetry is
    off."""
    if not enabled():
        return _NULL_COUNTER
    with _counters_lock:
        c = _counters.get(name)
        if c is None:
            c = _counters[name] = Counter(name)
        return c


def counters() -> dict:
    """``{name: value}`` of every counter recorded so far."""
    with _counters_lock:
        return {name: c.value for name, c in sorted(_counters.items())}


def reset_counters() -> None:
    with _counters_lock:
        _counters.clear()


def render_counters() -> str:
    """The counters as text, one ``name value`` line each."""
    rows = counters()
    if not rows:
        return "telemetry counters: none recorded"
    width = max(len(k) for k in rows)
    return "\n".join(["telemetry counters:"]
                     + [f"  {k:<{width}}  {v}" for k, v in rows.items()])

"""Phase spans for the PyTorch port (the part of
``dask_ml_tpu/parallel/telemetry.py`` the KMeans facade calls).

With the ``telemetry`` knob off (the default) :func:`span` returns a shared
null context manager and records nothing. With it on, each span is a
``torch.profiler.record_function`` range, so a ``torch.profiler`` trace of
a fit shows the init / Lloyd / finalize phases by name.
"""

from __future__ import annotations

import contextlib

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

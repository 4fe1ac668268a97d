"""Global + scoped execution configuration of the PyTorch port.

The counterpart of ``dask_ml_tpu/config.py``: process-wide
:func:`set_config`, scoped :func:`config_context` (thread-local,
nestable), read by the staging layer and the estimator facades.

Knobs:

- ``device`` — where fits and predictions run. The default ``"cuda"``
  runs every entry point on the card; :func:`resolve_device` raises when
  no card is present rather than carrying on on the CPU. The tests pass
  ``config_context(device="cpu")``, where every kernel wrapper takes its
  plain PyTorch version because the tensors it is given lie on the CPU.
- ``dtype`` — staging dtype for ``X``: ``None`` (the policy's storage
  dtype, else the validated input dtype, float32), ``torch.float32`` or
  ``torch.bfloat16``. An explicit ``dtype`` outranks the ``precision``
  policy.
- ``precision`` — the mixed-precision policy
  (:mod:`dask_ml_tpu_torch.parallel.precision`): ``"auto"`` (the
  default: f32, since the port has no TPU), ``None`` / ``"f32"`` /
  ``"float32"``, ``"bf16"`` / ``"bfloat16"`` (X staged and streamed as
  bf16, products of bf16 operands accumulated in f32, solver state f32),
  or a :class:`~dask_ml_tpu_torch.parallel.precision.PrecisionPolicy`.
- ``device_outputs`` — when True, ``predict``/``transform`` return the
  device tensor instead of host numpy (:func:`maybe_host`).
- ``telemetry`` — when True, :func:`~dask_ml_tpu_torch.parallel.telemetry.span`
  wraps each phase in ``torch.profiler.record_function``.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Any

import torch

_DEFAULTS: dict[str, Any] = {
    "device": "cuda",
    "dtype": None,
    "precision": "auto",
    "device_outputs": False,
    "telemetry": False,
}

_global_config = dict(_DEFAULTS)
_local = threading.local()


def _stack() -> list:
    if not hasattr(_local, "stack"):
        _local.stack = []
    return _local.stack


def get_config() -> dict:
    """The effective configuration: process-wide settings overlaid by every
    active :func:`config_context` scope on this thread (innermost wins)."""
    cfg = dict(_global_config)
    for layer in _stack():
        cfg.update(layer)
    return cfg


def _validate_options(options: dict) -> None:
    for k, v in options.items():
        if k not in _DEFAULTS:
            raise KeyError(
                f"unknown config option {k!r}; valid: {sorted(_DEFAULTS)}")
        if k == "dtype" and v not in (None, torch.float32, torch.bfloat16):
            raise ValueError(
                f"dtype={v!r}: the port stages float32 or bfloat16")
        if k == "device":
            torch.device(v)  # raises on a malformed device string


def set_config(**options) -> None:
    """Set process-wide defaults (``set_config(device="cpu")``)."""
    _validate_options(options)
    _global_config.update(options)


def reset_config() -> None:
    """Restore the built-in defaults (mainly for tests)."""
    _global_config.clear()
    _global_config.update(_DEFAULTS)


@contextlib.contextmanager
def config_context(**options):
    """Scoped, nestable, thread-local override."""
    _validate_options(options)
    stack = _stack()
    stack.append(dict(options))
    try:
        yield
    finally:
        stack.pop()


def resolve_device(device=None) -> torch.device:
    """The ``torch.device`` an entry point runs on: ``device`` when given,
    else the configured one. A CUDA device without a usable card raises —
    the port never falls back to the CPU on its own."""
    dev = torch.device(device if device is not None
                       else get_config()["device"])
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "False; run on a machine with a CUDA card or pass "
            "config_context(device='cpu')")
    return dev


def maybe_host(x: torch.Tensor, trusted: bool = True):
    """Return ``x`` as host numpy unless ``device_outputs`` is enabled, in
    which case the device tensor passes through untouched. A tensor that
    passes through is marked trusted in the active staging scope (it
    derives from input its producer validated), so the next pipeline
    stage's ``check_array`` skips its NaN/inf scan, a host read;
    ``trusted=False`` is for producers that can make non-finite values
    from finite input (a division by a variance that may be 0)."""
    if get_config()["device_outputs"]:
        if trusted:
            from dask_ml_tpu_torch.parallel.sharding import _current_memo

            memo = _current_memo()
            if memo is not None:
                memo.trust(x)
        return x
    return x.detach().cpu().numpy()

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
- ``pad_policy`` — ``"auto"`` (the default), ``None`` or a
  :class:`~dask_ml_tpu_torch.parallel.shapes.PadPolicy`, resolved by
  :func:`~dask_ml_tpu_torch.parallel.shapes.active_policy` and used by
  :func:`~dask_ml_tpu_torch.parallel.shapes.bucket_rows`. The JAX package
  buckets every staged row count under it; the port's staging pads nothing
  on one device (eager PyTorch compiles nothing per shape), and over a
  mesh of more than one shard pads the rows to this bucket, as the JAX
  package does; the padding rows weigh 0, so the knob changes no fit.
- ``compilation_cache`` — a directory, process-wide only
  (:func:`config_context` refuses to change it, as the JAX package does;
  it may restate the process's value, as a worker thread does when it
  re-enters its caller's configuration). The JAX
  package points XLA's persistent cache there; the port has no XLA, and
  its kernel builds persist in ``_kernels/_build`` anyway, so
  :func:`set_config` only creates the directory
  (:func:`~dask_ml_tpu_torch.parallel.shapes.enable_persistent_cache`).
- ``mesh`` — the :class:`~dask_ml_tpu_torch.parallel.mesh.Mesh` fits run
  on: ``set_config(mesh=...)`` sets the process-wide default (consulted
  by ``default_mesh()``), and ``config_context(mesh=...)`` scopes it
  through :func:`~dask_ml_tpu_torch.parallel.mesh.use_mesh`, a
  process-visible stack, so the search's worker threads resolve the mesh
  of the thread that opened the scope. ``config_context(mesh=None)`` is
  refused where a mesh is set: the stack cannot express "no mesh" inside
  an enclosing scope; clear the process default with
  ``set_config(mesh=None)``. Where none is set it restates the default,
  as a worker thread re-entering its caller's configuration does.
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
    "pad_policy": "auto",
    "compilation_cache": None,
    "mesh": None,
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
        if k == "mesh" and v is not None:
            from dask_ml_tpu_torch.parallel.mesh import Mesh

            if not isinstance(v, Mesh):
                raise ValueError(
                    f"mesh must be None or a parallel.mesh.Mesh; got {v!r}")
        if k == "pad_policy" and v is not None and v != "auto":
            from dask_ml_tpu_torch.parallel.shapes import PadPolicy

            if not isinstance(v, PadPolicy):
                raise ValueError(
                    f"pad_policy must be 'auto', None, or a PadPolicy; "
                    f"got {v!r}")


def thread_config() -> dict:
    """The calling thread's configuration for a worker thread to re-enter
    with ``config_context(**thread_config())``: ``get_config()`` without
    an unset ``mesh``, whose restatement inside a ``use_mesh`` scope
    would be refused (the scope itself is process-wide, the worker sees
    it)."""
    cfg = dict(get_config())
    if cfg.get("mesh") is None:
        cfg.pop("mesh", None)
    return cfg


def get_option(name: str):
    """One option of the effective configuration (a ``KeyError`` for an
    unknown name)."""
    cfg = get_config()
    if name not in cfg:
        raise KeyError(
            f"unknown config option {name!r}; valid: {sorted(_DEFAULTS)}")
    return cfg[name]


def set_config(**options) -> None:
    """Set process-wide defaults (``set_config(device="cpu")``)."""
    _validate_options(options)
    if "compilation_cache" in options:
        from dask_ml_tpu_torch.parallel.shapes import enable_persistent_cache

        enable_persistent_cache(options["compilation_cache"])
    _global_config.update(options)


def reset_config() -> None:
    """Restore the built-in defaults (mainly for tests)."""
    _global_config.clear()
    _global_config.update(_DEFAULTS)


@contextlib.contextmanager
def config_context(**options):
    """Scoped, nestable, thread-local override."""
    _validate_options(options)
    options = dict(options)
    # process-wide only: a scope may restate the process's value (a
    # worker thread re-entering its caller's whole configuration), not
    # change it
    if options.pop("compilation_cache",
                   _global_config["compilation_cache"]) \
            != _global_config["compilation_cache"]:
        raise ValueError(
            "compilation_cache is process-wide; use "
            "set_config(compilation_cache=...) instead of config_context")
    if "mesh" in options and options["mesh"] is None:
        from dask_ml_tpu_torch.parallel import mesh as mesh_lib

        # a scope may restate "no mesh" (a worker thread re-entering its
        # caller's whole configuration), not clear one
        if get_config()["mesh"] is not None or mesh_lib._mesh_stack:
            raise ValueError(
                "config_context(mesh=None) cannot clear an enclosing mesh "
                "scope; use set_config(mesh=None) to clear the process-wide "
                "default, or pass an explicit Mesh")
        del options["mesh"]
    mesh = options.get("mesh")
    stack = _stack()
    stack.append(options)
    try:
        if mesh is not None:
            from dask_ml_tpu_torch.parallel.mesh import use_mesh

            with use_mesh(mesh):
                yield
        else:
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

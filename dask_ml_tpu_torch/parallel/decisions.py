"""Measured dispatch verdicts (counterpart of
``dask_ml_tpu/parallel/decisions.py``).

The JAX package's dispatch predicates (``_pallas_auto_wins``,
``_bounded_auto_wins``, ``_fused_auto_wins``, the sparse SpMM rule) read
this cache first: bench timings persist per-``(rule, backend)`` verdicts
into ``_decisions.json``, and the hand-written inequalities answer where
no entry matches. The port keeps the cache, its format and its matching
rules, with its own copy of ``_decisions.json`` beside this module.

**The port consults it nowhere on the card.** On a CUDA tensor
``kernel="auto"`` takes the hand-written kernel without exception: a
verdict that chose the plain version there would hide the kernel. The
port's cold-start rules (``models.kmeans._bounded_auto_wins``,
``sketched_assign_wins``) are the JAX fallbacks, unchanged.

Entry shape::

    {"rule": "sparse.spmv.pallas",
     "backend": "cpu",
     "match": {"n": [4096, 16384], "k": 16},
     "verdict": false,
     "measured": {"xla_ms": 0.8, "pallas_ms": 41.0, "n": 8192}}

``match`` values are a scalar (exact equality; dtypes compare by ``str``)
or an inclusive ``[lo, hi]`` range. An entry applies when its ``backend``
equals the backend key and every match key is present and satisfied;
the first matching entry wins. The backend key is a tensor's device type
(``"cuda"`` / ``"cpu"``), where the JAX package has
``jax.default_backend()``; by default the configured device's type.

``DASK_ML_TPU_DECISIONS`` points the loader at another cache file;
:func:`save` writes the in-memory cache.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

import torch

__all__ = ["lookup", "record", "save", "reset_cache", "cache_path",
           "entries"]

_lock = threading.Lock()
_cache: Optional[list] = None  # lazy-loaded entry list


def cache_path() -> str:
    """The active cache file: ``$DASK_ML_TPU_DECISIONS`` if set, else the
    ``_decisions.json`` next to this module."""
    env = os.environ.get("DASK_ML_TPU_DECISIONS")
    if env:
        return env
    return os.path.join(os.path.dirname(__file__), "_decisions.json")


def _load() -> list:
    global _cache
    with _lock:
        if _cache is not None:
            return _cache
        try:
            with open(cache_path()) as fh:
                raw = json.load(fh)
            entries_ = list(raw.get("entries", []))
        except (OSError, ValueError):  # missing/corrupt cache = cold start
            entries_ = []
        _cache = entries_
        return _cache


def reset_cache() -> None:
    """Drop the in-memory cache; the next lookup reloads from disk."""
    global _cache
    with _lock:
        _cache = None


def entries() -> list:
    """The loaded entry list (a copy)."""
    return list(_load())


def _matches(spec, value) -> bool:
    if isinstance(spec, (list, tuple)):
        if len(spec) != 2:
            return False
        try:
            return float(spec[0]) <= float(value) <= float(spec[1])
        except (TypeError, ValueError):
            return False
    if isinstance(spec, str) or isinstance(value, str):
        return str(spec) == str(value)
    try:
        return float(spec) == float(value)
    except (TypeError, ValueError):
        return spec == value


def _backend(backend: Optional[str]) -> str:
    if backend is not None:
        return str(backend)
    from dask_ml_tpu_torch.config import get_config

    return torch.device(get_config()["device"]).type


def lookup(rule: str, params: dict, fallback: bool,
           backend: Optional[str] = None) -> bool:
    """Measured verdict for ``rule`` at ``params`` on ``backend`` (a
    device type; default the configured device's), else ``fallback``."""
    cached = _load()
    if not cached:
        return bool(fallback)
    backend = _backend(backend)
    for e in cached:
        if e.get("rule") != rule or e.get("backend") != backend:
            continue
        match = e.get("match", {})
        if all(k in params and _matches(v, params[k])
               for k, v in match.items()):
            return bool(e.get("verdict"))
    return bool(fallback)


def record(rule: str, match: dict, verdict: bool, measured: dict = None,
           backend: str = None) -> dict:
    """Append a measured entry to the in-memory cache (persist with
    :func:`save`). Returns the entry."""
    entry = {
        "rule": rule,
        "backend": _backend(backend),
        "match": match,
        "verdict": bool(verdict),
    }
    if measured:
        entry["measured"] = measured
    cached = _load()
    with _lock:
        cached.append(entry)
    return entry


def save(path: str = None) -> str:
    """Write the in-memory cache to ``path`` (default: the active cache
    file). Nothing writes it on import."""
    path = path or cache_path()
    cached = _load()
    with _lock:
        payload = {"entries": cached}
        with open(path, "w") as fh:
            json.dump(payload, fh, indent=1, sort_keys=True)
            fh.write("\n")
    return path

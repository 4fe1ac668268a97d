"""Hand-off to other stacks: staged data and fitted models as host arrays
(the counterpart of ``dask_ml_tpu/interop.py``).

dask-ml's ecosystem bridges re-export runtimes that run beside a dask
cluster (``dask-xgboost``, ``dask-tensorflow``, the distributed joblib
backend). Here the bridge is a clean export of device data to the host,
and the ``joblib`` / ``xgboost`` / ``tensorflow`` modules of this package
re-export it under those names:

- :func:`to_numpy` — a tensor (on any device), a staged
  :class:`~dask_ml_tpu_torch.parallel.sharding.DeviceData` (its rows past
  ``n`` dropped) or an array → a host ndarray. A bf16 tensor comes out as
  float32, since numpy has no bf16.
- :func:`to_torch` — the same rows as a tensor on the port's device: the
  card unless the caller asks for the CPU (``device=`` or the ``device``
  config knob), a copy the caller may write to.
- :func:`export_learned_attrs` — a fitted estimator's learned state (its
  trailing-underscore attributes) as a plain ``{name: ndarray}`` dict.
"""

from __future__ import annotations

import numpy as np

__all__ = ["to_numpy", "to_torch", "export_learned_attrs"]


def _host(t) -> np.ndarray:
    import torch

    t = t.detach()
    if t.dtype == torch.bfloat16:
        t = t.float()
    return t.cpu().numpy()


def to_numpy(x, n_valid=None) -> np.ndarray:
    """Copy a tensor, a staged ``DeviceData`` or an array to host numpy.

    A ``DeviceData`` drops the rows past its ``n`` by itself; for a raw
    tensor or array pass ``n_valid`` to keep only the first rows."""
    import torch

    from dask_ml_tpu_torch.parallel.sharding import DeviceData

    if isinstance(x, DeviceData):
        if not isinstance(x.X, torch.Tensor):
            raise TypeError(
                "to_numpy takes dense staged data; a SparseRows container "
                "has no dense host form here")
        return _host(x.X[: x.n])
    out = _host(x) if isinstance(x, torch.Tensor) else np.asarray(x)
    if n_valid is not None:
        out = out[:n_valid]
    return out


def to_torch(x, n_valid=None, device=None):
    """The rows of :func:`to_numpy` as a tensor on ``device`` (default:
    the configured device, the card unless the caller asks for the CPU);
    a copy, so writing to it changes nothing of ``x``."""
    import torch

    from dask_ml_tpu_torch.config import resolve_device

    host = np.array(to_numpy(x, n_valid), copy=True)
    return torch.from_numpy(host).to(resolve_device(device))


def export_learned_attrs(estimator) -> dict:
    """A fitted estimator's state (its public ``*_`` attributes) as host
    arrays: the hand-off form for other serving or training stacks.
    Tensors come to the host; a value numpy cannot hold stays as it is."""
    import torch

    out = {}
    for name, value in vars(estimator).items():
        if name.endswith("_") and not name.startswith("_"):
            if isinstance(value, torch.Tensor):
                out[name] = _host(value)
                continue
            try:
                out[name] = np.asarray(value)
            except Exception:
                out[name] = value
    return out

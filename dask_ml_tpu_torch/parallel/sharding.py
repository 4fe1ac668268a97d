"""Single-device staging (counterpart of ``dask_ml_tpu/parallel/sharding.py``).

The JAX package pads the sample axis to a mesh multiple and a shape bucket
so that XLA compiles one program per bucket. Eager PyTorch on one card has
nothing to recompile and no mesh to divide by, so staging here is one
host→device copy with no padding: ``n_padded == n``. The weight vector
keeps the reference's contract all the same — a row that carries weight 0
contributes nothing to sums, counts or inertia.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dask_ml_tpu_torch.config import get_config, resolve_device


@dataclasses.dataclass
class DeviceData:
    """A dataset staged onto the configured device."""

    X: torch.Tensor  # (n, d) float32, contiguous, row-major
    weights: torch.Tensor  # (n,) float32
    n: int  # true number of rows
    n_features: int


def prepare_data(X, sample_weight=None, device=None) -> DeviceData:
    """Stage a validated ``X`` (numpy or tensor, float32) and its
    ``sample_weight`` (default 1 per row) onto ``device`` (default: the
    configured one) as contiguous float32 tensors."""
    dev = resolve_device(device)
    dtype = get_config()["dtype"] or torch.float32
    Xt = torch.as_tensor(X).to(device=dev, dtype=dtype).contiguous()
    n, d = int(Xt.shape[0]), int(Xt.shape[1])
    if sample_weight is None:
        w = torch.ones(n, dtype=torch.float32, device=dev)
    else:
        w = torch.as_tensor(
            np.asarray(sample_weight, dtype=np.float32)
            if not isinstance(sample_weight, torch.Tensor) else sample_weight)
        if tuple(w.shape) != (n,):
            raise ValueError(
                f"sample_weight shape {tuple(w.shape)} != ({n},)")
        w = w.to(device=dev, dtype=torch.float32).contiguous()
    return DeviceData(X=Xt, weights=w, n=n, n_features=d)


def unpad_rows(x: torch.Tensor, n_valid: int) -> torch.Tensor:
    """Drop padding rows from a per-row result (labels, transforms)."""
    return x[:n_valid]

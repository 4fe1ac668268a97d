"""Pairwise distances of the PyTorch port (the part of
``dask_ml_tpu/ops/pairwise.py`` that ``KMeans.transform`` calls)."""

from __future__ import annotations

import torch


def euclidean_distances(X, Y):
    """Euclidean distance matrix between the rows of X and Y, from
    ``|x|² + |y|² − 2·x·y`` clamped at 0 against cancellation."""
    x2 = (X * X).sum(dim=1)[:, None]
    y2 = (Y * Y).sum(dim=1)[None, :]
    return torch.sqrt(torch.clamp(x2 + y2 - 2.0 * (X @ Y.T), min=0.0))

"""Small helpers of the PyTorch port (counterpart of
``dask_ml_tpu/utils/_utils.py``)."""

from __future__ import annotations

import numpy as np


def slice_columns(X, columns):
    """Column subset of a DataFrame (all columns when ``columns`` is None);
    arrays pass through untouched."""
    if hasattr(X, "iloc"):
        return X[list(X.columns) if columns is None else list(columns)]
    return X


def check_chunks(n_samples: int, n_features: int, chunks=None) -> tuple:
    """A row-block request as ``(rows_per_block, n_features)``: None takes
    one block per device (``torch.cuda.device_count()`` on the card, 1
    where there is none), an int that many blocks, each of at least 100
    rows; a 2-sequence passes through."""
    from collections.abc import Sequence
    from numbers import Integral

    if chunks is None:
        import torch

        devices = max(1, torch.cuda.device_count()
                      if torch.cuda.is_available() else 1)
        chunks = (max(100, n_samples // devices), n_features)
    elif isinstance(chunks, Integral):
        chunks = (max(100, n_samples // int(chunks)), n_features)
    elif isinstance(chunks, Sequence) and not isinstance(chunks, str):
        chunks = tuple(chunks)
        if len(chunks) != 2:
            raise AssertionError("Chunks should be a 2-tuple.")
    else:
        raise ValueError(f"Unknown type of chunks: '{type(chunks)}'")
    return chunks


def handle_zeros_in_scale(scale):
    """A float64 host copy of ``scale`` in which a zero scale (a constant
    feature) becomes 1, so that dividing by it leaves the feature as it
    is."""
    scale = np.asarray(scale, dtype=float).copy()
    scale[scale == 0.0] = 1.0
    return scale


def copy_learned_attributes(from_estimator, to_estimator) -> None:
    """Copy every fitted (trailing-underscore) attribute from one estimator
    to another, preserving the scikit-learn convention that learned state
    lives in ``*_`` attributes."""
    attrs = {
        k: v
        for k, v in vars(from_estimator).items()
        if k.endswith("_") and not k.startswith("_")
    }
    for k, v in attrs.items():
        setattr(to_estimator, k, v)

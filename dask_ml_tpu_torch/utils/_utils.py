"""Small helpers of the PyTorch port (counterpart of
``dask_ml_tpu/utils/_utils.py``)."""

from __future__ import annotations


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

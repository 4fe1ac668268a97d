"""Classification metrics (counterpart of
``dask_ml_tpu/metrics/classification.py``), in numpy."""

from __future__ import annotations

import numpy as np


def accuracy_score(y_true, y_pred, normalize: bool = True,
                   sample_weight=None) -> float:
    """Weighted share (``normalize=True``) or weighted count of rows whose
    label matches; a 2-D (multilabel) row counts only if every label
    matches. Labels of any dtype compare as values; one side strings and
    the other numbers raises, as scikit-learn does."""
    y_true, y_pred = np.asarray(y_true), np.asarray(y_pred)
    if (y_true.dtype.kind in "USO") != (y_pred.dtype.kind in "USO"):
        raise TypeError(
            "Labels in y_true and y_pred should be of the same type, got "
            f"dtype kinds {y_true.dtype.kind!r} and {y_pred.dtype.kind!r}")
    if y_true.shape != y_pred.shape:
        raise ValueError(
            f"y_true {y_true.shape} and y_pred {y_pred.shape} differ")
    match = y_true == y_pred
    if match.ndim > 1:
        match = match.all(axis=1)
    w = (np.ones(match.shape[0]) if sample_weight is None
         else np.asarray(sample_weight, dtype=np.float64))
    total = float(np.dot(match.astype(np.float64), w))
    return total / float(w.sum()) if normalize else total

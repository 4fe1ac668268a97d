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


def log_loss(y_true, y_pred, sample_weight=None, labels=None) -> float:
    """Cross-entropy of probability predictions, the JAX package's rules:
    labels are encoded positionally against the sorted class set (of
    ``labels`` where given), so any label values score; ``y_pred`` is the
    positive class's probability (1-D, two classes) or one column per
    class; probabilities are taken in float32, as the JAX package stages
    them, and clipped to ``[eps, 1 - eps]`` with ``eps`` float32's machine
    epsilon (a smaller clip would leave ``1 - eps == 1``)."""
    y_arr = np.asarray(y_true)
    classes = np.unique(y_arr) if labels is None else np.unique(labels)
    if len(classes) < 2:
        raise ValueError(
            "y_true contains a single label; pass labels= with the full "
            "class set")
    codes = np.searchsorted(classes, y_arr)
    if not ((codes < len(classes)).all()
            and np.array_equal(classes[np.minimum(codes, len(classes) - 1)],
                               y_arr)):
        raise ValueError("y_true contains labels not in `labels`")
    p = np.asarray(y_pred, dtype=np.float32)
    if p.ndim == 2 and p.shape[1] != len(classes):
        raise ValueError(
            f"y_pred has {p.shape[1]} columns but there are "
            f"{len(classes)} classes")
    if p.ndim == 1 and len(classes) != 2:
        raise ValueError(
            "1-D y_pred (probability of the positive class) requires "
            f"exactly 2 classes, got {len(classes)}")
    eps = np.finfo(np.float32).eps
    p = np.clip(p, eps, 1.0 - eps)
    if p.ndim == 1:
        ll = -(codes * np.log(p) + (1.0 - codes) * np.log(1.0 - p))
    else:
        ll = -np.log(p[np.arange(len(codes)), codes])
    w = (np.ones(len(codes), np.float32) if sample_weight is None
         else np.asarray(sample_weight, dtype=np.float32))
    return float(np.average(ll, weights=w))

"""Regression metrics (counterpart of ``dask_ml_tpu/metrics/regression.py``),
in numpy, ``multioutput="uniform_average"`` only as there."""

from __future__ import annotations

import numpy as np


def _prep(y_true, y_pred, sample_weight, multioutput):
    if multioutput not in (None, "uniform_average"):
        raise ValueError(
            "Only multioutput='uniform_average' (or None) is supported")
    y_true = np.asarray(y_true, dtype=np.float64)
    y_pred = np.asarray(y_pred, dtype=np.float64)
    if y_true.shape != y_pred.shape:
        raise ValueError(
            f"y_true {y_true.shape} and y_pred {y_pred.shape} differ")
    w = (np.ones(y_true.shape[0]) if sample_weight is None
         else np.asarray(sample_weight, dtype=np.float64))
    return y_true, y_pred, w


def _rowwise(err):
    return err.mean(axis=1) if err.ndim > 1 else err


def mean_squared_error(y_true, y_pred, sample_weight=None,
                       multioutput="uniform_average") -> float:
    y_true, y_pred, w = _prep(y_true, y_pred, sample_weight, multioutput)
    return float(np.average(_rowwise((y_true - y_pred) ** 2), weights=w))


def mean_absolute_error(y_true, y_pred, sample_weight=None,
                        multioutput="uniform_average") -> float:
    y_true, y_pred, w = _prep(y_true, y_pred, sample_weight, multioutput)
    return float(np.average(_rowwise(np.abs(y_true - y_pred)), weights=w))


def r2_score(y_true, y_pred, sample_weight=None,
             multioutput="uniform_average") -> float:
    y_true, y_pred, w = _prep(y_true, y_pred, sample_weight, multioutput)
    if y_true.ndim > 1:
        raise ValueError("r2_score supports 1-D targets only")
    num = float(np.sum(w * (y_true - y_pred) ** 2))
    mean = np.average(y_true, weights=w)
    den = float(np.sum(w * (y_true - mean) ** 2))
    return 1.0 - num / den

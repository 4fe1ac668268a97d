"""Regression metrics (counterpart of ``dask_ml_tpu/metrics/regression.py``),
in numpy, ``multioutput="uniform_average"`` only as there.

A zero denominator follows IEEE rules, as the JAX expressions do: 0/0 is
NaN and x/0 is ±inf (all-zero ``sample_weight``; ``r2_score`` of a
constant ``y_true``: NaN where ``y_pred`` equals it, −inf otherwise)."""

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


def _divide(num, den):
    """``num / den`` as numpy scalars, NaN for 0/0 and ±inf for x/0."""
    with np.errstate(divide="ignore", invalid="ignore"):
        return np.divide(num, den)


def _average(a, w):
    """``np.average(a, weights=w)`` with the same bits, but NaN where the
    weights sum to 0 (``np.average`` raises there)."""
    dt = np.result_type(a.dtype, w.dtype)
    return _divide(np.multiply(a, w, dtype=dt).sum(), w.sum(dtype=dt))


def mean_squared_error(y_true, y_pred, sample_weight=None,
                       multioutput="uniform_average") -> float:
    y_true, y_pred, w = _prep(y_true, y_pred, sample_weight, multioutput)
    return float(_average(_rowwise((y_true - y_pred) ** 2), w))


def mean_absolute_error(y_true, y_pred, sample_weight=None,
                        multioutput="uniform_average") -> float:
    y_true, y_pred, w = _prep(y_true, y_pred, sample_weight, multioutput)
    return float(_average(_rowwise(np.abs(y_true - y_pred)), w))


def r2_score(y_true, y_pred, sample_weight=None,
             multioutput="uniform_average") -> float:
    y_true, y_pred, w = _prep(y_true, y_pred, sample_weight, multioutput)
    if y_true.ndim > 1:
        raise ValueError("r2_score supports 1-D targets only")
    num = np.sum(w * (y_true - y_pred) ** 2)
    mean = _average(y_true, w)
    den = np.sum(w * (y_true - mean) ** 2)
    return float(1.0 - _divide(num, den))

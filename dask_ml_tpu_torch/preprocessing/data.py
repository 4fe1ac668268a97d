"""Scalers of the PyTorch port (counterpart of
``dask_ml_tpu/preprocessing/data.py``): :class:`StandardScaler`, whose fit
is one weighted column reduction on the device and whose transform is one
elementwise expression. The class stands on the port's own estimator base
(the card's machine has no scikit-learn) with scikit-learn's constructor
and attributes.
"""

from __future__ import annotations

import torch

from dask_ml_tpu_torch.base import BaseEstimator, TransformerMixin
from dask_ml_tpu_torch.config import get_config, maybe_host
from dask_ml_tpu_torch.parallel.sharding import is_sparse_input, prepare_data
from dask_ml_tpu_torch.utils.validation import check_array

_SPARSE = ("sparse input to StandardScaler is not ported yet (the JAX "
           "package scales a container's columns through its nnz moments); "
           "it comes with the rest of preprocessing, ROADMAP Queue A item 8")


def _mean_var(X, w):
    """Weighted column mean and variance, and the scale: ``sqrt(var)`` with
    constant columns (variance 0) dividing by 1."""
    sw = torch.clamp(w.sum(), min=1.0)
    mean = (w[:, None] * X).sum(0) / sw
    var = (w[:, None] * (X - mean) ** 2).sum(0) / sw
    scale = torch.sqrt(torch.where(var == 0.0, torch.ones_like(var), var))
    return mean, var, scale


def _standardize(X, mean, scale):
    return (X - mean) / scale


def _on(a, like):
    """A fitted statistic (host array or device tensor) as a tensor on
    ``like``'s device, in its dtype or f32 if that is narrower (a bf16
    staged X is scaled in f32, as ``jnp`` promotes the pair)."""
    return torch.as_tensor(a).to(
        device=like.device, dtype=torch.promote_types(like.dtype,
                                                      torch.float32))


class StandardScaler(TransformerMixin, BaseEstimator):
    """Standardize features by removing the mean and scaling to unit
    variance (scikit-learn's surface).

    Parameters
    ----------
    copy : bool, default True — accepted for signature parity (the
        transform always returns a new array).
    with_mean : bool, default True
    with_std : bool, default True

    Attributes
    ----------
    mean_, var_, scale_ : (n_features,) arrays, None where disabled —
        host numpy, or device tensors under ``device_outputs``
    n_samples_seen_ : int
    n_features_in_ : int
    """

    def __init__(self, copy=True, with_mean=True, with_std=True):
        self.copy = copy
        self.with_mean = with_mean
        self.with_std = with_std

    def fit(self, X, y=None):
        if is_sparse_input(X):
            raise NotImplementedError(_SPARSE)
        X = check_array(X)
        data = prepare_data(X)
        mean, var, scale = _mean_var(data.X, data.weights)
        if not get_config()["device_outputs"]:
            mean, var, scale = (mean.cpu().numpy(), var.cpu().numpy(),
                                scale.cpu().numpy())
        self.mean_ = mean if self.with_mean else None
        if self.with_std:
            self.var_, self.scale_ = var, scale
        else:
            self.var_ = self.scale_ = None
        self.n_samples_seen_ = data.n
        self.n_features_in_ = data.n_features
        return self

    def partial_fit(self, X, y=None):
        raise NotImplementedError(
            "partial_fit is unsupported, as in the reference "
            "(preprocessing/data.py:51-52)")

    def _staged(self, X):
        if not hasattr(self, "n_samples_seen_"):
            raise AttributeError("StandardScaler is not fitted; call fit")
        if is_sparse_input(X):
            raise NotImplementedError(_SPARSE)
        return prepare_data(check_array(X)).X

    def transform(self, X, y=None, copy=None):
        Xs = self._staged(X)
        if self.with_mean and self.with_std:
            Xs = _standardize(Xs, _on(self.mean_, Xs), _on(self.scale_, Xs))
        else:
            if self.with_mean:
                Xs = Xs - _on(self.mean_, Xs)
            if self.with_std:
                Xs = Xs / _on(self.scale_, Xs)
        return maybe_host(Xs)

    def inverse_transform(self, X, copy=None):
        Xs = self._staged(X)
        if self.with_std:
            Xs = Xs * _on(self.scale_, Xs)
        if self.with_mean:
            Xs = Xs + _on(self.mean_, Xs)
        return maybe_host(Xs)


__all__ = ["StandardScaler"]

"""Gaussian naive Bayes of the PyTorch port (counterpart of
``dask_ml_tpu/naive_bayes.py``), and the deprecated ``Partial*`` naive
Bayes estimators.

:class:`GaussianNB` takes every class's weighted moments in one pass on
the device: a one-hot class-membership product against the rows centred
on the global weighted mean, in float32. Centring first (the JAX
package's two-pass form) keeps the variance of a feature whose mean is
far larger than its spread: ``E[x²] − θ²`` taken directly in float32
cancels to 0 there. Variance smoothing is scikit-learn's
(``var_smoothing`` times the largest pooled feature variance), with an
absolute floor so that all-constant data keeps finite likelihoods.

:func:`logsumexp` is the stable log-sum-exp reduction of the reference's
surface.

``PartialMultinomialNB`` and ``PartialBernoulliNB`` subclass
scikit-learn's estimators and load on first access (module
``__getattr__``), so this module imports without scikit-learn.
"""

from __future__ import annotations

import numpy as np
import torch

from dask_ml_tpu_torch.base import BaseEstimator
from dask_ml_tpu_torch.config import resolve_device
from dask_ml_tpu_torch.parallel.sharding import prepare_data
from dask_ml_tpu_torch.utils.validation import check_array

__all__ = ["GaussianNB", "PartialMultinomialNB", "PartialBernoulliNB",
           "logsumexp"]


def logsumexp(arr, axis=0):
    """Stable ``log(sum(exp(arr)))`` along ``axis`` (``None``: over every
    axis), a tensor. A tensor is reduced where it lies, in its dtype;
    other input is staged float32 on the configured device, as the JAX
    package's (x64 off) is."""
    t = arr if isinstance(arr, torch.Tensor) else torch.as_tensor(
        np.asarray(arr, dtype=np.float32), device=resolve_device())
    dim = tuple(range(t.ndim)) if axis is None else axis
    return torch.logsumexp(t, dim=dim)


def _global_mean(X, w):
    """Weighted per-feature mean: the shift of the class moments."""
    return (w[:, None] * X).sum(dim=0) / torch.clamp(w.sum(), min=1e-12)


def _class_moments(X, onehot, mu):
    """Weighted per-class counts, means and variances about ``mu``:
    ``onehot`` is the (n, K) membership scaled by the sample weights.
    Returns (counts, theta, var, m1) with ``m1 = theta − mu``."""
    Xc = X - mu[None, :]
    counts = onehot.sum(dim=0)  # (K,)
    safe = torch.clamp(counts, min=1e-12)
    m1 = (onehot.T @ Xc) / safe[:, None]  # (K, d): E_k[x − mu]
    ex2 = (onehot.T @ (Xc * Xc)) / safe[:, None]
    var = torch.clamp(ex2 - m1 ** 2, min=0.0)
    return counts, mu[None, :] + m1, var, m1


def _joint_log_likelihood(X, theta, var, log_prior):
    """(n, K) joint log-likelihood
    ``log π_k − ½ Σ_d [log(2π σ²_kd) + (x_d − θ_kd)² / σ²_kd]``, one class
    at a time (no (n, K, d) intermediate)."""
    log_det = torch.sum(torch.log(2.0 * np.pi * var), dim=1)  # (K,)
    quad = torch.stack(
        [torch.sum((X - theta[k]) ** 2 / var[k], dim=1)
         for k in range(theta.shape[0])], dim=1)  # (n, K)
    return log_prior[None, :] - 0.5 * (log_det[None, :] + quad)


class GaussianNB(BaseEstimator):
    """Gaussian naive Bayes (the ``classes`` argument follows the
    reference's constructor). ``sigma_`` is the reference's name for
    ``var_``. Fits and likelihoods run on ``config.device``."""

    _estimator_type = "classifier"

    def __init__(self, priors=None, classes=None,
                 var_smoothing: float = 1e-9):
        self.priors = priors
        self.classes = classes
        self.var_smoothing = var_smoothing

    def fit(self, X, y=None, sample_weight=None):
        X = check_array(X)
        y = np.asarray(y)
        classes = (np.asarray(self.classes) if self.classes is not None
                   else np.unique(y))
        self.classes_ = classes
        # labels to positions in `classes`, which need not be sorted
        order = np.argsort(classes, kind="stable")
        sorted_classes = classes[order]
        pos = np.searchsorted(sorted_classes, y)
        in_range = pos < len(classes)
        if not in_range.all() or np.any(
                sorted_classes[np.where(in_range, pos, 0)] != y):
            raise ValueError("y contains labels not in `classes`")
        codes = order[pos]

        data = prepare_data(X, sample_weight=sample_weight,
                            device=resolve_device())
        codes_t = torch.as_tensor(codes, device=data.X.device)
        onehot = (torch.nn.functional.one_hot(codes_t, len(classes))
                  .to(torch.float32) * data.weights[:, None])
        mu = _global_mean(data.X, data.weights)
        moments = _class_moments(data.X, onehot, mu)
        counts, theta, var, m1 = (t.cpu().numpy().astype(np.float64)
                                  for t in moments)
        # scikit-learn's floor: var_smoothing times the largest POOLED
        # feature variance (a per-class one can be 0 on separable data),
        # from the per-class shifted moments by the law of total variance
        total_w = counts.sum()
        total_m1 = (counts[:, None] * m1).sum(0) / total_w
        total_e2 = (counts[:, None] * (var + m1 ** 2)).sum(0) / total_w
        total_var = np.maximum(total_e2 - total_m1 ** 2, 0.0)
        eps = (float(self.var_smoothing * total_var.max())
               if total_var.size else 0.0)
        self.epsilon_ = max(eps, float(np.finfo(np.float32).tiny))
        var += self.epsilon_

        self.class_count_ = counts
        self.theta_ = theta
        self.var_ = var
        self.sigma_ = var
        if self.priors is not None:
            priors = np.asarray(self.priors, dtype=np.float64)
            if len(priors) != len(classes):
                raise ValueError(
                    "Number of priors must match number of classes")
            if not np.isclose(priors.sum(), 1.0):
                raise ValueError("The sum of the priors should be 1.")
            if (priors < 0).any():
                raise ValueError("Priors must be non-negative.")
            self.class_prior_ = priors
        else:
            self.class_prior_ = self.class_count_ / self.class_count_.sum()
        return self

    def _jll(self, X):
        """The (n, K) joint log-likelihood, float32, on the host."""
        X = check_array(X)
        data = prepare_data(X, device=resolve_device())
        dev = data.X.device

        def f32(a):
            return torch.as_tensor(np.asarray(a, np.float32), device=dev)

        jll = _joint_log_likelihood(
            data.X, f32(self.theta_), f32(self.var_),
            torch.log(f32(self.class_prior_)))
        return jll.cpu().numpy()

    def predict(self, X):
        return self.classes_[np.argmax(self._jll(X), axis=1)]

    def predict_log_proba(self, X):
        from scipy.special import logsumexp as _logsumexp

        jll = self._jll(X)
        return jll - _logsumexp(jll, axis=1, keepdims=True)

    def predict_proba(self, X):
        return np.exp(self.predict_log_proba(X))

    def score(self, X, y):
        from dask_ml_tpu_torch.metrics import accuracy_score

        return accuracy_score(np.asarray(y), self.predict(X))


# -- the deprecated Partial* estimators, made on first access ---------------

#: Partial* name -> scikit-learn's class it wraps
_PARTIAL_BASES = {"PartialMultinomialNB": "sklearn.naive_bayes.MultinomialNB",
                  "PartialBernoulliNB": "sklearn.naive_bayes.BernoulliNB"}


def __getattr__(name):
    if name in _PARTIAL_BASES:
        from dask_ml_tpu_torch._partial import lazy_partial

        return lazy_partial(__name__, name, _PARTIAL_BASES[name],
                            _init_kwargs=["classes"], _fit_kwargs=[])
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

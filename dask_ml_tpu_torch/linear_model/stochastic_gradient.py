"""Deprecated Partial SGD estimators (counterpart of
``dask_ml_tpu/linear_model/stochastic_gradient.py``): scikit-learn's, on
the host; they need scikit-learn."""

from __future__ import annotations

from sklearn.linear_model import SGDClassifier as _SGDClassifier
from sklearn.linear_model import SGDRegressor as _SGDRegressor

from dask_ml_tpu_torch._partial import _BigPartialFitMixin, _copy_partial_doc


@_copy_partial_doc
class PartialSGDClassifier(_BigPartialFitMixin, _SGDClassifier):
    _init_kwargs = ["classes"]
    _fit_kwargs = []


@_copy_partial_doc
class PartialSGDRegressor(_BigPartialFitMixin, _SGDRegressor):
    pass

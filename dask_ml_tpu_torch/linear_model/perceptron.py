"""Deprecated Partial Perceptron (counterpart of
``dask_ml_tpu/linear_model/perceptron.py``): scikit-learn's, on the host;
it needs scikit-learn."""

from __future__ import annotations

from sklearn.linear_model import Perceptron as _Perceptron

from dask_ml_tpu_torch._partial import _BigPartialFitMixin, _copy_partial_doc


@_copy_partial_doc
class PartialPerceptron(_BigPartialFitMixin, _Perceptron):
    _init_kwargs = ["classes"]
    _fit_kwargs = []

"""Deprecated Partial MLP estimators (counterpart of
``dask_ml_tpu/neural_network.py``): scikit-learn's, on the host; they need
scikit-learn. The reference spells the names ``ParitalMLP*``: those
aliases stay for drop-in use."""

from __future__ import annotations

from sklearn.neural_network import MLPClassifier as _MLPClassifier
from sklearn.neural_network import MLPRegressor as _MLPRegressor

from dask_ml_tpu_torch._partial import _BigPartialFitMixin, _copy_partial_doc


@_copy_partial_doc
class PartialMLPClassifier(_BigPartialFitMixin, _MLPClassifier):
    _init_kwargs = ["classes"]
    _fit_kwargs = []


@_copy_partial_doc
class PartialMLPRegressor(_BigPartialFitMixin, _MLPRegressor):
    pass


ParitalMLPClassifier = PartialMLPClassifier
ParitalMLPRegressor = PartialMLPRegressor

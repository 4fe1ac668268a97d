"""Deprecated Partial PassiveAggressive estimators (counterpart of
``dask_ml_tpu/linear_model/passive_aggressive.py``): scikit-learn's, on
the host; they need scikit-learn."""

from __future__ import annotations

from sklearn.linear_model import PassiveAggressiveClassifier as _PAC
from sklearn.linear_model import PassiveAggressiveRegressor as _PAR

from dask_ml_tpu_torch._partial import _BigPartialFitMixin, _copy_partial_doc


@_copy_partial_doc
class PartialPassiveAggressiveClassifier(_BigPartialFitMixin, _PAC):
    _init_kwargs = ["classes"]
    _fit_kwargs = []


@_copy_partial_doc
class PartialPassiveAggressiveRegressor(_BigPartialFitMixin, _PAR):
    pass

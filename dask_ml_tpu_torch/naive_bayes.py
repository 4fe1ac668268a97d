"""Deprecated Partial naive Bayes estimators (the ``Partial*`` part of
``dask_ml_tpu/naive_bayes.py``; its ``GaussianNB`` is not ported yet):
scikit-learn's, on the host; they need scikit-learn."""

from __future__ import annotations

from sklearn.naive_bayes import BernoulliNB as _BernoulliNB
from sklearn.naive_bayes import MultinomialNB as _MultinomialNB

from dask_ml_tpu_torch._partial import _BigPartialFitMixin, _copy_partial_doc


@_copy_partial_doc
class PartialMultinomialNB(_BigPartialFitMixin, _MultinomialNB):
    _init_kwargs = ["classes"]
    _fit_kwargs = []


@_copy_partial_doc
class PartialBernoulliNB(_BigPartialFitMixin, _BernoulliNB):
    _init_kwargs = ["classes"]
    _fit_kwargs = []

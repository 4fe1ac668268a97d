"""Test doubles for the search driver (the counterpart of
``dask_ml_tpu/model_selection/utils_test.py``; dask-ml's
``model_selection/utils_test.py``).

Behavioural probes, not models: ``FailingClassifier`` drives the
``error_score`` / fit-failure paths, ``MockClassifier`` is a minimal
estimator, ``ScalingTransformer`` a trivial pipeline stage,
``CheckXClassifier`` asserts what data reaches ``fit``, and
``CountingTransformer`` counts the fits that really ran, so work sharing is
testable. They stand on the port's own estimator base
(:mod:`dask_ml_tpu_torch.base`), so they import without scikit-learn and
carry ``get_params`` / ``set_params`` for ``clone``; the classifiers declare
``_estimator_type = "classifier"``, which is what
:func:`~dask_ml_tpu_torch.base.is_classifier` reads.
"""

from __future__ import annotations

import threading

import numpy as np
from dask_ml_tpu_torch.base import BaseEstimator, TransformerMixin


class MockClassifier(BaseEstimator):
    """Trivial classifier recording what it saw
    (reference: utils_test.py:12-45)."""

    _estimator_type = "classifier"

    def __init__(self, foo_param=0):
        self.foo_param = foo_param

    def fit(self, X, y=None):
        self.classes_ = np.unique(np.asarray(y)) if y is not None else None
        self.n_features_in_ = np.asarray(X).shape[1]
        return self

    def predict(self, X):
        return np.zeros(np.asarray(X).shape[0], dtype=np.int64)

    def score(self, X=None, y=None):
        return 1.0 if self.foo_param > 1 else 0.0


class ScalingTransformer(BaseEstimator, TransformerMixin):
    """Multiply by a factor (reference: utils_test.py:48-56)."""

    def __init__(self, factor=1.0):
        self.factor = factor

    def fit(self, X, y=None):
        self.factor_ = self.factor
        return self

    def transform(self, X):
        return np.asarray(X) * self.factor_


class CountingTransformer(ScalingTransformer):
    """ScalingTransformer that counts actual fit executions across threads —
    the probe for prefix-sharing (one fit per distinct config, not per
    candidate)."""

    _lock = threading.Lock()
    n_fits = 0  # class-level: survives the driver's deepcopies

    def fit(self, X, y=None):
        with CountingTransformer._lock:
            CountingTransformer.n_fits += 1
        return super().fit(X, y)

    @classmethod
    def reset(cls):
        with cls._lock:
            cls.n_fits = 0


class FailingClassifier(BaseEstimator):
    """Raises inside fit when parameter == FAILING_PARAMETER
    (reference: utils_test.py:76-93)."""

    _estimator_type = "classifier"

    FAILING_PARAMETER = 2

    def __init__(self, parameter=None):
        self.parameter = parameter

    def fit(self, X, y=None):
        if self.parameter == FailingClassifier.FAILING_PARAMETER:
            raise ValueError("Failing classifier failed as required")
        self.classes_ = np.unique(np.asarray(y)) if y is not None else None
        return self

    def predict(self, X):
        return np.zeros(np.asarray(X).shape[0], dtype=np.int64)

    def score(self, X=None, y=None):
        return 0.0


class FailingTransformer(BaseEstimator, TransformerMixin):
    """Transformer that raises inside fit when parameter ==
    FAILING_PARAMETER — drives FIT_FAILURE propagation through FeatureUnion
    expansion (reference: test_model_selection.py:466-537 uses
    FailingClassifier inside composite grids the same way)."""

    FAILING_PARAMETER = 2

    def __init__(self, parameter=None):
        self.parameter = parameter

    def fit(self, X, y=None):
        if self.parameter == FailingTransformer.FAILING_PARAMETER:
            raise ValueError("Failing transformer failed as required")
        return self

    def transform(self, X):
        return np.asarray(X)


class CheckXClassifier(BaseEstimator):
    """Asserts the X it receives equals ``expected_X``
    (reference: utils_test.py:59-73)."""

    _estimator_type = "classifier"

    def __init__(self, expected_X=None):
        self.expected_X = expected_X

    def fit(self, X, y=None):
        assert np.array_equal(np.asarray(X), np.asarray(self.expected_X))
        self.classes_ = np.unique(np.asarray(y))
        return self

    def predict(self, X):
        return np.zeros(np.asarray(X).shape[0], dtype=np.int64)

    def score(self, X=None, y=None):
        return 1.0


class CheckingClassifier(BaseEstimator):
    """Probe classifier asserting properties of X/y/fit_params at fit and
    predict time — for testing that pipelines, CV, and meta-estimators do
    not alter their inputs (reference: utils_test.py:137-175; the test
    contract, not the implementation, is what is mirrored)."""

    _estimator_type = "classifier"

    def __init__(self, check_y=None, check_X=None, foo_param=0,
                 expected_fit_params=None):
        self.check_y = check_y
        self.check_X = check_X
        self.foo_param = foo_param
        self.expected_fit_params = expected_fit_params

    def fit(self, X, y, **fit_params):
        assert len(X) == len(y)
        if self.check_X is not None:
            assert self.check_X(X)
        if self.check_y is not None:
            assert self.check_y(y)
        self.classes_ = np.unique(np.asarray(y))
        if self.expected_fit_params:
            missing = set(self.expected_fit_params) - set(fit_params)
            assert not missing, (
                f"Expected fit parameter(s) {sorted(missing)} not seen."
            )
            for key, value in fit_params.items():
                assert len(value) == len(X), (
                    f"Fit parameter {key} has length {len(value)}; "
                    f"expected {len(X)}."
                )
        return self

    def predict(self, X):
        if self.check_X is not None:
            assert self.check_X(X)
        return self.classes_[np.zeros(len(np.asarray(X)), dtype=np.int64)]

    def score(self, X=None, y=None):
        # the reference scores foo_param > 1 as 1. vs 0. via its mock
        # convention; keep that shape so grid tests can rank on foo_param
        return 1.0 if self.foo_param > 1 else 0.0

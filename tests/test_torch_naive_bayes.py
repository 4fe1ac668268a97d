"""The PyTorch port's GaussianNB held against the JAX package (and
scikit-learn), on the CPU, on the JAX tests' inputs.

Both packages take the class moments in float32 about the global mean
and finish in float64 on the host; their sums run in other orders, so
``theta_``, ``class_prior_``, ``class_count_`` and ``predict_proba``
agree within rtol 1e-5 (through ``utils.testing.assert_estimator_equal``)
and predictions exactly. ``var_`` (and ``sigma_``) is held within rtol
3e-5: it is ``E[(x − μ)²] − (θ − μ)²`` in float32, where on the blobs a
class mean lies ≈ 10 standard deviations from the global mean, so the
subtraction cancels about two digits and each package's ``var_`` lies
≈ 1.4e-5 (relative) from the float64 fit (measured: JAX 1.38e-5, the
port 1.35e-5, in other directions).
"""

import numpy as np
import pytest
from sklearn.naive_bayes import GaussianNB as SKGaussianNB

from dask_ml_tpu.naive_bayes import GaussianNB as JGaussianNB
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch.naive_bayes import GaussianNB
from dask_ml_tpu_torch.utils.testing import assert_estimator_equal

RTOL = 1e-5
VAR_RTOL = 3e-5


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture
def Xy():
    from sklearn.datasets import make_blobs

    X, y = make_blobs(n_samples=300, n_features=5, centers=3, random_state=0)
    return X.astype(np.float32), y


def _both(X, y, sample_weight=None, **kw):
    ours = GaussianNB(**kw).fit(X, y, sample_weight=sample_weight)
    theirs = JGaussianNB(**kw).fit(X, y, sample_weight=sample_weight)
    return ours, theirs


def _assert_same(ours, theirs, X, atol=1e-6):
    assert_estimator_equal(ours, theirs, exclude=("var_", "sigma_"),
                           rtol=RTOL, atol=atol)
    np.testing.assert_allclose(ours.var_, theirs.var_, rtol=VAR_RTOL)
    np.testing.assert_array_equal(ours.predict(X), theirs.predict(X))
    np.testing.assert_allclose(ours.predict_proba(X),
                               theirs.predict_proba(X), rtol=RTOL,
                               atol=1e-6)


def test_matches_jax(Xy):
    X, y = Xy
    ours, theirs = _both(X, y)
    _assert_same(ours, theirs, X)
    np.testing.assert_allclose(ours.predict_log_proba(X),
                               theirs.predict_log_proba(X), rtol=RTOL,
                               atol=1e-4)
    assert ours.score(X, y) == theirs.score(X, y)


def test_matches_sklearn(Xy):
    X, y = Xy
    a, b = GaussianNB().fit(X, y), SKGaussianNB().fit(X, y)
    np.testing.assert_array_equal(a.classes_, b.classes_)
    np.testing.assert_allclose(a.theta_, b.theta_, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(a.var_, b.var_, rtol=1e-3, atol=1e-4)
    np.testing.assert_allclose(a.class_prior_, b.class_prior_, rtol=1e-6)
    np.testing.assert_array_equal(a.predict(X), b.predict(X))
    np.testing.assert_allclose(a.predict_proba(X), b.predict_proba(X),
                               atol=1e-3)


def test_sigma_alias(Xy):
    X, y = Xy
    nb = GaussianNB().fit(X, y)
    np.testing.assert_array_equal(nb.sigma_, nb.var_)


def test_priors_and_classes_params(Xy):
    X, y = Xy
    priors = np.array([0.5, 0.25, 0.25])
    ours, theirs = _both(X, y, priors=priors)
    _assert_same(ours, theirs, X)
    np.testing.assert_array_equal(
        ours.predict(X), SKGaussianNB(priors=priors).fit(X, y).predict(X))
    nb = GaussianNB(classes=[0, 1, 2]).fit(X, y)
    np.testing.assert_array_equal(nb.classes_, [0, 1, 2])
    with pytest.raises(ValueError, match="priors"):
        GaussianNB(priors=np.array([0.5, 0.5])).fit(X, y)
    with pytest.raises(ValueError, match="labels"):
        GaussianNB(classes=[0, 1]).fit(X, y)


def test_sample_weight_matches_jax(Xy):
    X, y = Xy
    w = np.random.RandomState(0).uniform(0.5, 2.0, len(y))
    ours, theirs = _both(X, y, sample_weight=w)
    _assert_same(ours, theirs, X)
    b = SKGaussianNB().fit(X, y, sample_weight=w)
    np.testing.assert_allclose(ours.theta_, b.theta_, rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(ours.var_, b.var_, rtol=1e-3, atol=1e-4)


def test_zero_weight_rows_are_ignored(Xy):
    X, y = Xy
    w = np.ones(len(y))
    w[:40] = 0.0
    a = GaussianNB().fit(X, y, sample_weight=w)
    b = GaussianNB().fit(X[40:], y[40:])
    np.testing.assert_allclose(a.theta_, b.theta_, rtol=RTOL, atol=1e-6)
    np.testing.assert_allclose(a.var_, b.var_, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(a.class_count_, b.class_count_)


def test_constant_feature():
    rng = np.random.RandomState(0)
    X = rng.randn(100, 3).astype(np.float32)
    X[:, 1] = 7.0
    y = (X[:, 0] > 0).astype(int)
    ours, theirs = _both(X, y)
    assert np.isfinite(ours._jll(X)).all()
    _assert_same(ours, theirs, X)


def test_perfectly_separable_epsilon():
    rng = np.random.RandomState(0)
    X = rng.randn(120, 2).astype(np.float32)
    y = np.repeat([0, 1], 60)
    X[:, 1] = y
    ours, theirs = _both(X, y)
    assert ours.epsilon_ > 0
    assert np.isfinite(ours._jll(X)).all()
    np.testing.assert_allclose(ours.epsilon_, theirs.epsilon_, rtol=RTOL)
    np.testing.assert_array_equal(ours.predict(X),
                                  SKGaussianNB().fit(X, y).predict(X))


def test_unsorted_classes_param(Xy):
    X, y = Xy
    ours, theirs = _both(X, y, classes=[2, 0, 1])
    np.testing.assert_array_equal(ours.classes_, [2, 0, 1])
    _assert_same(ours, theirs, X)
    np.testing.assert_array_equal(ours.predict(X),
                                  SKGaussianNB().fit(X, y).predict(X))


def test_large_mean_variance_stability():
    """The two-pass moments keep the variance where |mean| ≫ std (a
    single-pass E[x²] − θ² in float32 would cancel it to 0)."""
    rng = np.random.RandomState(0)
    n = 400
    X = rng.randn(n, 3).astype(np.float32)
    X[:, 0] += 1e4
    X[:, 1] += 3e3
    y = (rng.rand(n) > 0.5).astype(int)
    ours, theirs = _both(X, y)
    b = SKGaussianNB().fit(X, y)
    np.testing.assert_allclose(ours.var_, b.var_, rtol=5e-2, atol=1e-3)
    np.testing.assert_allclose(ours.var_, theirs.var_, rtol=1e-3)
    assert np.isfinite(ours.predict_log_proba(X)).all()
    assert (ours.predict(X) == b.predict(X)).mean() > 0.95
    assert ours.epsilon_ > 0


def test_all_constant_features_finite():
    X = np.full((40, 2), 7.0, dtype=np.float32)
    y = np.r_[np.zeros(20), np.ones(20)].astype(int)
    m = GaussianNB().fit(X, y)
    assert m.epsilon_ > 0
    assert np.isfinite(m._jll(X)).all()


def test_invalid_priors_rejected():
    rng = np.random.RandomState(0)
    X = rng.uniform(size=(100, 4)).astype(np.float32)
    y = (rng.uniform(size=100) > 0.5).astype(np.int32)
    with pytest.raises(ValueError, match="sum of the priors"):
        GaussianNB(priors=[0.9, 0.9]).fit(X, y)
    with pytest.raises(ValueError, match="non-negative"):
        GaussianNB(priors=[1.5, -0.5]).fit(X, y)


def test_string_labels_and_params_match_jax(Xy):
    X, y = Xy
    names = np.array(["a", "b", "c"])[y]
    ours, theirs = _both(X, names)
    np.testing.assert_array_equal(ours.predict(X), theirs.predict(X))
    assert ours.get_params() == theirs.get_params()
    from dask_ml_tpu_torch.base import is_classifier

    assert is_classifier(ours)


def test_assert_estimator_equal_reports_a_difference(Xy):
    X, y = Xy
    a = GaussianNB().fit(X, y)
    b = GaussianNB().fit(X[:200], y[:200])
    with pytest.raises(AssertionError, match="theta_|class_count_"):
        assert_estimator_equal(a, b)
    with pytest.raises(AssertionError, match="fitted attributes"):
        assert_estimator_equal(a, GaussianNB())
    assert_estimator_equal(a, a, exclude="epsilon_")

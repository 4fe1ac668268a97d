"""The estimator contract of ``tests/test_estimator_contract.py`` held on
the port's estimators, on the CPU, with the port's own ``clone``
(``dask_ml_tpu_torch.base``; the card's machine has no scikit-learn): the
params round trip, clone before the fit, ``fit`` returning self, learned
state in trailing-underscore attributes, the pickle round trip of a fitted
estimator (its predictions or transform equal after it), and the refit of
a clone of a fitted estimator (unfitted, then the same learned scalars).
One parametrised test over both ``LogisticRegression`` solvers,
``GaussianNB``, ``LinearRegression``, ``PoissonRegression``, the four
k-means families (``KMeans`` full and sketched, ``MiniBatchKMeans``,
``KernelKMeans``), ``SpectralClustering``, ``PCA``, ``TruncatedSVD`` and
the four dense scalers.
"""

import pickle

import numpy as np
import pytest

from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch.base import clone
from dask_ml_tpu_torch.cluster import (
    KernelKMeans,
    KMeans,
    MiniBatchKMeans,
    SpectralClustering,
)
from dask_ml_tpu_torch.decomposition import PCA, TruncatedSVD
from dask_ml_tpu_torch.linear_model import (
    LinearRegression,
    LogisticRegression,
    PoissonRegression,
)
from dask_ml_tpu_torch.naive_bayes import GaussianNB
from dask_ml_tpu_torch.preprocessing import (
    MinMaxScaler,
    QuantileTransformer,
    RobustScaler,
    StandardScaler,
)

CLASSIFIERS = [
    lambda: LogisticRegression(solver="newton", max_iter=15),
    lambda: LogisticRegression(solver="lbfgs", max_iter=15),
    lambda: GaussianNB(),
]
REGRESSORS = [
    lambda: LinearRegression(solver="newton", max_iter=15),
    lambda: PoissonRegression(solver="newton", max_iter=15),
]
UNSUPERVISED = [
    lambda: KMeans(n_clusters=3, random_state=0, max_iter=20),
    lambda: KMeans(n_clusters=3, algorithm="sketched", random_state=0,
                   max_iter=20),
    lambda: MiniBatchKMeans(n_clusters=3, random_state=0, batch_size=32,
                            max_iter=5),
    lambda: KernelKMeans(n_clusters=2, n_components=20, random_state=0),
    lambda: SpectralClustering(n_clusters=2, n_components=20,
                               random_state=0),
    lambda: PCA(n_components=2),
    lambda: TruncatedSVD(n_components=2),
    lambda: StandardScaler(),
    lambda: MinMaxScaler(),
    lambda: RobustScaler(),
    lambda: QuantileTransformer(n_quantiles=20),
]

ALL = CLASSIFIERS + REGRESSORS + UNSUPERVISED
IDS = [f().__class__.__name__ + f"-{i}" for i, f in enumerate(ALL)]


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


def _data_for(est, rng):
    X = rng.randn(80, 4).astype(np.float32)
    if isinstance(est, (LogisticRegression, GaussianNB)):
        return X, (X[:, 0] > 0).astype(np.int32)
    if isinstance(est, PoissonRegression):
        return X, rng.poisson(2.0, 80).astype(np.float32)
    if isinstance(est, LinearRegression):
        return X, (X @ rng.randn(4)).astype(np.float32)
    return X, None


def _learned(est) -> list:
    return [k for k in vars(est) if k.endswith("_") and not k.startswith("_")]


@pytest.mark.parametrize("factory", ALL, ids=IDS)
def test_estimator_contract(factory):
    est = factory()

    # the params round trip: construction stores its arguments unmodified
    params = est.get_params(deep=False)
    est2 = est.__class__(**params)
    assert est2.get_params(deep=False) == params
    assert est.set_params(**params) is est

    # clone before the fit
    c = clone(est)
    assert type(c) is type(est) and c is not est
    assert c.get_params(deep=False) == params

    X, y = _data_for(est, np.random.RandomState(0))
    fitted = est.fit(X) if y is None else est.fit(X, y)
    assert fitted is est  # fit returns self
    learned = _learned(est)
    assert learned, f"{est!r} exposes no fitted attributes"

    # a fitted estimator pickles and behaves the same after the round trip
    est_rt = pickle.loads(pickle.dumps(est))
    assert sorted(_learned(est_rt)) == sorted(learned)
    for method in ("predict", "transform"):
        if hasattr(est, method):
            a = getattr(est, method)(X[:16])
            b = getattr(est_rt, method)(X[:16])
            np.testing.assert_allclose(
                np.asarray(a, dtype=np.float64),
                np.asarray(b, dtype=np.float64), rtol=1e-6)
            break

    # a clone of a fitted estimator is unfitted and refits the same
    c2 = clone(est)
    assert not _learned(c2)
    refit = c2.fit(X) if y is None else c2.fit(X, y)
    assert refit is c2
    for k in learned:
        va, vb = getattr(est, k), getattr(refit, k, None)
        if isinstance(va, (int, float, np.floating)) and k != "n_iter_":
            assert vb == pytest.approx(va, rel=1e-3, abs=1e-5), k

"""The PyTorch port's MiniBatchKMeans and k-means module functions held
against the JAX package, on the CPU.

Tolerances and their reasons:

- ``partial_fit`` from the same numpy batch and the same initial centers
  (``init=`` an array): centers within rtol 1e-5 and the same counts. The
  per-center sums are a one-hot product in both packages, which may add
  in other orders;
- ``fit`` draws its batches from ``torch.Generator`` (Philox), which
  cannot repeat ``jax.random``: it is held to the JAX tests' quality gate
  (inertia within 10 % of a full KMeans fit), to seed determinism (bit
  for bit) and to zero-weight rows being ignored;
- ``k_means(init=ndarray)``, ``compute_inertia`` and ``evaluate_cost``:
  the same labels, centers and inertia within rtol 1e-5.
"""

import sys

import numpy as np
import pytest
import torch

from dask_ml_tpu import cluster as jcluster
from dask_ml_tpu.cluster import MiniBatchKMeans as JMiniBatchKMeans
from dask_ml_tpu.cluster import minibatch as jmb
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch import cluster as tcluster
from dask_ml_tpu_torch.cluster import KMeans, MiniBatchKMeans
from dask_ml_tpu_torch.cluster import minibatch as tmb
from dask_ml_tpu_torch.models import kmeans as core
from dask_ml_tpu_torch.utils.validation import check_random_state

RTOL = 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


def _blobs(n=4000, d=5, k=4, seed=0, std=0.6):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-10, 10, (k, d))
    y = rng.randint(0, k, n)
    X = (centers[y] + std * rng.randn(n, d)).astype(np.float32)
    return X, y


@pytest.fixture(scope="module")
def blobs():
    return _blobs()


def _init_rows(X, k, seed=3):
    return X[np.random.RandomState(seed).choice(len(X), k, replace=False)]


# ---------------------------------------------------------------------------
# partial_fit and the update against the JAX package
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("weighted", [False, True])
def test_partial_fit_matches_jax(blobs, weighted):
    X, _ = blobs
    c0 = _init_rows(X, 4)
    rng = np.random.RandomState(5)
    ours = MiniBatchKMeans(n_clusters=4, init=c0)
    theirs = JMiniBatchKMeans(n_clusters=4, init=c0)
    for lo in (0, 700, 1500, 2600):
        batch = X[lo:lo + 500]
        w = (rng.uniform(0, 2, len(batch)).astype(np.float32)
             if weighted else None)
        ours.partial_fit(batch, sample_weight=w)
        theirs.partial_fit(batch, sample_weight=w)
        np.testing.assert_allclose(ours.cluster_centers_,
                                   theirs.cluster_centers_, rtol=RTOL,
                                   atol=1e-5)
        np.testing.assert_allclose(ours.counts_, theirs.counts_, rtol=RTOL)
    assert ours.n_iter_ == theirs.n_iter_ == 4
    assert ours.cluster_centers_.dtype == np.float32
    np.testing.assert_array_equal(ours.predict(X), theirs.predict(X))


def test_update_int_valued_matches_jax_bitwise():
    """On integer-valued rows and unit weights the labels, sums and counts
    are exact in both packages, so one update gives the same bits."""
    rng = np.random.RandomState(8)
    X = rng.randint(-6, 7, (257, 6)).astype(np.float32)
    w = np.ones(257, np.float32)
    c0 = X[[0, 50, 100, 200, 256]].copy() + 0.5
    v0 = np.array([0, 3, 10, 1, 7], np.float32)
    tc, tv, tl = tmb._minibatch_update(
        torch.as_tensor(X), torch.as_tensor(w), torch.as_tensor(c0),
        torch.as_tensor(v0))
    jc, jv, jl = jmb._minibatch_update(X, w, c0, v0)
    np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-6)


def test_assignment_routes_through_fused_argmin_min(blobs, monkeypatch):
    X, _ = blobs
    calls = {"n": 0}
    orig = tmb.fused_argmin_min

    def spy(*a, **k):
        calls["n"] += 1
        return orig(*a, **k)

    monkeypatch.setattr(tmb, "fused_argmin_min", spy)
    mb = MiniBatchKMeans(n_clusters=4, batch_size=256, max_iter=1,
                         random_state=0).fit(X)
    assert calls["n"] == mb.n_iter_ == -(-len(X) // 256)


# ---------------------------------------------------------------------------
# fit: the JAX tests' gates
# ---------------------------------------------------------------------------


def test_converges_near_full_kmeans(blobs):
    X, _ = blobs
    mb = MiniBatchKMeans(n_clusters=4, batch_size=512, max_iter=5,
                         random_state=0).fit(X)
    km = KMeans(n_clusters=4, random_state=0).fit(X)
    assert mb.inertia_ <= km.inertia_ * 1.10
    assert mb.labels_.shape == (4000,) and mb.labels_.dtype == np.int32
    assert mb.counts_.sum() == pytest.approx(mb.n_iter_ * 512)
    assert mb.n_iter_ == 5 * 8


def test_predict_is_nearest_center(blobs):
    from sklearn.metrics.pairwise import euclidean_distances as sk_euclidean

    X, _ = blobs
    mb = MiniBatchKMeans(n_clusters=4, batch_size=512, max_iter=3,
                         random_state=0).fit(X)
    d = sk_euclidean(X, mb.cluster_centers_)
    np.testing.assert_array_equal(mb.predict(X), d.argmin(axis=1))
    np.testing.assert_array_equal(mb.predict(X), mb.labels_)
    np.testing.assert_allclose(mb.transform(X), d, rtol=1e-3, atol=1e-3)
    assert mb.score(X) == pytest.approx(-mb.inertia_, rel=1e-5)


def test_partial_fit_streams_state(blobs):
    X, _ = blobs
    mb = MiniBatchKMeans(n_clusters=4, random_state=0)
    mb.partial_fit(X[:1000])
    c1 = mb.cluster_centers_.copy()
    v1 = mb.counts_.sum()
    mb.partial_fit(X[1000:2000])
    assert mb.n_iter_ == 2
    assert mb.counts_.sum() == pytest.approx(v1 + 1000)
    assert not np.array_equal(c1, mb.cluster_centers_)
    fresh = MiniBatchKMeans(n_clusters=4, random_state=0)
    fresh.partial_fit(X[1000:2000])
    assert not np.array_equal(fresh.cluster_centers_, mb.cluster_centers_)


def test_sample_weight_zero_rows_ignored(blobs):
    X, _ = blobs
    rng = np.random.RandomState(1)
    outliers = rng.uniform(60, 70, size=(30, X.shape[1])).astype(np.float32)
    Xo = np.vstack([X, outliers])
    w = np.ones(len(Xo), dtype=np.float32)
    w[len(X):] = 0.0
    mb = MiniBatchKMeans(n_clusters=4, batch_size=512, max_iter=3,
                         random_state=0).fit(Xo, sample_weight=w)
    assert np.abs(mb.cluster_centers_).max() < 30.0


@pytest.mark.parametrize("init", ["k-means||", "random"])
def test_seed_determinism(blobs, init):
    X, _ = blobs
    a = MiniBatchKMeans(n_clusters=3, init=init, batch_size=256, max_iter=2,
                        random_state=7).fit(X)
    b = MiniBatchKMeans(n_clusters=3, init=init, batch_size=256, max_iter=2,
                        random_state=7).fit(X)
    np.testing.assert_array_equal(a.cluster_centers_, b.cluster_centers_)
    np.testing.assert_array_equal(a.counts_, b.counts_)
    np.testing.assert_array_equal(a.labels_, b.labels_)
    assert a.inertia_ == b.inertia_
    c = MiniBatchKMeans(n_clusters=3, init=init, batch_size=256, max_iter=2,
                        random_state=8).fit(X)
    assert not np.array_equal(a.cluster_centers_, c.cluster_centers_)


def test_validation_and_unfitted(blobs):
    X, _ = blobs
    with pytest.raises(ValueError):
        MiniBatchKMeans(n_clusters=0).fit(X)
    with pytest.raises(ValueError):
        MiniBatchKMeans(batch_size=0).fit(X)
    with pytest.raises(ValueError, match="n_samples"):
        MiniBatchKMeans(n_clusters=10).fit(X[:5])
    with pytest.raises(ValueError, match="first partial_fit"):
        MiniBatchKMeans(n_clusters=10).partial_fit(X[:5])
    with pytest.raises(AttributeError, match="fit"):
        MiniBatchKMeans().predict(X)
    mb = MiniBatchKMeans(n_clusters=4, compute_labels=False,
                         random_state=0).fit(X)
    assert not hasattr(mb, "labels_")


def test_params_match_jax_and_partial_wrapper():
    assert (set(MiniBatchKMeans._get_param_names())
            == set(JMiniBatchKMeans().get_params()) | {"device"})
    import pickle

    cls = tcluster.PartialMiniBatchKMeans
    assert cls is tmb.PartialMiniBatchKMeans
    assert pickle.loads(pickle.dumps(cls)) is cls
    with pytest.warns(FutureWarning, match="Incremental"):
        est = cls(n_clusters=3, random_state=0, n_init=1)
    X, _ = _blobs(n=600)
    est.fit(X, block_size=200)
    assert est.cluster_centers_.shape == (3, 5)


@pytest.mark.parametrize("module,name", [
    ("cluster.minibatch", "PartialMiniBatchKMeans"),
    ("cluster", "PartialMiniBatchKMeans"),
    ("naive_bayes", "PartialMultinomialNB"),
    ("naive_bayes", "PartialBernoulliNB")])
def test_partial_classes_are_made_once_on_access(module, name):
    import importlib
    import pickle

    mod = importlib.import_module(f"dask_ml_tpu_torch.{module}")
    cls = getattr(mod, name)
    assert getattr(mod, name) is cls
    assert cls.__qualname__ == name
    assert pickle.loads(pickle.dumps(cls)) is cls
    assert cls.__doc__.startswith("Deprecated blockwise")
    with pytest.raises(AttributeError, match="PartialNothing"):
        getattr(mod, "PartialNothing")


# ---------------------------------------------------------------------------
# the k-means module functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("algorithm", ["full", "bounded"])
def test_k_means_with_init_array_matches_jax(blobs, algorithm):
    X, _ = blobs
    c0 = _init_rows(X, 4, seed=11)
    ours = tcluster.k_means(X, 4, init=c0, algorithm=algorithm,
                            return_n_iter=True)
    theirs = jcluster.k_means(X, 4, init=c0, algorithm=algorithm,
                                  return_n_iter=True)
    np.testing.assert_allclose(ours[0], theirs[0], rtol=RTOL, atol=1e-5)
    np.testing.assert_array_equal(ours[1], np.asarray(theirs[1]))
    np.testing.assert_allclose(ours[2], theirs[2], rtol=RTOL)
    assert ours[3] == theirs[3]
    assert len(tcluster.k_means(X, 4, init=c0)) == 3


def test_compute_inertia_and_evaluate_cost_match_jax(blobs):
    X, _ = blobs
    km = KMeans(n_clusters=4, random_state=0).fit(X)
    ours = tcluster.compute_inertia(X, km.labels_, km.cluster_centers_)
    theirs = jcluster.compute_inertia(X, km.labels_, km.cluster_centers_)
    np.testing.assert_allclose(ours, theirs, rtol=RTOL)
    np.testing.assert_allclose(ours, km.inertia_, rtol=RTOL)
    cost = tcluster.evaluate_cost(X, km.cluster_centers_)
    np.testing.assert_allclose(
        cost, jcluster.evaluate_cost(X, km.cluster_centers_), rtol=RTOL)
    np.testing.assert_allclose(cost, km.inertia_, rtol=RTOL)
    # squared, never negative: the deliberate deviation from the reference
    wrong = (km.labels_ + 1) % 4
    assert tcluster.compute_inertia(X, wrong, km.cluster_centers_) > ours


@pytest.mark.parametrize("fn", ["k_init", "init_scalable", "init_random"])
def test_init_functions_shape_and_determinism(blobs, fn):
    X, y = blobs
    f = getattr(tcluster, fn)
    a, b = f(X, 4, random_state=2), f(X, 4, random_state=2)
    assert a.shape == (4, 5) and a.dtype == np.float32
    np.testing.assert_array_equal(a, b)
    if fn != "init_random":
        # k-means|| lands one center on each well-separated blob
        truth = np.stack([X[y == j].mean(0) for j in range(4)])
        near = np.linalg.norm(a[:, None] - truth[None], axis=2).argmin(1)
        assert sorted(near) == [0, 1, 2, 3]
    else:
        assert all((X == row).all(1).any() for row in a)


def test_k_init_passes_an_array_and_init_pp(blobs, monkeypatch):
    X, _ = blobs
    c0 = _init_rows(X, 4)
    np.testing.assert_array_equal(tcluster.k_init(X, 4, init=c0), c0)
    pp = tcluster.init_pp(X, 4, random_state=0)
    assert pp.shape == (4, 5)
    assert all((X == row).all(1).any() for row in pp)
    monkeypatch.setitem(sys.modules, "sklearn.cluster", None)
    with pytest.raises(ImportError, match="scikit-learn"):
        tcluster.init_pp(X, 4, random_state=0)


def test_measure_init_phases_reports_each_phase(blobs):
    X, _ = blobs
    Xt = torch.as_tensor(X)
    w = torch.ones(len(X))
    rep = core.measure_init_phases(Xt, w, 4, check_random_state(0,
                                                                device="cpu"))
    assert set(rep) == {"seconds", "bytes_moved", "effective_gbps",
                        "fused", "round_skip_ratio", "n_rounds", "n_cand"}
    phases = {"seed", "rounds", "weights", "finish"}
    assert set(rep["seconds"]) == set(rep["bytes_moved"]) == phases
    assert all(v > 0 for v in rep["seconds"].values())
    assert rep["fused"] == {"rounds": False, "weights": False}
    assert 1 <= rep["n_rounds"] <= 20 and rep["n_cand"] >= 4
    assert 0.0 <= rep["round_skip_ratio"] <= 1.0
    n, d = X.shape
    assert rep["bytes_moved"]["seed"] == n * d * 4 + 4 * n
    assert rep["bytes_moved"]["rounds"] == rep["n_rounds"] * (
        n * d * 4 + 12 * n)

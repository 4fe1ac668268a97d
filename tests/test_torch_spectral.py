"""The PyTorch port's Nyström estimators (``SpectralClustering``,
``KernelKMeans``) held against the JAX package, on the CPU.

Both packages draw the same landmarks (one numpy ``RandomState`` draws them
and the inner KMeans' seed), so the landmark rows are equal bit for bit.
Tolerances and their reasons:

- ``eigenvalues_`` (the singular values of the normalized landmark block):
  the same f32 algebra through LAPACK here and XLA there, rtol 1e-4;
- the embedding: the SVD's column signs are the solver's own, so each
  column of the port's embedding is aligned to the JAX one's sign (from the
  extension map's columns) and then held within atol 1e-4;
- labels from a shared explicit init (``kmeans_params={"init": C0}``, the
  port's ``C0`` aligned the same way): equal;
- the pseudo-inverse: jax's cutoff (``10·max(m, n)·eps·s_max``), within
  1e-4 of the largest entry of ``jnp.linalg.pinv`` on a block built with a
  singular value between the two cuts (``torch.linalg.pinv``'s default
  keeps it and lands far away), and the degree functional ``A⁺ colsum`` of
  an rbf block within 1e-2 of its largest entry (f32 solvers on an
  ill-conditioned block); the landmarks' degrees ``d^-½``, which the
  embedding reads, rtol 1e-4;
- the XOR gate of the JAX kernel k-means test at its size: ARI ≥ 0.9 with
  the dense KMeans control below 0.5.
"""

import numpy as np
import pytest
import torch
from sklearn.datasets import make_blobs
from sklearn.metrics import adjusted_rand_score

import jax.numpy as jnp

from dask_ml_tpu import cluster as jcluster
from dask_ml_tpu.cluster import spectral as jspectral
from dask_ml_tpu.ops import pairwise as jpairwise
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch import cluster as tcluster
from dask_ml_tpu_torch.cluster import kernel_kmeans as tkk
from dask_ml_tpu_torch.cluster import spectral as tspectral
from dask_ml_tpu_torch.convert import (kernel_kmeans_from_numpy,
                                       spectral_from_numpy)
from dask_ml_tpu_torch.ops.pairwise import rbf_kernel


@pytest.fixture(autouse=True)
def on_cpu():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    with config_context(device="cpu"):
        yield
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision(prec)


@pytest.fixture(scope="module")
def blobs():
    X, y = make_blobs(n_samples=500, n_features=4, centers=3,
                      cluster_std=0.5, random_state=0)
    X = (X - X.mean(0)) / X.std(0)
    return X.astype(np.float32), y


def _xor(n=1024, seed=0):
    """Four gaussian blobs at (±2, ±2); class = sign(x1·x2)."""
    rng = np.random.RandomState(seed)
    signs = rng.randint(0, 2, (n, 2)) * 2 - 1
    X = (signs * 2.0 + rng.randn(n, 2) * 0.6).astype(np.float32)
    y = (signs[:, 0] * signs[:, 1] > 0).astype(np.int32)
    return X, y


_SC = dict(n_clusters=3, n_components=50, gamma=None, random_state=0)
_XOR = dict(n_clusters=2, n_components=128, affinity="polynomial", degree=2,
            coef0=1.0, gamma=0.5, random_state=5)


def _jax_embedding(est, X):
    ext = tuple(jnp.asarray(e) for e in est._extension_)
    C = jpairwise.pairwise_kernels(jnp.asarray(X),
                                   jnp.asarray(est._landmarks_),
                                   metric=est.affinity,
                                   **est._kernel_params())
    scale = np.float32(np.sqrt(est.n_components / est._n_fit_rows_))
    return np.asarray(jspectral._nystrom_extend(C, *ext, scale))


def _port_embedding(est, X):
    return est._extend_rows(torch.as_tensor(X)).numpy()


def _signs(port_map, jax_map):
    """Per column, +1 or -1 so that the port's column follows the JAX
    one's."""
    s = np.sign((np.asarray(port_map) * np.asarray(jax_map)).sum(0))
    return np.where(s == 0, 1.0, s).astype(np.float32)


@pytest.fixture(scope="module")
def sc_pair(blobs):
    X, _ = blobs
    with config_context(device="cpu"):
        t = tcluster.SpectralClustering(**_SC).fit(X)
    return jcluster.SpectralClustering(**_SC).fit(X), t


# ---------------------------------------------------------------------------
# SpectralClustering
# ---------------------------------------------------------------------------


def test_landmarks_equal_and_eigenvalues_match(sc_pair):
    j, t = sc_pair
    np.testing.assert_array_equal(t._landmarks_, np.asarray(j._landmarks_))
    assert t.eigenvalues_.shape == (3,)
    np.testing.assert_allclose(t.eigenvalues_, np.asarray(j.eigenvalues_),
                               rtol=1e-4)
    # the landmarks' degrees d^-½; the degree functional A⁺·colsum itself
    # carries the near-cutoff spectrum of A (see the pinv tests)
    np.testing.assert_allclose(t._extension_[1], np.asarray(j._extension_[1]),
                               rtol=1e-4)


def test_embedding_after_sign_alignment(sc_pair, blobs):
    X, _ = blobs
    j, t = sc_pair
    s = _signs(t._extension_[2], j._extension_[2])
    np.testing.assert_allclose(t._extension_[2] * s,
                               np.asarray(j._extension_[2]), rtol=1e-4,
                               atol=1e-4)
    np.testing.assert_allclose(_port_embedding(t, X) * s,
                               _jax_embedding(j, X), atol=1e-4)


def test_labels_equal_from_a_shared_init(sc_pair, blobs):
    X, y = blobs
    j0, t0 = sc_pair
    s = _signs(t0._extension_[2], j0._extension_[2])
    C0 = _jax_embedding(j0, X)[[int(np.argmax(y == c)) for c in range(3)]]
    j = jcluster.SpectralClustering(**_SC, kmeans_params={"init": C0}).fit(X)
    t = tcluster.SpectralClustering(
        **_SC, kmeans_params={"init": C0 * s}).fit(X)
    np.testing.assert_array_equal(t.labels_, np.asarray(j.labels_))
    assert t.labels_.dtype == np.int32
    assert adjusted_rand_score(y, t.labels_) == 1.0
    np.testing.assert_allclose(
        t.assign_labels_.cluster_centers_ * s,
        np.asarray(j.assign_labels_.cluster_centers_), atol=1e-4)


def test_blobs_grouping_and_predict(sc_pair, blobs):
    X, y = blobs
    _, t = sc_pair
    assert adjusted_rand_score(y, t.labels_) == 1.0
    for i in range(3):
        assert len(set(t.labels_[y == i])) == 1
    np.testing.assert_array_equal(t.predict(X), t.labels_)
    rng = np.random.RandomState(0)
    Xnew = X[:200] + rng.randn(200, X.shape[1]).astype(np.float32) * 0.01
    np.testing.assert_array_equal(t.predict(Xnew), t.labels_[:200])
    assert set(t.fit_phase_seconds_) == {"nystrom", "kmeans"}


def test_pinv_takes_jax_cutoff():
    """A singular value between torch's default cut (max(m,n)·eps) and
    jax's (ten times it) is kept by the default and dropped by both jax and
    the port's ``_pinv``."""
    l = 20
    rng = np.random.RandomState(0)
    U, _ = np.linalg.qr(rng.randn(l, l))
    s = np.geomspace(1.0, 1e-3, l)
    s[-1] = 10 * l * np.finfo(np.float32).eps / 3  # between the two cuts
    s[-2] = 1e-9  # below both
    A = ((U * s) @ U.T).astype(np.float32)
    ours = tspectral._pinv(torch.as_tensor(A)).numpy()
    want = np.asarray(jnp.linalg.pinv(jnp.asarray(A)))
    default = torch.linalg.pinv(torch.as_tensor(A)).numpy()
    scale = np.abs(want).max()
    assert np.abs(ours - want).max() <= 1e-4 * scale
    assert np.abs(default - want).max() > 10 * scale


def test_pinv_cutoff_on_an_rbf_block(blobs):
    """An rbf landmark block (gamma = 1/d, 60 of the standardized blobs'
    rows) has a trailing spectrum between the two cuts: the degree
    functional ``A⁺ colsum`` follows jax's with jax's cut (within 1e-2 of
    its largest entry; the block is ill-conditioned in f32) and is another
    vector with torch's default."""
    X, _ = blobs
    Xk = X[:60]
    A = np.asarray(jpairwise.rbf_kernel(jnp.asarray(Xk), jnp.asarray(Xk)))
    c = np.asarray(jpairwise.rbf_kernel(jnp.asarray(X),
                                        jnp.asarray(Xk))).sum(0)
    want = np.asarray(jnp.linalg.pinv(jnp.asarray(A))) @ c
    ours = tspectral._pinv(torch.as_tensor(A.copy())).numpy() @ c
    default = torch.linalg.pinv(torch.as_tensor(A.copy())).numpy() @ c
    scale = np.abs(want).max()
    assert np.abs(ours - want).max() <= 1e-2 * scale
    assert np.abs(default - want).max() >= 0.5 * scale


@pytest.mark.parametrize("numpy_side", [False, True])
def test_callable_affinity(blobs, numpy_side):
    X, y = blobs
    seen = {}

    def affinity(a, b, gamma=None, degree=None, coef0=None):
        seen["gamma"] = gamma
        if numpy_side:  # numpy code: works on host tensors
            a, b = np.asarray(a), np.asarray(b)
            d2 = ((a[:, None, :] - b[None, :, :]) ** 2).sum(-1)
            return np.exp(-0.25 * d2)
        return rbf_kernel(a, b, gamma=0.25)

    sc = tcluster.SpectralClustering(n_clusters=3, n_components=50,
                                     random_state=0, gamma=0.7,
                                     affinity=affinity).fit(X)
    assert seen["gamma"] == 0.7
    assert adjusted_rand_score(y, sc.labels_) == 1.0
    np.testing.assert_array_equal(sc.predict(X), sc.labels_)


def test_assigners_and_validation(blobs):
    import sklearn.cluster

    X, y = blobs
    sk = tcluster.SpectralClustering(assign_labels="sklearn-kmeans",
                                     **_SC).fit(X)
    assert isinstance(sk.assign_labels_, sklearn.cluster.KMeans)
    assert adjusted_rand_score(y, sk.labels_) == 1.0
    np.testing.assert_array_equal(sk.predict(X), sk.labels_)
    km = tcluster.KMeans(n_clusters=3, random_state=1)
    est = tcluster.SpectralClustering(assign_labels=km, **_SC).fit(X)
    assert est.assign_labels_ is km
    passed = tcluster.SpectralClustering(kmeans_params={"max_iter": 5},
                                         **_SC).fit(X)
    assert passed.assign_labels_.max_iter == 5
    with pytest.raises(ValueError, match="n_components"):
        tcluster.SpectralClustering(n_components=500).fit(X)
    with pytest.raises(ValueError, match="affinity"):
        tcluster.SpectralClustering(n_components=50,
                                    affinity="bogus").fit(X)
    with pytest.raises(ValueError, match="assign_labels"):
        tcluster.SpectralClustering(n_components=50,
                                    assign_labels="bogus").fit(X)
    with pytest.raises(TypeError, match="assign_labels"):
        tcluster.SpectralClustering(n_components=50,
                                    assign_labels=42).fit(X)
    with pytest.raises(AttributeError, match="fit"):
        tcluster.SpectralClustering(n_components=50).predict(X)


def test_device_input_stays_on_the_device(blobs, monkeypatch):
    """A tensor input is staged without a copy and the inner KMeans gets
    the embedding as a tensor: no host round trip of X."""
    X, y = blobs
    Xt = torch.as_tensor(X)
    assert tspectral._stage_f32(Xt).data_ptr() == Xt.data_ptr()
    got = []
    real = tcluster.KMeans.fit

    def spy(self, Z, *a, **kw):
        got.append(Z)
        return real(self, Z, *a, **kw)

    monkeypatch.setattr(tcluster.KMeans, "fit", spy)
    sc = tcluster.SpectralClustering(**_SC).fit(Xt)
    assert isinstance(got[0], torch.Tensor) and got[0].shape == (500, 3)
    assert adjusted_rand_score(y, sc.labels_) == 1.0


def test_embed_matches_jax(blobs):
    X, _ = blobs
    A, Bt = tspectral.embed(X[:30], X[30:], 30, "rbf", {"gamma": 0.5})
    jA, jBt = jspectral.embed(X[:30], X[30:], 30, "rbf", {"gamma": 0.5})
    np.testing.assert_allclose(A.numpy(), np.asarray(jA), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(Bt.numpy(), np.asarray(jBt)[:470], rtol=1e-5,
                               atol=1e-6)
    with pytest.raises(ValueError, match="n_components"):
        tspectral.embed(X[:30], X[30:], 20, "rbf", None)


def test_spectral_carried_from_jax_predicts_alike(sc_pair, blobs):
    X, _ = blobs
    j, _ = sc_pair
    attrs = {"_landmarks_": j._landmarks_, "_extension_": j._extension_,
             "_n_fit_rows_": j._n_fit_rows_,
             "cluster_centers_": j.assign_labels_.cluster_centers_,
             "labels_": j.labels_, "eigenvalues_": j.eigenvalues_}
    t = spectral_from_numpy(attrs, gamma=None)
    np.testing.assert_array_equal(t.predict(X), np.asarray(j.predict(X)))
    np.testing.assert_array_equal(t.labels_, np.asarray(j.labels_))


# ---------------------------------------------------------------------------
# KernelKMeans
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def xor_pair():
    X, y = _xor()
    with config_context(device="cpu"):
        t = tcluster.KernelKMeans(**_XOR).fit(X)
    return X, y, jcluster.KernelKMeans(**_XOR).fit(X), t


def test_kernel_kmeans_solves_xor(xor_pair):
    X, y, j, t = xor_pair
    dense = tcluster.KMeans(n_clusters=2, random_state=3).fit(X)
    assert adjusted_rand_score(y, dense.labels_) < 0.5
    assert adjusted_rand_score(y, t.labels_) >= 0.9
    assert adjusted_rand_score(np.asarray(j.labels_), t.labels_) >= 0.9
    np.testing.assert_array_equal(t.predict(X), t.labels_)
    assert t.predict(X).dtype == np.int32
    assert t.cluster_centers_.shape == (2, 128)
    assert t._landmarks_.shape == (128, 2) and t.n_features_in_ == 2
    np.testing.assert_array_equal(t._landmarks_, np.asarray(j._landmarks_))


def test_kernel_kmeans_features_match_jax(xor_pair):
    """The polynomial kernel of degree 2 in 2-D has rank 6: the six
    leading whitening columns, sign-aligned, and the degree factors."""
    X, _, j, t = xor_pair
    for a, b in zip(t._extension_[:2], j._extension_[:2]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=1e-4, atol=1e-5)
    tm, jm = t._extension_[2][:, :6], np.asarray(j._extension_[2])[:, :6]
    np.testing.assert_allclose(tm * _signs(tm, jm), jm, rtol=1e-3,
                               atol=1e-3 * np.abs(jm).max())


def test_kernel_kmeans_new_rows_and_n_init(xor_pair):
    X, y, _, t = xor_pair
    rng = np.random.RandomState(1)
    Xn = X[:100] + rng.randn(100, 2).astype(np.float32) * 0.01
    np.testing.assert_array_equal(t.predict(Xn), t.labels_[:100])
    Xs, _ = _xor(n=512, seed=1)
    kw = dict(_XOR, n_components=64, random_state=7)
    one = tcluster.KernelKMeans(n_init=1, **kw).fit(Xs)
    four = tcluster.KernelKMeans(n_init=4, **kw).fit(Xs)
    assert four.inertia_ <= one.inertia_ + 1e-6


def test_kernel_kmeans_carried_from_jax_predicts_alike(xor_pair):
    X, _, j, _ = xor_pair
    attrs = {"_landmarks_": j._landmarks_, "_extension_": j._extension_,
             "_n_fit_rows_": j._n_fit_rows_,
             "cluster_centers_": j.cluster_centers_, "labels_": j.labels_,
             "inertia_": j.inertia_, "n_iter_": j.n_iter_}
    t = kernel_kmeans_from_numpy(
        attrs, affinity="polynomial", degree=2, coef0=1.0, gamma=0.5)
    np.testing.assert_array_equal(t.predict(X), np.asarray(j.predict(X)))


def test_kernel_kmeans_validation():
    X, _ = _xor(n=256)
    with pytest.raises(ValueError, match="callable"):
        tcluster.KernelKMeans(n_clusters=2, n_components=32,
                              affinity=lambda a, b: a @ b.T).fit(X)
    with pytest.raises(ValueError, match="affinity"):
        tcluster.KernelKMeans(n_clusters=2, n_components=32,
                              affinity="nope").fit(X)
    with pytest.raises(ValueError, match="n_components"):
        tcluster.KernelKMeans(n_clusters=2, n_components=256).fit(X)
    with pytest.raises(AttributeError, match="fit"):
        tcluster.KernelKMeans().predict(X)


def test_gram_colsum_is_the_strip_column_sum():
    C = torch.arange(12, dtype=torch.float32).view(4, 3)
    np.testing.assert_array_equal(tkk._gram_colsum(C).numpy(),
                                  C.numpy().sum(0))

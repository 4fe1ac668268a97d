"""The PyTorch port's fast transform and sketched KMeans held against the
JAX package, on the CPU.

- The transform functions take the JAX package's own sweep permutations
  (``jax.random.permutation(PRNGKey(r), d_pad)``, which PyTorch cannot
  draw) as the port's explicit permutation table, and then match it
  within rtol 1e-5 (cos/sin and the sums round differently).
- The sketched estimator draws its permutations and its k-means|| init
  from ``torch.Generator``, so it is held by quality against the port's
  exact fit, as the JAX package's drill holds its own: inertia ratio
  ≤ 1.05 and ARI ≥ 0.9 on KDD-shaped data, and no quality lost on
  separable blobs.
- A sketched model fitted by the JAX package predicts the same labels in
  the port (``convert.kmeans_from_numpy``).
"""

import importlib

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dask_ml_tpu.cluster import KMeans as JKMeans
from dask_ml_tpu.interop import export_learned_attrs
from dask_ml_tpu.models import kmeans as jcore
from dask_ml_tpu.ops import fast_transform as jft
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.convert import kmeans_from_numpy
from dask_ml_tpu_torch.models import kmeans as core
from dask_ml_tpu_torch.ops import fast_transform as ftm

# the module: the package exports the function k_means under the same name
tkm = importlib.import_module("dask_ml_tpu_torch.cluster.k_means")


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


DIMS = [3, 8, 13, 41, 64]


def _rand(n, d, seed=0):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def _jax_perms(n_sweeps, d_pad):
    """The JAX package's sweep permutations as a port permutation table."""
    rows = [np.arange(d_pad)] + [
        np.asarray(jax.random.permutation(jax.random.PRNGKey(r), d_pad))
        for r in range(1, n_sweeps)]
    return torch.as_tensor(np.stack(rows), dtype=torch.long)


def _pair(angles, d):
    """The same transform in both packages."""
    dp = ftm._pad_dim(d)
    L = dp.bit_length() - 1
    n_sweeps = angles.shape[0] // L
    return (jft.FastTransform(jnp.asarray(angles), d, dp),
            ftm.FastTransform(torch.as_tensor(angles), d, dp,
                              _jax_perms(n_sweeps, dp)))


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _close(got, want, rtol=1e-5, atol=1e-5):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# the operator family
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("d", DIMS)
def test_identity_transform_is_exact(d):
    X = _rand(17, d)
    Z = ftm.ft_apply(ftm.identity(d), _t(X))
    assert Z.shape == (17, ftm._pad_dim(d)) == jft.ft_apply(
        jft.identity(d), jnp.asarray(X)).shape
    np.testing.assert_array_equal(Z[:, :d].numpy(), X)
    assert (Z[:, d:] == 0).all()


@pytest.mark.parametrize("d", DIMS)
@pytest.mark.parametrize("n_sweeps", [1, 3])
def test_apply_and_transpose_match_jax(d, n_sweeps):
    dp = ftm._pad_dim(d)
    L = dp.bit_length() - 1
    rng = np.random.RandomState(2)
    angles = rng.uniform(-np.pi, np.pi, (n_sweeps * L, dp // 2)).astype(
        np.float32)
    jt, tt = _pair(angles, d)
    X = _rand(23, d, seed=3)
    Z = ftm.ft_apply(tt, _t(X))
    _close(Z, jft.ft_apply(jt, jnp.asarray(X)))
    back = ftm.ft_apply_t(tt, Z)
    _close(back, jft.ft_apply_t(jt, jnp.asarray(Z.numpy())))
    _close(back[:, :d], X, rtol=1e-4)
    _close((Z * Z).sum(1), (X * X).sum(1))


def test_factor_two_sparsity():
    dp = 16
    rng = np.random.RandomState(4)
    for lvl in range(4):
        stride = 1 << lvl
        th = torch.as_tensor(rng.uniform(-1, 1, dp // 2), dtype=torch.float32)
        E = ftm._rotate_level(torch.eye(dp), th, stride).numpy()
        _close(E, jft._rotate_level(jnp.eye(dp), jnp.asarray(th.numpy()),
                                    stride))
        for i, row in enumerate(E):
            js = np.nonzero(np.abs(row) > 1e-7)[0]
            assert len(js) <= 2
            assert all(abs(int(j) - i) in (0, stride) for j in js)


def test_support_matrix_reconstruct_and_loss_match_jax():
    d, p = 13, 5
    dp = ftm._pad_dim(d)
    L = dp.bit_length() - 1
    rng = np.random.RandomState(5)
    angles = rng.uniform(-2, 2, (2 * L, dp // 2)).astype(np.float32)
    jt, tt = _pair(angles, d)
    support = np.sort(rng.choice(dp, p, replace=False))
    jsup = jnp.asarray(support, jnp.int32)
    Wp = ftm.support_matrix(tt, _t(support))
    _close(Wp, jft.support_matrix(jt, jsup))
    X = _rand(31, d, seed=6)
    _close(_t(X) @ Wp, ftm.ft_apply(tt, _t(X))[:, support])
    vals = _rand(4, p, seed=7)
    _close(ftm.reconstruct(tt, _t(vals), _t(support)),
           jft.reconstruct(jt, jnp.asarray(vals), jsup))
    C = _rand(6, d, seed=8)
    _close(ftm.sketch_loss(tt, _t(C), _t(support)),
           jft.sketch_loss(jt, jnp.asarray(C), jsup), rtol=1e-4)
    ts, tv = ftm.sketch_project(tt, _t(C), p)
    js, jv = jft.sketch_project(jt, jnp.asarray(C), p)
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    _close(tv, jv)


def test_fit_identity_exact_when_support_covers():
    d, p, k = 16, 6, 5
    rng = np.random.RandomState(7)
    C = np.zeros((k, d), np.float32)
    C[:, rng.choice(d, p, replace=False)] = rng.randint(-8, 8, (k, p))
    ft, support, vals, loss = ftm.palm4msa_fit(_t(C), p, n_iter=4,
                                               perms=_jax_perms(4, d))
    assert (ft.angles == 0).all() and float(loss) == 0.0
    np.testing.assert_array_equal(
        ftm.reconstruct(ft, vals, support).numpy(), C)
    jf, jsup, jv, jl = jft.palm4msa_fit(jnp.asarray(C), p, n_iter=4)
    np.testing.assert_array_equal(support.numpy(), np.asarray(jsup))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


@pytest.mark.parametrize("case", ["rotated", "dense"])
def test_palm4msa_fit_matches_jax(case):
    """With the JAX package's permutations the fit finds the same support,
    loss and reconstructed centers. Angles are compared through what they
    produce: a lane pair with (near) no energy has an ill-conditioned
    (θ or θ ± π) angle that both packages may resolve differently without
    changing the sketch."""
    rng = np.random.RandomState(10)
    if case == "rotated":
        d, p, k, n_iter = 32, 8, 6, 16
        Q, _ = np.linalg.qr(rng.randn(d, d))
        sparse = np.zeros((k, d))
        sparse[:, rng.choice(d, p, replace=False)] = rng.randn(k, p)
        C = (sparse @ Q.T).astype(np.float32)
    else:
        d, p, k, n_iter = 41, 12, 7, 8
        C = (_rand(k, d, seed=8) * np.exp(_rand(1, d, seed=9)))
    dp = ftm._pad_dim(d)
    ft, support, vals, loss = ftm.palm4msa_fit(
        _t(C), p, n_iter=n_iter, perms=_jax_perms(n_iter, dp))
    jf, jsup, jv, jl = jft.palm4msa_fit(jnp.asarray(C), p, n_iter=n_iter)
    np.testing.assert_array_equal(support.numpy(), np.asarray(jsup))
    _close(loss, jl, rtol=1e-4, atol=1e-4)
    _close(ftm.reconstruct(ft, vals, support),
           jft.reconstruct(jf, jv, jsup), rtol=1e-4, atol=1e-4)
    id_loss = float(ftm.sketch_loss(
        ftm.identity(d), _t(C), ftm.sketch_project(ftm.identity(d), _t(C),
                                                    p)[0]))
    assert float(loss) <= id_loss + 1e-4
    _close(ftm.sketch_loss(ft, _t(C), support), loss, rtol=1e-4, atol=1e-4)


def test_fit_draws_permutations_from_generator():
    C = _t(_rand(7, 41, seed=11))
    fits = [ftm.palm4msa_fit(C, 10, n_iter=5,
                             generator=torch.Generator().manual_seed(s))
            for s in (3, 3, 4)]
    perms = fits[0][0].perms
    assert perms.shape == (5, 64) and perms.dtype == torch.long
    assert torch.equal(perms[0], torch.arange(64))
    assert all(torch.equal(torch.sort(r).values, torch.arange(64))
               for r in perms)
    assert torch.equal(fits[0][0].angles, fits[1][0].angles)
    assert not torch.equal(perms, fits[2][0].perms)
    with pytest.raises(ValueError, match="perms"):
        ftm.palm4msa_fit(C, 10, n_iter=5, perms=torch.zeros(4, 64))


def test_transform_without_permutations_is_not_replayed():
    ft = ftm.FastTransform(np.zeros((12, 32), np.float32), 41, 64)
    with pytest.raises(ValueError, match="permutation"):
        ftm.ft_apply(ft, torch.zeros(2, 41))


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------


def _blobs(n=2800, d=41, k=8, seed=0, sep=6.0):
    rng = np.random.RandomState(seed)
    C = rng.randn(k, d).astype(np.float32) * sep
    X = np.concatenate([C[i] + rng.randn(n // k, d).astype(np.float32)
                        for i in range(k)])
    rng.shuffle(X)
    return X


@pytest.fixture(scope="module")
def fitted():
    X = _blobs()
    with config_context(device="cpu"):
        sk = KMeans(n_clusters=8, algorithm="sketched", sketch_cols=10,
                    random_state=3, max_iter=60).fit(X)
        exact = KMeans(n_clusters=8, random_state=3, max_iter=60).fit(X)
    return {"X": X, "sk": sk, "exact": exact}


def test_fitted_surface(fitted):
    sk = fitted["sk"]
    assert sk.fast_transform_.perms.shape == (8, 64)
    assert sk.sketch_staging_.shape == (41, 10)
    assert sk.sketch_offset_.shape == (10,)
    assert sk.sketch_vals_.shape == (8, 10)
    assert sk.sketch_centers_.shape == sk.cluster_centers_.shape == (8, 41)
    assert np.all(np.diff(sk.sketch_support_) > 0)
    np.testing.assert_allclose(sk.sketch_offset_,
                               sk.sketch_mean_ @ sk.sketch_staging_,
                               rtol=1e-5, atol=1e-5)
    assert sk.labels_.dtype == np.int32
    p = sk.sketch_pruning_
    assert len(p["pruned_fraction_per_iter"]) == sk.n_iter_
    assert p["rows_considered"] == sk.n_iter_ * 2800


def test_predict_equals_labels_and_goes_through_the_sketch(fitted,
                                                          monkeypatch):
    sk, X = fitted["sk"], fitted["X"]
    assert core.sketched_assign_wins(2800, 8, 41, 10)
    seen = []
    orig = core._predict_sketched_fast
    monkeypatch.setattr(core, "_predict_sketched_fast",
                        lambda *a, **k: seen.append(1) or orig(*a, **k))
    np.testing.assert_array_equal(sk.predict(X), sk.labels_)
    assert seen == [1]


def test_dispatch_branches_agree(fitted):
    Xt = _t(fitted["X"])
    Wp, off, vals, centers_sk = fitted["sk"]._sketch_args(Xt.device)
    np.testing.assert_array_equal(
        core._predict_sketched_fast(Xt, Wp, off, vals).numpy(),
        core.predict_labels(Xt, centers_sk).numpy())


def test_quality_matches_exact_on_separable(fitted):
    from sklearn.metrics import adjusted_rand_score

    sk, exact = fitted["sk"], fitted["exact"]
    assert sk.inertia_ <= exact.inertia_ * 1.01
    assert adjusted_rand_score(exact.labels_, sk.labels_) >= 0.99


@pytest.mark.parametrize("n,k,d,p", [(1000, 16, 64, 16), (1000, 4, 64, 16),
                                     (1000, 16, 64, 40), (4898431, 8, 41,
                                                          10)])
def test_sketched_assign_wins_fallback_matches_jax(n, k, d, p):
    assert core.sketched_assign_wins(n, k, d, p) == \
        jcore.sketched_assign_wins(n, k, d, p)


def _kdd_synth(n, d, seed, kt=23):
    """The JAX bench's KDD-Cup'99 stand-in recipe, drawn with numpy."""
    rng = np.random.default_rng(seed)
    centers = rng.standard_normal((kt, d)) * np.exp(
        rng.standard_normal((1, d)) * 1.5)
    logits = -0.45 * np.arange(kt)
    prob = np.exp(logits) / np.exp(logits).sum()
    ids = rng.choice(kt, size=n, p=prob)
    noise = rng.standard_normal((n, d)) * 0.3 * np.exp(
        rng.standard_normal((1, d)) * 0.5)
    return (centers[ids] + noise).astype(np.float32)


def test_quality_gate_on_kdd_shaped():
    """The JAX drill's quality gate at a smaller n: sketched against exact
    on KDD-shaped data, k = 23, p = 36, 16 sweeps."""
    from sklearn.metrics import adjusted_rand_score

    X = _kdd_synth(12000, 41, seed=99)
    exact = KMeans(n_clusters=23, random_state=11, max_iter=100).fit(X)
    sk = KMeans(n_clusters=23, random_state=11, max_iter=100,
                algorithm="sketched", sketch_cols=36, sketch_iters=16).fit(X)
    assert sk.inertia_ / exact.inertia_ <= 1.05
    assert adjusted_rand_score(exact.labels_, sk.labels_) >= 0.9


def test_restricted_rounds_fused_loop_same_partition(fitted, monkeypatch):
    """The restricted rounds through the single-pass loop instead of the
    bounded one: the same partition and iteration count."""
    monkeypatch.setattr(tkm, "_SKETCHED_BOUNDED", False)
    fused = KMeans(n_clusters=8, algorithm="sketched", sketch_cols=10,
                   random_state=3, max_iter=60).fit(fitted["X"])
    np.testing.assert_array_equal(fused.labels_, fitted["sk"].labels_)
    assert fused.n_iter_ == fitted["sk"].n_iter_
    assert not hasattr(fused, "sketch_pruning_")


def test_sketch_params_validated():
    X = _blobs(n=400)
    with pytest.raises(ValueError, match="sketch_cols"):
        KMeans(n_clusters=8, algorithm="sketched", sketch_cols=0).fit(X)
    with pytest.raises(ValueError, match="sketch_iters"):
        KMeans(n_clusters=8, algorithm="sketched", sketch_iters=-1).fit(X)


def test_jax_sketched_model_predicts_the_same_in_the_port():
    X = _blobs(seed=1)
    ref = JKMeans(n_clusters=8, algorithm="sketched", sketch_cols=10,
                  random_state=0, max_iter=40).fit(X)
    port = kmeans_from_numpy(export_learned_attrs(ref))
    Xq = _blobs(n=1200, seed=1)[:300] + 0.1
    np.testing.assert_array_equal(port.predict(Xq), ref.predict(Xq))
    np.testing.assert_array_equal(port.predict(X), ref.labels_)
    np.testing.assert_array_equal(port.fast_transform_.angles,
                                  np.asarray(ref.fast_transform_.angles))
    assert port.fast_transform_.perms is None
    bad = export_learned_attrs(ref)
    del bad["sketch_vals_"]
    with pytest.raises(ValueError, match="sketch"):
        kmeans_from_numpy(bad)


def test_refit_with_another_algorithm_drops_the_sketch():
    X = _blobs(n=800, seed=2)
    km = KMeans(n_clusters=8, algorithm="sketched", sketch_cols=10,
                random_state=0).fit(X)
    assert km.fast_transform_ is not None
    km.set_params(algorithm="bounded").fit(X)
    assert not hasattr(km, "fast_transform_")
    assert not hasattr(km, "sketch_pruning_")
    assert hasattr(km, "lloyd_pruning_")
    np.testing.assert_array_equal(km.predict(X), km.labels_)
    km.set_params(algorithm="full").fit(X)
    assert not hasattr(km, "lloyd_pruning_")

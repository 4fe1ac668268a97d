"""The PyTorch port's tall-skinny linear algebra, PCA and TruncatedSVD held
against the JAX package, on the CPU.

Signs: CholeskyQR2 gives R a positive diagonal in both packages, so the
fast path's Q and R compare as they are; Householder's signs are LAPACK's
in both. Everything that leaves a factorization compares after
``svd_flip``. Tolerances, from float32 rounding carried through products
of n·d terms: factors and singular values within rtol 1e-4 (atol 1e-5
times the scale of the factor), estimator attributes within rtol 1e-4.
Randomized paths are held to the JAX package's own test matrix Ω at the
core (the test recreates it from ``jax.random.key``) and by quality
against the exact path, and by seed determinism, at the facades: the
port draws Ω from a ``torch.Generator``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dask_ml_tpu import decomposition as jdec
from dask_ml_tpu.interop import export_learned_attrs
from dask_ml_tpu.ops import linalg as jlinalg
from dask_ml_tpu.parallel import mesh as mesh_lib
from dask_ml_tpu.utils.validation import svd_flip as jsvd_flip
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch import decomposition as tdec
from dask_ml_tpu_torch.convert import pca_from_numpy, truncated_svd_from_numpy
from dask_ml_tpu_torch.ops import linalg as tlinalg
from dask_ml_tpu_torch.utils.validation import svd_flip

TOL = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(autouse=True)
def on_cpu():
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    with config_context(device="cpu"), \
            mesh_lib.use_mesh(mesh_lib.make_mesh(n_devices=1)):
        yield
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision(prec)


def _low_rank(seed=0, n=600, d=20, rank=6, noise=0.1):
    """A rank-``rank`` signal plus noise, the JAX PCA bench's recipe at a
    small size."""
    rng = np.random.RandomState(seed)
    A = rng.standard_normal((n, rank)).astype(np.float32)
    B = rng.standard_normal((rank, d)).astype(np.float32)
    return (A @ B + noise * rng.standard_normal((n, d))).astype(np.float32)


def _close(got, want, scale=None, **tol):
    got, want = np.asarray(got), np.asarray(want)
    tol = tol or TOL
    if scale is not None:
        tol = dict(tol, atol=tol["atol"] * scale)
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("u_based", [False, True])
def test_svd_flip_matches_jax(u_based):
    rng = np.random.RandomState(1)
    u = rng.standard_normal((30, 5)).astype(np.float32)
    v = rng.standard_normal((5, 8)).astype(np.float32)
    v[2] = 0.0  # a zero vector keeps its sign
    u[:, 3] = 0.0
    gu, gv = svd_flip(torch.as_tensor(u), torch.as_tensor(v),
                      u_based_decision=u_based)
    ju, jv = jsvd_flip(jnp.asarray(u), jnp.asarray(v),
                       u_based_decision=u_based)
    np.testing.assert_array_equal(gu.numpy(), np.asarray(ju))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(jv))


def test_tsqr_fast_path_matches_jax():
    X = _low_rank(2, rank=20)
    tlinalg.reset_tsqr_counts()
    Q, R = tlinalg.tsqr(torch.as_tensor(X))
    assert tlinalg.tsqr_counts == {"host_reads": 1, "cholqr2": 1,
                                   "householder": 0}
    Qj, Rj = jlinalg.tsqr(jnp.asarray(X))
    _close(Q.numpy(), Qj)
    _close(R.numpy(), Rj, scale=float(np.abs(Rj).max()))
    assert bool((torch.diagonal(R) > 0).all())
    np.testing.assert_allclose((Q.T @ Q).numpy(), np.eye(20), atol=1e-5)


def _ill_conditioned(seed=3, n=400, d=12, cond=1e6):
    rng = np.random.RandomState(seed)
    U, _ = np.linalg.qr(rng.standard_normal((n, d)))
    V, _ = np.linalg.qr(rng.standard_normal((d, d)))
    s = np.logspace(0, -np.log10(cond), d)
    return ((U * s) @ V.T).astype(np.float32)


def test_tsqr_falls_back_on_an_ill_conditioned_input():
    X = _ill_conditioned()
    tlinalg.reset_tsqr_counts()
    Q, R = tlinalg.tsqr(torch.as_tensor(X))
    assert tlinalg.tsqr_counts == {"host_reads": 1, "cholqr2": 0,
                                   "householder": 1}
    d = X.shape[1]
    assert float(torch.abs(Q.T @ Q - torch.eye(d)).max()) < 1e-5
    np.testing.assert_allclose((Q @ R).numpy(), X, atol=1e-6)
    # the JAX package takes its fallback too: the same SVD after the flip
    Uj, Sj, Vj = jlinalg.tsvd(jnp.asarray(X))
    U, S, Vt = tlinalg.tsvd(torch.as_tensor(X))
    _close(S.numpy(), Sj, scale=1.0)
    U, Vt = svd_flip(U, Vt)
    Uj, Vj = jsvd_flip(Uj, Vj)
    # the leading directions are well separated; the smallest singular
    # values (1e-6) carry f32 rounding of the whole matrix
    _close(Vt[:4].numpy(), np.asarray(Vj)[:4])
    _close(U[:, :4].numpy(), np.asarray(Uj)[:, :4])


def test_tsqr_short_wide_zero_and_weighted():
    rng = np.random.RandomState(4)
    # n < d: Householder at once, no guard read
    Xw = rng.standard_normal((6, 10)).astype(np.float32)
    tlinalg.reset_tsqr_counts()
    Q, R = tlinalg.tsqr(torch.as_tensor(Xw))
    assert Q.shape == (6, 6) and R.shape == (6, 10)
    assert tlinalg.tsqr_counts == {"host_reads": 0, "cholqr2": 0,
                                   "householder": 1}
    np.testing.assert_allclose((Q @ R).numpy(), Xw, atol=1e-5)
    S = tlinalg.tsvd(torch.as_tensor(Xw))[1]
    _close(S.numpy(), np.linalg.svd(Xw, compute_uv=False))
    # a zero matrix: the floor keeps CholeskyQR2 finite, singular values 0
    Z = torch.zeros((50, 4))
    U, S, Vt = tlinalg.tsvd(Z)
    assert bool(torch.isfinite(U).all()) and float(S.abs().max()) == 0.0
    # weights: rows of weight 0 are zeroed whatever they hold
    X = _low_rank(5, n=200, d=8)
    w = np.ones(200, np.float32)
    w[150:] = 0.0
    junk = X.copy()
    junk[150:] = 1e3
    Q, R = tlinalg.tsqr(torch.as_tensor(junk), weights=torch.as_tensor(w))
    assert float(Q[150:].abs().max()) == 0.0
    Qj, Rj = jlinalg.tsqr(jnp.asarray(junk), weights=jnp.asarray(w))
    _close(R.numpy(), Rj, scale=float(np.abs(Rj).max()))
    S = tlinalg.tsvd(torch.as_tensor(junk), weights=torch.as_tensor(w))[1]
    _close(S.numpy(), np.linalg.svd(X[:150], compute_uv=False))


def test_tsvd_matches_jax():
    X = _low_rank(6)
    U, S, Vt = tlinalg.tsvd(torch.as_tensor(X))
    Uj, Sj, Vj = jlinalg.tsvd(jnp.asarray(X))
    U, Vt = svd_flip(U, Vt)
    Uj, Vj = jsvd_flip(Uj, Vj)
    _close(S.numpy(), Sj, scale=float(Sj[0]))
    # the six signal directions; the noise singular values crowd
    _close(Vt[:6].numpy(), np.asarray(Vj)[:6])
    _close(U[:, :6].numpy(), np.asarray(Uj)[:, :6])


@pytest.mark.parametrize("n_power_iter", [0, 2])
def test_svd_compressed_with_jax_omega_matches_jax(n_power_iter):
    X = _low_rank(7, n=500, d=30, rank=5)
    k, seed = 8, 11
    ell = k + 10
    key = jax.random.key(seed)
    omega = np.array(jax.random.normal(key, (30, ell), jnp.float32))
    Uj, Sj, Vj = jlinalg.svd_compressed(jnp.asarray(X), k, n_power_iter,
                                        key=key, compute_dtype=None)
    U, S, Vt = tlinalg.svd_compressed(torch.as_tensor(X), k, n_power_iter,
                                      omega=torch.as_tensor(omega))
    assert U.shape == (500, k) and S.shape == (k,) and Vt.shape == (k, 30)
    U, Vt = svd_flip(U, Vt)
    Uj, Vj = jsvd_flip(Uj, Vj)
    _close(S.numpy(), Sj, scale=float(Sj[0]))
    _close(Vt[:5].numpy(), np.asarray(Vj)[:5])
    _close(U[:, :5].numpy(), np.asarray(Uj)[:, :5])


def test_svd_compressed_refusals_and_seed():
    X = torch.as_tensor(_low_rank(8, n=100, d=12))
    # the bf16 sketch is ported (tests/test_torch_precision.py); any other
    # low-precision sketch is refused
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        tlinalg.svd_compressed(X, 3, compute_dtype=torch.float16)
    with pytest.raises(ValueError, match="omega"):
        tlinalg.svd_compressed(X, 3, omega=torch.zeros(12, 5))
    with pytest.raises(ValueError, match="float32"):
        tlinalg.tsqr(X.double())
    a = tlinalg.svd_compressed(X, 3)[1]
    b = tlinalg.svd_compressed(X, 3)[1]
    assert torch.equal(a, b)  # seed 0 by default


PCA_ATTRS = ("mean_", "components_", "explained_variance_",
             "explained_variance_ratio_", "singular_values_")


def _check_pca(te, je, n_signal=None):
    """Every attribute; ``components_`` only for the first ``n_signal``
    directions when given (beyond the signal the noise singular values
    crowd, and their directions rotate by more than the rounding)."""
    for name in PCA_ATTRS:
        want = np.asarray(getattr(je, name))
        got = getattr(te, name)
        if name == "components_" and n_signal is not None:
            got, want = got[:n_signal], want[:n_signal]
        _close(got, want, scale=float(np.abs(want).max()))
    assert te.noise_variance_ == pytest.approx(float(je.noise_variance_),
                                               rel=1e-4)
    assert (te.n_components_, te.n_samples_, te.n_features_) == (
        je.n_components_, je.n_samples_, je.n_features_)


@pytest.mark.parametrize("whiten", [False, True])
@pytest.mark.parametrize("n_components", [5, None])
def test_pca_full_matches_jax(n_components, whiten):
    X = _low_rank(9, n=300, d=12, rank=5) + 3.0
    kw = dict(n_components=n_components, svd_solver="full", whiten=whiten)
    je = jdec.PCA(**kw)
    te = tdec.PCA(**kw)
    Zj, Zt = je.fit_transform(X), te.fit_transform(X)
    k = 5  # the signal directions
    _check_pca(te, je, n_signal=k)
    Xn = _low_rank(10, n=40, d=12, rank=5) + 3.0
    _close(Zt[:, :k], np.asarray(Zj)[:, :k], scale=float(np.abs(Zj).max()))
    _close(te.transform(Xn)[:, :k], np.asarray(je.transform(Xn))[:, :k],
           scale=float(np.abs(Zj).max()))
    _close(te.transform(X)[:, :k], Zt[:, :k], scale=float(np.abs(Zt).max()))
    Z = np.array(je.transform(Xn))
    _close(te.inverse_transform(Z), np.asarray(je.inverse_transform(Z)),
           scale=float(np.abs(X).max()))
    if n_components is not None:
        for got, want in ((te.get_covariance(), je.get_covariance()),
                          (te.get_precision(), je.get_precision())):
            _close(got, want, scale=float(np.abs(want).max()))
        _close(te.score_samples(Xn), np.asarray(je.score_samples(Xn)),
               rtol=1e-4, atol=1e-4)
        assert te.score(Xn) == pytest.approx(je.score(Xn), rel=1e-4)


def test_pca_solver_policy_and_errors():
    X = _low_rank(11, n=80, d=10)
    assert tdec.PCA(3)._resolve_solver(1000, 600, 3) == "randomized"
    assert tdec.PCA(3)._resolve_solver(100, 60, 3) == "full"
    assert tdec.PCA(590)._resolve_solver(1000, 600, 590) == "full"
    for bad, exc, match in (
            (dict(svd_solver="arpack"), ValueError, "Invalid solver"),
            (dict(n_components=0.5), NotImplementedError, "Fractional"),
            (dict(n_components=11), ValueError, "must be between"),
            (dict(n_components=0, svd_solver="randomized"), ValueError,
             "must be between 1")):
        for est in (tdec.PCA(**bad), jdec.PCA(**bad)):
            with pytest.raises(exc, match=match):
                est.fit(X)
    te = tdec.PCA(3).fit(X)
    with pytest.raises(ValueError, match="fitted with 10"):
        te.transform(X[:, :9])


def test_pca_randomized_quality_and_determinism():
    """The bucketed sketch (k = 4 fits a rank of 32, capped at d) against
    the exact path, and the same seed twice."""
    X = _low_rank(12, n=2000, d=40, rank=4)
    kw = dict(n_components=4, svd_solver="randomized", iterated_power=2)
    a = tdec.PCA(random_state=0, **kw).fit(X)
    b = tdec.PCA(random_state=0, **kw).fit(X)
    exact = tdec.PCA(4, svd_solver="full").fit(X)
    np.testing.assert_array_equal(a.components_, b.components_)
    _close(a.singular_values_, exact.singular_values_,
           scale=float(exact.singular_values_[0]))
    assert np.abs(np.diag(a.components_ @ exact.components_.T)).min() \
        > 0.9999
    _close(a.explained_variance_ratio_, exact.explained_variance_ratio_,
           rtol=1e-3, atol=1e-5)
    je = jdec.PCA(random_state=0, **kw).fit(X)
    assert a.noise_variance_ == pytest.approx(float(je.noise_variance_),
                                              rel=1e-3)


def test_truncated_svd_tsqr_matches_jax():
    X = _low_rank(13, n=400, d=15, rank=4)
    je, te = jdec.TruncatedSVD(4), tdec.TruncatedSVD(4)
    Zj, Zt = je.fit_transform(X), te.fit_transform(X)
    for name in ("components_", "explained_variance_",
                 "explained_variance_ratio_", "singular_values_"):
        want = np.asarray(getattr(je, name))
        _close(getattr(te, name), want, scale=float(np.abs(want).max()))
    scale = float(np.abs(Zj).max())
    _close(Zt, Zj, scale=scale)
    _close(te.transform(X[:50]), np.asarray(je.transform(X[:50])),
           scale=scale)
    _close(te.inverse_transform(Zt[:50]),
           np.asarray(je.inverse_transform(Zt[:50])),
           scale=float(np.abs(X).max()))
    for bad, match in ((dict(n_components=15), "< n_features"),
                       (dict(algorithm="arpack"), "algorithm")):
        with pytest.raises(ValueError, match=match):
            tdec.TruncatedSVD(**bad).fit(X)
    with pytest.raises(ValueError, match="<= n_samples"):
        tdec.TruncatedSVD(5).fit(X[:4])


def test_truncated_svd_randomized_quality_and_determinism():
    X = _low_rank(14, n=1000, d=50, rank=3)
    a = tdec.TruncatedSVD(3, algorithm="randomized", random_state=1).fit(X)
    b = tdec.TruncatedSVD(3, algorithm="randomized", random_state=1).fit(X)
    exact = tdec.TruncatedSVD(3).fit(X)
    np.testing.assert_array_equal(a.components_, b.components_)
    _close(a.singular_values_, exact.singular_values_,
           scale=float(exact.singular_values_[0]))
    assert np.abs(np.diag(a.components_ @ exact.components_.T)).min() \
        > 0.9999


def test_converted_decompositions_transform_like_jax():
    X = _low_rank(15, n=300, d=10, rank=3) - 1.0
    for whiten in (False, True):
        je = jdec.PCA(3, svd_solver="full", whiten=whiten).fit(X)
        te = pca_from_numpy(export_learned_attrs(je), whiten=whiten)
        _close(te.transform(X), np.asarray(je.transform(X)),
               scale=float(np.abs(np.asarray(je.transform(X))).max()))
        _close(te.inverse_transform(np.array(je.transform(X))),
               np.asarray(je.inverse_transform(je.transform(X))),
               scale=float(np.abs(X).max()))
        assert te.score(X) == pytest.approx(je.score(X), rel=1e-4)
    js = jdec.TruncatedSVD(3).fit(X)
    ts = truncated_svd_from_numpy(export_learned_attrs(js))
    _close(ts.transform(X), np.asarray(js.transform(X)),
           scale=float(np.abs(np.asarray(js.transform(X))).max()))
    attrs = export_learned_attrs(je)
    with pytest.raises(ValueError, match="mean_"):
        pca_from_numpy(dict(attrs, mean_=np.zeros(4)))
    with pytest.raises(ValueError, match="components_"):
        truncated_svd_from_numpy({"components_": np.zeros(3)})

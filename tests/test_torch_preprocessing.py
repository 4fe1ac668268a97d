"""The PyTorch port's preprocessing held against the JAX package, on the
CPU: the same numpy inputs, made from a seed, through
``dask_ml_tpu.preprocessing`` and ``dask_ml_tpu_torch.preprocessing``.

Tolerances and their reasons:

- statistics formed on the host in float64 from exact order statistics
  (``MinMaxScaler``'s ``data_min_`` / ``data_max_`` / ``scale_`` /
  ``min_``, the encoders, ``LabelEncoder``): equal bit for bit;
- the exact percentiles (``RobustScaler``, ``QuantileTransformer``'s
  quantiles) and the :func:`percentiles` helper: the same sort and the
  same f32 blend, held to rtol 1e-6;
- device statistics and transforms (moments, the scaled arrays): the same
  f32 expressions reduced in other orders, rtol 1e-6;
- ``QuantileTransformer``'s normal output: ``torch.special.ndtri`` against
  jax's ``norm.ppf``, rtol 1e-5 (atol 1e-5 near 0);
- the sparse ``StandardScaler``'s moments on integer-valued data with a
  power-of-two row count: every sum is exact, so equal bit for bit to the
  JAX ``column_mean_var``.

Inputs have normal magnitudes (the f32 denormal caveat of the ROADMAP).
"""

import numpy as np
import pandas as pd
import pytest
import scipy.sparse as scipy_sparse
import torch

import jax.numpy as jnp

from dask_ml_tpu import preprocessing as jpre
from dask_ml_tpu.ops import sparse as jsps
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch import preprocessing as tpre
from dask_ml_tpu_torch.convert import preprocessor_from_numpy
from dask_ml_tpu_torch.ops import sparse as tsps
from dask_ml_tpu_torch.preprocessing.data import interp, percentiles

RTOL = 1e-6


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


def _X(n=203, d=5, seed=0):
    rng = np.random.RandomState(seed)
    out = rng.uniform(0, 10, size=(n, d)).astype(np.float32)
    out[:, 2] = 3.5  # a constant column
    out[::7, 3] = 1.25  # a value repeated across quantiles
    return out


def _int_csr(n=64, d=12, seed=0, density=0.3):
    rng = np.random.RandomState(seed)
    dense = (rng.randint(-4, 5, (n, d))
             * (rng.uniform(size=(n, d)) < density)).astype(np.float32)
    dense[:, 5] = 0.0  # an all-zero column
    dense[:, 7] = 3.0  # a column stored in every row
    return dense, scipy_sparse.csr_matrix(dense)


def _close(a, b, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


# ---------------------------------------------------------------------------
# the helpers against jnp
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n", [1, 2, 7, 203])
def test_percentiles_match_jnp(n):
    X = _X(n=max(n, 1))[:n]
    q = [0.0, 12.5, 25.0, 50.0, 73.3, 100.0]
    got = percentiles(torch.as_tensor(X), q).numpy()
    want = np.asarray(jnp.percentile(jnp.asarray(X),
                                     jnp.asarray(q, jnp.float32), axis=0))
    _close(got, want)


def test_percentiles_at_quantile_references():
    """The QuantileTransformer's 1,000 references on a column with many
    repeated values."""
    X = _X(n=500)
    refs = np.linspace(0, 1, 400) * 100.0
    got = percentiles(torch.as_tensor(X), refs).numpy()
    want = np.asarray(jnp.percentile(jnp.asarray(X),
                                     jnp.asarray(refs, jnp.float32), axis=0))
    _close(got, want)


@pytest.mark.parametrize("case", ["plain", "repeated", "constant", "one"])
def test_interp_matches_jnp(case):
    rng = np.random.RandomState(1)
    xp = np.sort(rng.uniform(-2, 2, 9)).astype(np.float32)
    if case == "repeated":
        xp[3:6] = xp[3]
    elif case == "constant":
        xp[:] = 0.5
    elif case == "one":
        xp = xp[:1]
    fp = np.linspace(0, 1, len(xp)).astype(np.float32)
    x = np.concatenate([rng.uniform(-3, 3, 40), xp, [xp[0], xp[-1]]]
                       ).astype(np.float32)
    got = interp(torch.as_tensor(x)[None], torch.as_tensor(xp)[None],
                 torch.as_tensor(fp)[None])[0].numpy()
    want = np.asarray(jnp.interp(jnp.asarray(x), jnp.asarray(xp),
                                 jnp.asarray(fp)))
    _close(got, want, atol=1e-7)


# ---------------------------------------------------------------------------
# the device scalers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("with_mean,with_std", [(True, True), (True, False),
                                                (False, True)])
def test_standard_scaler_dense_matches_jax(with_mean, with_std):
    X = _X()
    kw = dict(with_mean=with_mean, with_std=with_std)
    j = jpre.StandardScaler(**kw).fit(X)
    t = tpre.StandardScaler(**kw).fit(X)
    for name in ("mean_", "var_", "scale_"):
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            _close(a, b)
    _close(t.transform(X), j.transform(X), atol=1e-6)
    _close(t.inverse_transform(t.transform(X)), X, rtol=1e-5, atol=1e-5)


def test_column_mean_var_bit_for_bit_on_integer_data():
    """64 rows of unit weight, integer values in [-4, 5): a mean is a
    multiple of 1/64, a squared deviation has at most 18 significant bits
    and a column's sum of them fits f32's 24, so every sum is exact."""
    dense, csr = _int_csr()
    A = tsps.ell_from_csr(csr)
    w = np.ones(64, np.float32)
    tm, tv, tsw = tsps.column_mean_var(A, torch.as_tensor(w))
    jm, jv, jsw = jsps.column_mean_var(
        jsps.SparseRows(jnp.asarray(A.values), jnp.asarray(A.cols), A.d),
        jnp.asarray(w))
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))
    assert float(tsw) == float(jsw)
    np.testing.assert_array_equal(tv.numpy(),
                                  dense.astype(np.float64).var(0))
    s1, s2, sw = tsps.column_moments(A, torch.as_tensor(w))
    j1, j2, jw = jsps.column_moments(
        jsps.SparseRows(jnp.asarray(A.values), jnp.asarray(A.cols), A.d),
        jnp.asarray(w))
    np.testing.assert_array_equal(s1.numpy(), np.asarray(j1))
    np.testing.assert_array_equal(s2.numpy(), np.asarray(j2))
    assert float(sw) == float(jw)


def test_column_moments_go_through_the_pullback(monkeypatch):
    """Every column sum of the moments is a pullback of a container with
    A's columns (on the card that is K6-b in fixed point)."""
    dense, csr = _int_csr()
    A = tsps.ell_from_csr(csr)
    calls = []
    real = tsps.pullback

    def spy(B, r, **kw):
        assert B.d == A.d and torch.equal(torch.as_tensor(B.cols),
                                          torch.as_tensor(A.cols))
        calls.append(B)
        return real(B, r, **kw)

    monkeypatch.setattr(tsps, "pullback", spy)
    tsps.column_mean_var(A, torch.ones(64))
    assert len(calls) == 3
    tsps.column_moments(A, torch.ones(64))
    assert len(calls) == 5


def test_sparse_standard_scaler_matches_jax_on_float_data():
    rng = np.random.RandomState(3)
    dense = (rng.randn(300, 20) * (rng.uniform(size=(300, 20)) < 0.2)
             ).astype(np.float32)
    dense[:, 4] += (dense[:, 4] != 0) * 100.0  # a large-mean column
    csr = scipy_sparse.csr_matrix(dense)
    j = jpre.StandardScaler(with_mean=False).fit(csr)
    t = tpre.StandardScaler(with_mean=False).fit(csr)
    assert t.mean_ is None and j.mean_ is None
    _close(t.var_, j.var_, rtol=1e-5)
    _close(t.scale_, j.scale_, rtol=1e-5)
    _close(t.var_, dense.astype(np.float64).var(0), rtol=1e-5)
    out = t.transform(csr)
    assert isinstance(out, tsps.SparseRows)
    jout = j.transform(csr)
    _close(tsps.to_dense(out).numpy(), np.asarray(jsps.to_dense(jout)),
           rtol=1e-5, atol=1e-6)
    # the container input and the CSR input give the same fit
    t2 = tpre.StandardScaler(with_mean=False).fit(tsps.ell_from_csr(csr))
    np.testing.assert_array_equal(t2.var_, t.var_)


def test_sparse_standard_scaler_refusals():
    dense, csr = _int_csr()
    with pytest.raises(ValueError, match="with_mean"):
        tpre.StandardScaler().fit(csr)
    fitted = tpre.StandardScaler(with_mean=False).fit(csr)
    centered = tpre.StandardScaler().fit(dense)
    with pytest.raises(ValueError, match="center"):
        centered.transform(csr)
    cols = np.zeros((4, 3), np.int32)
    cols[:, 1] = 0  # column 0 stored twice in every row
    vals = np.ones((4, 3), np.float32)
    vals[:, 2] = 0.0
    with pytest.raises(ValueError, match="twice"):
        tpre.StandardScaler(with_mean=False).fit(
            tsps.SparseRows(vals, cols, 5))
    # the transform scales the container, never densifies
    out = fitted.transform(csr)
    assert isinstance(out, tsps.SparseRows) and out.k == tsps.ell_from_csr(
        csr).k


def test_minmax_scaler_matches_jax():
    X = _X()
    for kw in ({}, {"feature_range": (-2, 3)}):
        j = jpre.MinMaxScaler(**kw).fit(X)
        t = tpre.MinMaxScaler(**kw).fit(X)
        for name in ("data_min_", "data_max_", "data_range_", "scale_",
                     "min_"):
            np.testing.assert_array_equal(getattr(t, name),
                                          getattr(j, name), err_msg=name)
        _close(t.transform(X), j.transform(X), atol=1e-6)
        _close(t.inverse_transform(t.transform(X)), X, rtol=1e-5, atol=1e-5)
    Xo = X.copy()
    Xo[0, 0] = 100.0
    t = tpre.MinMaxScaler(clip=True).fit(X)
    j = jpre.MinMaxScaler(clip=True).fit(X)
    assert t.transform(Xo).max() <= 1.0
    _close(t.transform(Xo), j.transform(Xo), atol=1e-6)
    assert tpre.MinMaxScaler().fit(X).transform(Xo).max() > 1.0
    with pytest.raises(ValueError, match="feature range"):
        tpre.MinMaxScaler(feature_range=(1, 1)).fit(X)


@pytest.mark.parametrize("kw", [{}, {"quantile_range": (10.0, 90.0)},
                                {"with_centering": False},
                                {"with_scaling": False}])
def test_robust_scaler_matches_jax(kw):
    X = _X()
    j = jpre.RobustScaler(**kw).fit(X)
    t = tpre.RobustScaler(**kw).fit(X)
    for name in ("center_", "scale_"):
        a, b = getattr(t, name), getattr(j, name)
        assert (a is None) == (b is None), name
        if a is not None:
            _close(a, b)
    _close(t.transform(X), j.transform(X), atol=1e-6)
    _close(t.inverse_transform(t.transform(X)), X, rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="quantile range"):
        tpre.RobustScaler(quantile_range=(80, 20)).fit(X)


@pytest.mark.parametrize("dist,rtol,atol", [("uniform", RTOL, 1e-6),
                                            ("normal", 1e-5, 1e-5)])
@pytest.mark.parametrize("n_quantiles", [10, 1000])
def test_quantile_transformer_matches_jax(dist, rtol, atol, n_quantiles):
    X = _X()
    kw = dict(n_quantiles=n_quantiles, output_distribution=dist)
    j = jpre.QuantileTransformer(**kw).fit(X)
    t = tpre.QuantileTransformer(**kw).fit(X)
    assert t.n_quantiles_ == j.n_quantiles_
    np.testing.assert_array_equal(t.references_, j.references_)
    _close(t.quantiles_, j.quantiles_)
    # new rows beyond the fitted range and the fitted rows themselves
    Xn = np.concatenate([X, _X(n=50, seed=4) * 1.3 - 1.0])
    _close(t.transform(Xn), j.transform(Xn), rtol=rtol, atol=atol)
    Z = t.transform(X)
    _close(t.inverse_transform(Z), j.inverse_transform(Z), rtol=rtol,
           atol=atol)
    # the round trip, away from the repeated and constant columns
    back = t.inverse_transform(Z)
    keep = [0, 1, 4]
    _close(back[:, keep], X[:, keep], rtol=1e-4, atol=1e-4)


def test_quantile_transformer_validation():
    X = _X()
    with pytest.raises(ValueError, match="output_distribution"):
        tpre.QuantileTransformer(output_distribution="bogus").fit(X)
    with pytest.raises(ValueError, match="n_quantiles"):
        tpre.QuantileTransformer(n_quantiles=0).fit(X)
    assert tpre.QuantileTransformer().fit(X[:9]).n_quantiles_ == 9


def test_unfitted_and_partial_fit_raise():
    X = _X()
    for est in (tpre.StandardScaler(), tpre.MinMaxScaler(),
                tpre.RobustScaler(), tpre.QuantileTransformer()):
        with pytest.raises(AttributeError, match="fit"):
            est.transform(X)
    for est in (tpre.StandardScaler(), tpre.MinMaxScaler()):
        with pytest.raises(NotImplementedError):
            est.partial_fit(X)
    with pytest.raises(AttributeError):
        tpre.LabelEncoder().transform([1])


def test_device_outputs_keep_tensors():
    X = _X()
    with config_context(device_outputs=True):
        for est in (tpre.MinMaxScaler(), tpre.RobustScaler(),
                    tpre.QuantileTransformer(n_quantiles=20)):
            out = est.fit(X).transform(X)
            assert isinstance(out, torch.Tensor)
            _close(out.numpy(), est.transform(X.copy()).numpy())


def test_scalers_carried_from_jax_transform_alike():
    """A JAX-fitted scaler's attributes set on the port's class give the
    same transform."""
    X = _X()
    for name, kw in (("StandardScaler", {}), ("MinMaxScaler", {}),
                     ("RobustScaler", {}),
                     ("QuantileTransformer", {"n_quantiles": 50})):
        j = getattr(jpre, name)(**kw).fit(X)
        attrs = {k: v for k, v in vars(j).items()
                 if k.endswith("_") and not k.startswith("_")}
        t = preprocessor_from_numpy(name, attrs, **kw)
        _close(t.transform(X), j.transform(X), atol=1e-6)


# ---------------------------------------------------------------------------
# the host encoders
# ---------------------------------------------------------------------------


def _cats(n=300, k=4, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 6, (n, k)) * 10 + np.arange(k)


@pytest.mark.parametrize("sparse_output", [True, False])
def test_one_hot_encoder_matches_jax(sparse_output):
    X = _cats()
    j = jpre.OneHotEncoder(sparse_output=sparse_output).fit(X)
    t = tpre.OneHotEncoder(sparse_output=sparse_output).fit(X)
    for a, b in zip(t.categories_, j.categories_):
        np.testing.assert_array_equal(a, b)
    got, want = t.transform(X), j.transform(X)
    if sparse_output:
        assert isinstance(got, tsps.SparseRows) and got.d == want.d
        np.testing.assert_array_equal(got.values, np.asarray(want.values))
        np.testing.assert_array_equal(got.cols, np.asarray(want.cols))
    else:
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(t.get_feature_names_out(),
                                  j.get_feature_names_out())


def test_one_hot_encoder_unknown_and_carry():
    X = _cats()
    Xu = X.copy()
    Xu[0, 1] = 999
    with pytest.raises(ValueError, match="unknown"):
        tpre.OneHotEncoder().fit(X).transform(Xu)
    t = tpre.OneHotEncoder(handle_unknown="ignore").fit(X)
    j = jpre.OneHotEncoder(handle_unknown="ignore").fit(X)
    got, want = t.transform(Xu), j.transform(Xu)
    np.testing.assert_array_equal(got.values, np.asarray(want.values))
    np.testing.assert_array_equal(got.cols, np.asarray(want.cols))
    assert got.values[0, 1] == 0
    with pytest.raises(ValueError, match="handle_unknown"):
        tpre.OneHotEncoder(handle_unknown="x").fit(X)
    c = preprocessor_from_numpy("OneHotEncoder",
                                {"categories_": j.categories_})
    np.testing.assert_array_equal(c.transform(X).cols,
                                  np.asarray(j.transform(X).cols))


def test_one_hot_scale_pipeline_stays_sparse():
    """One-hot → sparse StandardScaler: a container all the way, equal to
    the dense one-hot scaled column by column."""
    X = _cats(n=256)
    oh = tpre.OneHotEncoder().fit_transform(X)
    sc = tpre.StandardScaler(with_mean=False).fit(oh)
    out = sc.transform(oh)
    assert isinstance(out, tsps.SparseRows)
    dense = tpre.OneHotEncoder(sparse_output=False).fit_transform(X)
    _close(tsps.to_dense(out).numpy(),
           dense / dense.astype(np.float64).std(0).astype(np.float32),
           rtol=1e-6)


@pytest.fixture
def df():
    return pd.DataFrame({
        "A": [1, 2, 3, 4],
        "B": ["a", "a", "b", "c"],
        "C": pd.Categorical(["x", "y", "x", "x"]),
    })


def test_categorizer_matches_jax(df):
    t = tpre.Categorizer().fit(df)
    j = jpre.Categorizer().fit(df)
    assert list(t.columns_) == list(j.columns_)
    assert t.categories_ == j.categories_
    pd.testing.assert_frame_equal(t.transform(df), j.transform(df))
    custom = {"B": pd.CategoricalDtype(["a", "b", "c", "d"])}
    pd.testing.assert_frame_equal(
        tpre.Categorizer(categories=custom).fit_transform(df),
        jpre.Categorizer(categories=custom).fit_transform(df))
    with pytest.raises(TypeError):
        tpre.Categorizer().fit(np.zeros((3, 2)))


@pytest.mark.parametrize("drop_first", [False, True])
def test_dummy_encoder_matches_jax(df, drop_first):
    cat = jpre.Categorizer().fit_transform(df)
    t = tpre.DummyEncoder(drop_first=drop_first).fit(cat)
    j = jpre.DummyEncoder(drop_first=drop_first).fit(cat)
    assert t.categorical_blocks_ == j.categorical_blocks_
    out = t.transform(cat)
    pd.testing.assert_frame_equal(out, j.transform(cat))
    pd.testing.assert_frame_equal(t.inverse_transform(out), cat)
    pd.testing.assert_frame_equal(t.inverse_transform(np.asarray(out)),
                                  j.inverse_transform(np.asarray(out)))
    with pytest.raises(ValueError, match="do not match"):
        t.transform(cat[["B", "A", "C"]])
    chunk = pd.DataFrame({"A": [1, 2], "B": pd.Categorical(["a", "b"]),
                          "C": pd.Categorical(["x", "x"])})
    pd.testing.assert_frame_equal(t.transform(chunk), j.transform(chunk))


def test_ordinal_encoder_matches_jax(df):
    cat = jpre.Categorizer().fit_transform(df)
    t = tpre.OrdinalEncoder().fit(cat)
    j = jpre.OrdinalEncoder().fit(cat)
    out = t.transform(cat)
    pd.testing.assert_frame_equal(out, j.transform(cat))
    pd.testing.assert_frame_equal(t.inverse_transform(out), cat)
    chunk = pd.DataFrame({"A": [1, 2],
                          "B": pd.Categorical(["b", "c"],
                                              categories=["c", "b"]),
                          "C": pd.Categorical(["y", "x"])})
    pd.testing.assert_frame_equal(t.transform(chunk), j.transform(chunk))
    with pytest.raises(ValueError, match="categorical"):
        tpre.OrdinalEncoder(columns=["A"]).fit(cat)


@pytest.mark.parametrize("y", [[3, 1, 3, 7, 1], ["b", "a", "c", "a"]])
def test_label_encoder_matches_jax(y):
    t = tpre.LabelEncoder().fit(y)
    j = jpre.LabelEncoder().fit(y)
    np.testing.assert_array_equal(t.classes_, j.classes_)
    codes = t.transform(y)
    np.testing.assert_array_equal(codes, j.transform(y))
    np.testing.assert_array_equal(t.inverse_transform(codes), np.asarray(y))
    np.testing.assert_array_equal(t.fit_transform(y), codes)
    with pytest.raises(ValueError, match="unseen"):
        t.transform([y[0], "zzz" if isinstance(y[0], str) else 99])


def test_exports_match_the_jax_package():
    assert sorted(tpre.__all__) == sorted(jpre.__all__)

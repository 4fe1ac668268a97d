"""Scalers and encoders of the PyTorch port (counterpart of
``dask_ml_tpu/preprocessing/data.py``).

Two tiers, as in the JAX package:

- **Device tier** (:class:`StandardScaler`, :class:`MinMaxScaler`,
  :class:`RobustScaler`, :class:`QuantileTransformer`): fit is a column
  reduction over the staged rows on the device (moments, extrema, exact
  percentiles from one sort along the rows), transform one elementwise
  expression. A sparse ``StandardScaler`` takes its column moments from
  the container's nonzeros through the pullback (K6-b on the card, whose
  fixed-point sums repeat their bits) and scales the container without
  densifying it.
- **Host tier** (:class:`Categorizer`, :class:`DummyEncoder`,
  :class:`OrdinalEncoder` on DataFrames; :class:`OneHotEncoder` on
  arrays, emitting the host :class:`~dask_ml_tpu_torch.ops.sparse.
  SparseRows`): categorical bookkeeping in numpy and pandas. pandas is
  imported inside the frame encoders' methods, never when this module
  loads: the card's machine may not have it.

Every class stands on the port's estimator base (the card's machine has
no scikit-learn) with scikit-learn's constructor and attributes.
"""

from __future__ import annotations

import numpy as np
import torch

from dask_ml_tpu_torch.base import BaseEstimator, TransformerMixin
from dask_ml_tpu_torch.config import get_config, maybe_host
from dask_ml_tpu_torch.ops import sparse as sparse_ops
from dask_ml_tpu_torch.parallel.sharding import is_sparse_input, prepare_data
from dask_ml_tpu_torch.utils._utils import handle_zeros_in_scale
from dask_ml_tpu_torch.utils.validation import check_array

#: the QuantileTransformer's margin at the extreme quantiles
BOUNDS_THRESHOLD = 1e-7


def _check_fitted(est, attr: str) -> None:
    if not hasattr(est, attr):
        raise AttributeError(
            f"This {type(est).__name__} instance is not fitted yet; call "
            "fit first")


def _mean_var(X, w):
    """Weighted column mean and variance, and the scale: ``sqrt(var)`` with
    constant columns (variance 0) dividing by 1."""
    sw = torch.clamp(w.sum(), min=1.0)
    mean = (w[:, None] * X).sum(0) / sw
    var = (w[:, None] * (X - mean) ** 2).sum(0) / sw
    return mean, var, _scale_of(var)


def _scale_of(var):
    return torch.sqrt(torch.where(var == 0.0, torch.ones_like(var), var))


def _standardize(X, mean, scale):
    return (X - mean) / scale


def _on(a, like):
    """A fitted statistic (host array or device tensor) as a tensor on
    ``like``'s device, in its dtype or f32 if that is narrower (a bf16
    staged X is scaled in f32, as ``jnp`` promotes the pair)."""
    return torch.as_tensor(a).to(
        device=like.device, dtype=torch.promote_types(like.dtype,
                                                      torch.float32))


def _host(t):
    return t.float().cpu().numpy()



def _staged(X):
    """Validated dense ``X`` staged on the configured device."""
    return prepare_data(check_array(X)).X


def _min_max(X, w):
    """Column minimum and maximum over the rows of positive weight."""
    big = torch.finfo(X.dtype).max
    valid = (w > 0)[:, None]
    mn = torch.where(valid, X, big).amin(dim=0)
    mx = torch.where(valid, X, -big).amax(dim=0)
    return mn, mx


def percentiles(X, q):
    """Exact column percentiles of ``X`` (n, d) at ``q`` (percents), as
    ``jnp.percentile(X, q, axis=0)`` computes them (numpy's "linear"
    rule): the rows sorted once along dim 0, then for each ``q`` the
    index ``q · ((n − 1) / 100)`` in f32 (XLA folds jax's ``q / 100 ·
    (n − 1)`` into one constant, and the index's bits decide the blend)
    and a blend of the rows at its floor and ceiling, weighted by its
    fraction. Returns (len(q), d) f32 where ``X`` lies.
    (``torch.quantile`` refuses inputs of more than 2^24 elements.)"""
    Xs = torch.sort(X.to(torch.float32), dim=0).values
    n = Xs.shape[0]
    step = ((torch.tensor(float(n), dtype=torch.float32) - 1.0)
            / torch.tensor(100.0, dtype=torch.float32))
    pos = torch.as_tensor(np.asarray(q, dtype=np.float32),
                          device=Xs.device) * step.to(Xs.device)
    low, high = torch.floor(pos), torch.ceil(pos)
    high_w = pos - low
    low_w = 1.0 - high_w
    low_i = low.clamp(0, n - 1).to(torch.int64)
    high_i = high.clamp(0, n - 1).to(torch.int64)
    return Xs[low_i] * low_w[:, None] + Xs[high_i] * high_w[:, None]


def interp(x, xp, fp):
    """``jnp.interp`` row by row: for each row ``r`` the piecewise-linear
    interpolant through ``(xp[r], fp[r])`` at ``x[r]``. Shapes ``(c, n)``,
    ``(c, m)``, ``(c, m)``; ``xp`` rows ascending. As jax does it: the
    right-sided ``searchsorted`` index clipped to ``[1, m − 1]``, the
    slope's step ``dx`` replaced by 1 where ``|dx| ≤ spacing(eps)`` (a
    repeated ``xp`` then takes ``fp`` at the left knot), and ``fp``'s ends
    outside ``xp``'s range."""
    m = xp.shape[-1]
    i = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
    i = i.clamp(max=m - 1).clamp(min=1) if m > 1 else torch.zeros_like(i)
    im = (i - 1).clamp(min=0)
    xp_lo, fp_lo = xp.gather(-1, im), fp.gather(-1, im)
    df = fp.gather(-1, i) - fp_lo
    dx = xp.gather(-1, i) - xp_lo
    delta = x - xp_lo
    eps = float(np.spacing(np.finfo(np.float32).eps))
    dx0 = dx.abs() <= eps
    f = torch.where(dx0, fp_lo,
                    fp_lo + (delta / torch.where(dx0, torch.ones_like(dx),
                                                 dx)) * df)
    f = torch.where(x < xp[..., :1], fp[..., :1], f)
    return torch.where(x > xp[..., -1:], fp[..., -1:], f)


# ---------------------------------------------------------------------------
# device tier
# ---------------------------------------------------------------------------


class StandardScaler(TransformerMixin, BaseEstimator):
    """Standardize features by removing the mean and scaling to unit
    variance (scikit-learn's surface).

    Sparse input (scipy CSR or a :class:`~dask_ml_tpu_torch.ops.sparse.
    SparseRows`) needs ``with_mean=False`` (centering would make every
    zero −mean); its variances come from the nonzeros
    (:func:`~dask_ml_tpu_torch.ops.sparse.column_mean_var`, on the pullback
    kernel on the card), a container that stores one column twice in a
    row is refused, and ``transform`` returns the staged container scaled
    column by column, never densified.

    Parameters
    ----------
    copy : bool, default True — accepted for signature parity (the
        transform always returns a new array).
    with_mean : bool, default True
    with_std : bool, default True

    Attributes
    ----------
    mean_, var_, scale_ : (n_features,) arrays, None where disabled —
        host numpy, or device tensors under ``device_outputs``
    n_samples_seen_ : int
    n_features_in_ : int
    """

    def __init__(self, copy=True, with_mean=True, with_std=True):
        self.copy = copy
        self.with_mean = with_mean
        self.with_std = with_std

    def fit(self, X, y=None):
        if is_sparse_input(X):
            if self.with_mean:
                raise ValueError(
                    "Cannot center sparse data (with_mean=True would "
                    "densify every zero to -mean); construct "
                    "StandardScaler(with_mean=False) for sparse inputs")
            data = prepare_data(check_array(X, accept_sparse=True))
            if bool(sparse_ops.has_duplicate_slots(data.X)):
                raise ValueError(
                    "this sparse container stores some column twice in "
                    "one row (duplicate slots sum in the linear "
                    "contractions, but a column's variance cannot be "
                    "taken slot-wise over them); re-canonicalize through "
                    "scipy first: csr.sum_duplicates()")
            mean, var, _ = sparse_ops.column_mean_var(data.X, data.weights)
            scale = _scale_of(var)
        else:
            data = prepare_data(check_array(X))
            mean, var, scale = _mean_var(data.X, data.weights)
        if not get_config()["device_outputs"]:
            mean, var, scale = _host(mean), _host(var), _host(scale)
        self.mean_ = mean if self.with_mean else None
        if self.with_std:
            self.var_, self.scale_ = var, scale
        else:
            self.var_ = self.scale_ = None
        self.n_samples_seen_ = data.n
        self.n_features_in_ = data.n_features
        return self

    def partial_fit(self, X, y=None):
        raise NotImplementedError(
            "partial_fit is unsupported, as in the reference "
            "(preprocessing/data.py:51-52)")

    def _sparse_transform(self, X):
        if self.with_mean:
            raise ValueError(
                "Cannot center sparse data; this scaler was constructed "
                "with with_mean=True")
        A = prepare_data(check_array(X, accept_sparse=True)).X
        if self.with_std:
            A = sparse_ops.scale_columns(A, self.scale_)
        return A

    def transform(self, X, y=None, copy=None):
        _check_fitted(self, "n_samples_seen_")
        if is_sparse_input(X):
            return self._sparse_transform(X)
        Xs = _staged(X)
        if self.with_mean and self.with_std:
            Xs = _standardize(Xs, _on(self.mean_, Xs), _on(self.scale_, Xs))
        else:
            if self.with_mean:
                Xs = Xs - _on(self.mean_, Xs)
            if self.with_std:
                Xs = Xs / _on(self.scale_, Xs)
        return maybe_host(Xs)

    def inverse_transform(self, X, copy=None):
        _check_fitted(self, "n_samples_seen_")
        Xs = _staged(X)
        if self.with_std:
            Xs = Xs * _on(self.scale_, Xs)
        if self.with_mean:
            Xs = Xs + _on(self.mean_, Xs)
        return maybe_host(Xs)


class MinMaxScaler(TransformerMixin, BaseEstimator):
    """Scale each feature to ``feature_range`` (scikit-learn's surface).
    The extrema are taken on the device over the rows of positive weight;
    the scale is formed on the host in float64 (constant features scale
    by 1); ``clip=True`` clips the transform to the range."""

    def __init__(self, feature_range=(0, 1), *, copy=True, clip=False):
        self.feature_range = feature_range
        self.copy = copy
        self.clip = clip

    def fit(self, X, y=None):
        lo, hi = self.feature_range
        if lo >= hi:
            raise ValueError(
                "Minimum of desired feature range must be smaller than "
                "maximum.")
        data = prepare_data(check_array(X))
        data_min, data_max = (_host(a) for a in _min_max(data.X,
                                                         data.weights))
        data_range = data_max - data_min
        scale = (hi - lo) / handle_zeros_in_scale(data_range)
        self.data_min_ = data_min
        self.data_max_ = data_max
        self.data_range_ = data_range
        self.scale_ = scale
        self.min_ = lo - data_min * scale
        self.n_samples_seen_ = data.n
        self.n_features_in_ = data.n_features
        return self

    def partial_fit(self, X, y=None):
        raise NotImplementedError(
            "partial_fit is unsupported, as in the reference "
            "(preprocessing/data.py:100-101)")

    def transform(self, X, y=None, copy=None):
        _check_fitted(self, "scale_")
        Xs = _staged(X)
        out = Xs * _on(self.scale_, Xs) + _on(self.min_, Xs)
        if self.clip:
            lo, hi = self.feature_range
            out = torch.clamp(out, lo, hi)
        return maybe_host(out)

    def inverse_transform(self, X, y=None, copy=None):
        _check_fitted(self, "scale_")
        Xs = _staged(X)
        return maybe_host((Xs - _on(self.min_, Xs)) / _on(self.scale_, Xs))


class RobustScaler(TransformerMixin, BaseEstimator):
    """Scale features by statistics robust to outliers: the median and the
    ``quantile_range`` percentiles, exact (:func:`percentiles`), over the
    staged rows. ``unit_variance`` is accepted for signature parity and
    ignored, as in the JAX package."""

    def __init__(self, *, with_centering=True, with_scaling=True,
                 quantile_range=(25.0, 75.0), copy=True,
                 unit_variance=False):
        self.with_centering = with_centering
        self.with_scaling = with_scaling
        self.quantile_range = quantile_range
        self.copy = copy
        self.unit_variance = unit_variance

    def fit(self, X, y=None):
        q_min, q_max = self.quantile_range
        if not 0 <= q_min <= q_max <= 100:
            raise ValueError(
                f"Invalid quantile range: {self.quantile_range}")
        data = prepare_data(check_array(X))
        qs = _host(percentiles(data.X, [q_min, 50.0, q_max]))
        self.center_ = qs[1] if self.with_centering else None
        self.scale_ = (handle_zeros_in_scale(qs[2] - qs[0])
                       if self.with_scaling else None)
        self.n_features_in_ = data.n_features
        return self

    def transform(self, X):
        _check_fitted(self, "scale_")
        Xs = _staged(X)
        if self.with_centering:
            Xs = Xs - _on(self.center_, Xs)
        if self.with_scaling:
            Xs = Xs / _on(self.scale_, Xs)
        return maybe_host(Xs)

    def inverse_transform(self, X):
        _check_fitted(self, "scale_")
        Xs = _staged(X)
        if self.with_scaling:
            Xs = Xs * _on(self.scale_, Xs)
        if self.with_centering:
            Xs = Xs + _on(self.center_, Xs)
        return maybe_host(Xs)


def _norm_clip():
    """The normal output's clip range: ``norm.ppf(BOUNDS_THRESHOLD −
    spacing(1))`` in f32 and its mirror. The mirror is the negation: in
    f32, ``1 − (BOUNDS_THRESHOLD − spacing(1))`` rounds to ``1 − 2^-23``,
    whose ``ndtri`` (5.1666) is not the ppf of the mirrored probability
    (5.1993, which the JAX package and scikit-learn clip to)."""
    lo = float(torch.special.ndtri(torch.tensor(
        BOUNDS_THRESHOLD - np.spacing(1), dtype=torch.float32)))
    return lo, -lo


def _quantile_transform(X, quantiles, references, inverse: bool,
                        normal: bool):
    """Each column of ``X`` (n, d) through its monotone interpolant: the
    fitted ``quantiles`` (m, d) against the shared ``references`` (m,).
    Forward, the mean of the interpolant and of its mirror (``-x``
    through the reversed, negated knots), which puts a value repeated
    across quantiles at the middle of their references; then the exact
    (uniform) or margin (normal) overrides at the extreme quantiles, the
    upper one first, and for normal output ``norm.ppf`` clipped."""
    x = X.T  # (d, n)
    q = quantiles.T  # (d, m)
    ref = references[None, :].expand_as(q)
    if inverse:
        if normal:
            x = torch.special.ndtr(x)
            out = interp(x, ref, q)
            out = torch.where(x + BOUNDS_THRESHOLD > 1.0, q[:, -1:], out)
            out = torch.where(x - BOUNDS_THRESHOLD < 0.0, q[:, :1], out)
        else:
            out = interp(x, ref, q)
            out = torch.where(x == 1.0, q[:, -1:], out)
            out = torch.where(x == 0.0, q[:, :1], out)
        return out.T
    a = interp(x, q, ref)
    b = interp(-x, -q.flip(-1), -ref.flip(-1))
    out = 0.5 * (a - b)
    one, zero = torch.ones_like(out), torch.zeros_like(out)
    if normal:
        out = torch.where(x + BOUNDS_THRESHOLD > q[:, -1:], one, out)
        out = torch.where(x - BOUNDS_THRESHOLD < q[:, :1], zero, out)
        lo, hi = _norm_clip()
        out = torch.clamp(torch.special.ndtri(out), lo, hi)
    else:
        out = torch.where(x == q[:, -1:], one, out)
        out = torch.where(x == q[:, :1], zero, out)
    return out.T


class QuantileTransformer(TransformerMixin, BaseEstimator):
    """Transform each feature through its quantiles to a uniform or a
    normal distribution (scikit-learn's surface). The quantiles are exact
    (:func:`percentiles` over every staged row); ``subsample`` and
    ``ignore_implicit_zeros`` are accepted for signature parity and
    ignored, as in the JAX package."""

    def __init__(self, *, n_quantiles=1000, output_distribution="uniform",
                 ignore_implicit_zeros=False, subsample=10_000,
                 random_state=None, copy=True):
        self.n_quantiles = n_quantiles
        self.output_distribution = output_distribution
        self.ignore_implicit_zeros = ignore_implicit_zeros
        self.subsample = subsample
        self.random_state = random_state
        self.copy = copy

    def fit(self, X, y=None):
        if self.output_distribution not in ("uniform", "normal"):
            raise ValueError(
                f"'output_distribution' has to be either 'normal' or "
                f"'uniform'. Got '{self.output_distribution}' instead.")
        if int(self.n_quantiles) < 1:
            raise ValueError(
                f"n_quantiles must be at least 1, got {self.n_quantiles}")
        data = prepare_data(check_array(X))
        n_quantiles = min(int(self.n_quantiles), data.n)
        self.n_quantiles_ = n_quantiles
        self.references_ = np.linspace(0, 1, n_quantiles, endpoint=True)
        self.quantiles_ = _host(percentiles(data.X,
                                            self.references_ * 100.0))
        self.n_features_in_ = data.n_features
        return self

    def _transform(self, X, inverse: bool):
        _check_fitted(self, "quantiles_")
        Xs = _staged(X).to(torch.float32)
        out = _quantile_transform(
            Xs, _on(self.quantiles_, Xs), _on(self.references_, Xs),
            inverse=inverse, normal=self.output_distribution == "normal")
        return maybe_host(out.contiguous())

    def transform(self, X):
        return self._transform(X, inverse=False)

    def inverse_transform(self, X):
        return self._transform(X, inverse=True)


# ---------------------------------------------------------------------------
# host tier: the frame encoders (pandas, imported on use) and OneHotEncoder
# ---------------------------------------------------------------------------


def _categorical_dtype():
    from pandas.api.types import CategoricalDtype

    return CategoricalDtype


class Categorizer(TransformerMixin, BaseEstimator):
    """Convert columns of a DataFrame to categorical dtype
    (``categories_`` maps each converted column to its dtype)."""

    def __init__(self, categories=None, columns=None):
        self.categories = categories
        self.columns = columns

    def _check_array(self, X):
        import pandas as pd

        if not isinstance(X, pd.DataFrame):
            raise TypeError(
                f"Expected a pandas DataFrame, got {type(X)} instead")
        return X

    def fit(self, X, y=None):
        import pandas as pd

        CategoricalDtype = _categorical_dtype()
        X = self._check_array(X)
        if self.categories is not None:
            columns = pd.Index(self.categories)
            categories = dict(self.categories)
        else:
            if self.columns is None:
                try:
                    columns = X.select_dtypes(
                        include=["object", "str", "category"]).columns
                except TypeError:
                    # pandas < 3 maps "str" to numpy's str_ dtype, which it
                    # refuses here; object covers strings there
                    columns = X.select_dtypes(
                        include=["object", "category"]).columns
            else:
                columns = pd.Index(self.columns)
            categories = {}
            for name in columns:
                col = X[name]
                if not isinstance(col.dtype, CategoricalDtype):
                    col = col.astype("category")
                categories[name] = col.dtype
        self.columns_ = columns
        self.categories_ = categories
        return self

    def transform(self, X, y=None):
        CategoricalDtype = _categorical_dtype()
        _check_fitted(self, "categories_")
        X = self._check_array(X).copy()
        for k, dtype in self.categories_.items():
            if not isinstance(dtype, CategoricalDtype):
                dtype = CategoricalDtype(*dtype)
            X[k] = X[k].astype(dtype)
        return X


def _categorical_columns(X, columns):
    """The categorical columns of ``X`` (all of them when ``columns`` is
    None); a named column that is not categorical raises."""
    import pandas as pd

    CategoricalDtype = _categorical_dtype()
    if columns is None:
        return X.select_dtypes(include=["category"]).columns
    for column in columns:
        if not isinstance(X[column].dtype, CategoricalDtype):
            raise ValueError(f"Column {column!r} must be categorical")
    return pd.Index(columns)


def _check_frame(est, X):
    import pandas as pd

    _check_fitted(est, "columns_")
    if not isinstance(X, pd.DataFrame):
        raise TypeError(f"Unexpected type {type(X)}")
    if not X.columns.equals(est.columns_):
        raise ValueError(
            f"Columns of 'X' do not match the training columns. "
            f"Got {X.columns!r}, expected {est.columns_!r}")


class DummyEncoder(TransformerMixin, BaseEstimator):
    """One-hot encode the categorical columns of a DataFrame (attributes as
    the JAX package's, with each column's block of output columns, which
    ``inverse_transform`` reads back)."""

    def __init__(self, columns=None, drop_first=False):
        self.columns = columns
        self.drop_first = drop_first

    def fit(self, X, y=None):
        import pandas as pd

        self.columns_ = X.columns
        columns = _categorical_columns(X, self.columns)
        self.categorical_columns_ = columns
        self.non_categorical_columns_ = X.columns.drop(columns)
        self.dtypes_ = {col: X[col].dtype for col in columns}
        left = len(self.non_categorical_columns_)
        self.categorical_blocks_ = {}
        for col in columns:
            right = left + len(X[col].cat.categories)
            if self.drop_first:
                right -= 1
            self.categorical_blocks_[col], left = slice(left, right), right
        self.transformed_columns_ = pd.get_dummies(
            X.iloc[:1], columns=list(columns),
            drop_first=self.drop_first).columns
        return self

    def transform(self, X, y=None):
        import pandas as pd

        _check_frame(self, X)
        # every categorical column takes the dtype recorded at fit, so a
        # chunk categorized on its own gives the same dummy columns (values
        # outside the fitted categories become all-zero rows)
        X = X.copy()
        for col in self.categorical_columns_:
            X[col] = X[col].astype(self.dtypes_[col])
        return pd.get_dummies(X, columns=list(self.categorical_columns_),
                              drop_first=self.drop_first)

    def inverse_transform(self, X):
        import pandas as pd

        _check_fitted(self, "columns_")
        if isinstance(X, np.ndarray):
            X = pd.DataFrame(X, columns=self.transformed_columns_)
        non_cat = X[list(self.non_categorical_columns_)]
        cats = {}
        for col in self.categorical_columns_:
            dtype = self.dtypes_[col]
            block = np.asarray(X.iloc[:, self.categorical_blocks_[col]])
            codes = block.argmax(axis=1)
            if self.drop_first:
                # an all-zero row is the dropped first category
                codes = np.where(block.sum(axis=1) > 0, codes + 1, 0)
            cats[col] = pd.Categorical.from_codes(
                codes, dtype.categories, ordered=dtype.ordered)
        out = non_cat.assign(**cats)
        return out[list(self.columns_)]


class OneHotEncoder(TransformerMixin, BaseEstimator):
    """One-hot encode categorical feature columns into the sparse container.

    ``transform`` emits a host :class:`~dask_ml_tpu_torch.ops.sparse.
    SparseRows` with one slot per input column (every row has exactly one
    nonzero per column: no slot is wasted), which the GLMs, the sparse
    ``StandardScaler`` and the search take as they are, so the one-hot →
    scale → fit pipeline never makes a dense row. ``sparse_output=False``
    returns the dense numpy one-hot. ``handle_unknown="ignore"`` gives an
    unseen category an inert slot (value 0: the row lacks that column's
    indicator); ``"error"`` (the default) raises."""

    def __init__(self, categories="auto", dtype=np.float32,
                 handle_unknown="error", sparse_output=True):
        self.categories = categories
        self.dtype = dtype
        self.handle_unknown = handle_unknown
        self.sparse_output = sparse_output

    def _check_X(self, X):
        if hasattr(X, "iloc"):
            X = X.values
        X = np.asarray(X)
        if X.ndim != 2:
            raise ValueError(
                f"Expected 2D array of categorical columns, got {X.ndim}D")
        return X

    def fit(self, X, y=None):
        if self.handle_unknown not in ("error", "ignore"):
            raise ValueError(
                f"handle_unknown must be 'error' or 'ignore', got "
                f"{self.handle_unknown!r}")
        X = self._check_X(X)
        n_cols = X.shape[1]
        # a str test first: an ndarray `categories` would compare to "auto"
        # elementwise
        if isinstance(self.categories, str) and self.categories == "auto":
            cats = [np.unique(X[:, j]) for j in range(n_cols)]
        else:
            if len(self.categories) != n_cols:
                raise ValueError(
                    f"categories has {len(self.categories)} entries for "
                    f"{n_cols} columns")
            cats = [np.asarray(c) for c in self.categories]
        self.categories_ = cats
        self.n_features_in_ = n_cols
        self._index_categories()
        return self

    def _index_categories(self):
        """The lookup tables of ``categories_``: column j's indicators are
        output columns ``offsets[j] .. offsets[j] + len(cats[j]) - 1``."""
        sizes = np.array([len(c) for c in self.categories_], dtype=np.int64)
        self._offsets = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        self._n_out = int(sizes.sum())
        self._sorters = [np.argsort(c, kind="stable")
                         for c in self.categories_]

    def _column_codes(self, col, j):
        """Codes of one raw column against the fitted categories; -1 marks
        an unknown value (an inert slot under handle_unknown='ignore')."""
        cat, sorter = self.categories_[j], self._sorters[j]
        pos = np.clip(np.searchsorted(cat, col, sorter=sorter), 0,
                      len(cat) - 1)
        code = sorter[pos]
        found = cat[code] == col
        if not found.all():
            if self.handle_unknown == "error":
                bad = np.unique(np.asarray(col)[~found])[:5]
                raise ValueError(
                    f"Found unknown categories {bad.tolist()} in column "
                    f"{j} during transform")
            code = np.where(found, code, -1)
        return code

    def transform(self, X, y=None):
        _check_fitted(self, "categories_")
        X = self._check_X(X)
        if X.shape[1] != self.n_features_in_:
            raise ValueError(
                f"X has {X.shape[1]} features, but OneHotEncoder was "
                f"fitted with {self.n_features_in_}")
        n, k = X.shape
        values = np.ones((n, k), np.dtype(self.dtype))
        cols = np.zeros((n, k), np.int32)
        for j in range(k):
            code = self._column_codes(X[:, j], j)
            known = code >= 0
            cols[:, j] = np.where(known, self._offsets[j] + code, 0)
            if not known.all():
                values[:, j] = np.where(known, values[:, j], 0)
        out = sparse_ops.SparseRows(values, cols, self._n_out)
        if self.sparse_output:
            return out
        dense = np.zeros((n, self._n_out), values.dtype)
        np.add.at(dense, (np.arange(n)[:, None], cols), values)
        return dense

    def get_feature_names_out(self, input_features=None):
        names = []
        for j, cat in enumerate(self.categories_):
            base = (input_features[j] if input_features is not None
                    else f"x{j}")
            names.extend(f"{base}_{c}" for c in cat)
        return np.asarray(names, dtype=object)


class OrdinalEncoder(TransformerMixin, BaseEstimator):
    """Integer-encode the categorical columns of a DataFrame against the
    categories recorded at fit (an unseen value becomes -1)."""

    def __init__(self, columns=None):
        self.columns = columns

    def fit(self, X, y=None):
        columns = _categorical_columns(X, self.columns)
        self.columns_ = X.columns
        self.categorical_columns_ = columns
        self.non_categorical_columns_ = X.columns.drop(columns)
        self.dtypes_ = {col: X[col].dtype for col in columns}
        return self

    def transform(self, X, y=None):
        _check_frame(self, X)
        X = X.copy()
        for col in self.categorical_columns_:
            X[col] = X[col].astype(self.dtypes_[col]).cat.codes
        return X

    def inverse_transform(self, X):
        import pandas as pd

        _check_fitted(self, "columns_")
        if isinstance(X, np.ndarray):
            X = pd.DataFrame(X, columns=self.columns_)
        X = X.copy()
        for col in self.categorical_columns_:
            dtype = self.dtypes_[col]
            X[col] = pd.Categorical.from_codes(
                np.asarray(X[col], dtype=int), dtype.categories,
                ordered=dtype.ordered)
        return X


__all__ = ["StandardScaler", "MinMaxScaler", "RobustScaler",
           "QuantileTransformer", "Categorizer", "DummyEncoder",
           "OneHotEncoder", "OrdinalEncoder", "handle_zeros_in_scale",
           "percentiles", "interp"]

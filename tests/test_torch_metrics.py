"""The PyTorch port's metrics on zero denominators, held against the JAX
package on the CPU.

Both packages get the same numpy inputs: a constant ``y_true`` with a
matching and an unmatched ``y_pred``, and all-zero ``sample_weight``. The
JAX expressions follow IEEE rules (0/0 is NaN, x/0 is ±inf); the port must
give NaN where they give NaN and an infinity of the same sign where they
give one. Every other input keeps the bits of the port's previous numpy
expressions (``np.average`` with weights), which the last tests pin.
"""

import numpy as np
import pytest

from dask_ml_tpu import linear_model as jlm
from dask_ml_tpu import metrics as jm
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch import linear_model as tlm
from dask_ml_tpu_torch import metrics as tm

N = 8
ONES = np.ones(N)


def _same_special(got, want):
    """NaN against NaN, an infinity against one of the same sign, a finite
    value against a finite value within f32 rounding."""
    if np.isnan(want):
        return np.isnan(got)
    if np.isinf(want):
        return np.isinf(got) and np.sign(got) == np.sign(want)
    return np.isfinite(got) and np.isclose(got, want, rtol=1e-6)


REGRESSION = ["r2_score", "mean_squared_error", "mean_absolute_error"]

CASES = {
    "constant_matched": (ONES, ONES, None),
    "constant_unmatched": (ONES, ONES + 1, None),
    "constant_unmatched_below": (ONES, ONES - 3, None),
    "zero_weight": (np.arange(N, dtype=float), np.arange(N) + 0.5,
                    np.zeros(N)),
    "zero_weight_constant": (ONES, ONES, np.zeros(N)),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("name", REGRESSION)
def test_regression_zero_denominators_match_jax(name, case):
    y_true, y_pred, w = CASES[case]
    got = getattr(tm, name)(y_true, y_pred, sample_weight=w)
    want = getattr(jm, name)(y_true, y_pred, sample_weight=w)
    assert isinstance(got, float)
    assert _same_special(got, want), (got, want)


def test_r2_constant_target_is_nan_or_minus_inf():
    assert np.isnan(tm.r2_score(ONES, ONES))
    assert tm.r2_score(ONES, ONES + 1) == -np.inf
    assert tm.r2_score(ONES, ONES - 1) == -np.inf


@pytest.mark.parametrize("normalize", [True, False])
@pytest.mark.parametrize("labels", ["ints", "strings"])
def test_accuracy_zero_weight_matches_jax(normalize, labels):
    y = np.array([0, 1] * (N // 2))
    p = np.array([0, 0, 1, 1] * (N // 4))
    if labels == "strings":
        y, p = y.astype(str), p.astype(str)
    w = np.zeros(N)
    got = tm.accuracy_score(y, p, normalize=normalize, sample_weight=w)
    want = jm.accuracy_score(y, p, normalize=normalize, sample_weight=w)
    assert _same_special(got, want), (got, want)
    if normalize:
        assert np.isnan(got)
    else:
        assert got == 0.0


@pytest.mark.parametrize("proba", ["binary_1d", "multiclass_2d"])
def test_log_loss_zero_weight_matches_jax(proba):
    rng = np.random.RandomState(0)
    if proba == "binary_1d":
        y = np.array([0, 1] * (N // 2))
        p = rng.uniform(0.1, 0.9, N)
    else:
        y = np.arange(N) % 3
        p = rng.dirichlet(np.ones(3), N)
    w = np.zeros(N)
    got = tm.log_loss(y, p, sample_weight=w)
    want = jm.log_loss(y, p, sample_weight=w)
    assert np.isnan(got) and np.isnan(want)


def test_linear_regression_score_on_constant_target_matches_jax():
    """``LinearRegression.score`` is R²: on a constant target the fit's
    predictions miss it by rounding, so both packages give −inf (or NaN
    where every prediction lands on it exactly)."""
    rng = np.random.RandomState(3)
    X = rng.randn(64, 3).astype(np.float32)
    y = np.full(64, 2.5, np.float32)
    with config_context(device="cpu"):
        got = tlm.LinearRegression(solver="lbfgs").fit(X, y).score(X, y)
    want = jlm.LinearRegression(solver="lbfgs").fit(X, y).score(X, y)
    assert _same_special(got, want), (got, want)
    assert not np.isfinite(got)


@pytest.mark.parametrize("name", REGRESSION)
@pytest.mark.parametrize("weighted", [False, True])
def test_regression_keeps_its_bits_elsewhere(name, weighted):
    """Away from a zero denominator the repair changes no bit: the port's
    value equals the numpy expression it had before (``np.average`` with
    weights, a plain division)."""
    rng = np.random.RandomState(11)
    a, b = rng.randn(200), rng.randn(200)
    w = rng.uniform(0.1, 2.0, 200) if weighted else np.ones(200)
    if name == "mean_squared_error":
        before = float(np.average((a - b) ** 2, weights=w))
    elif name == "mean_absolute_error":
        before = float(np.average(np.abs(a - b), weights=w))
    else:
        num = float(np.sum(w * (a - b) ** 2))
        den = float(np.sum(w * (a - np.average(a, weights=w)) ** 2))
        before = 1.0 - num / den
    got = getattr(tm, name)(a, b, sample_weight=w if weighted else None)
    assert got == before
    want = getattr(jm, name)(a, b, sample_weight=w if weighted else None)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_classification_keeps_its_bits_elsewhere():
    rng = np.random.RandomState(12)
    y = rng.randint(0, 2, 300)
    pred = rng.randint(0, 2, 300)
    w = rng.uniform(0.1, 2.0, 300).astype(np.float32)
    match = (y == pred).astype(np.float64)
    w64 = w.astype(np.float64)
    assert tm.accuracy_score(y, pred, sample_weight=w) == float(
        np.dot(match, w64)) / float(w64.sum())
    p = rng.uniform(0.05, 0.95, 300)
    eps = np.finfo(np.float32).eps
    pc = np.clip(p.astype(np.float32), eps, 1.0 - eps)
    ll = -(y * np.log(pc) + (1.0 - y) * np.log(1.0 - pc))
    assert tm.log_loss(y, p, sample_weight=w) == float(
        np.average(ll, weights=w))

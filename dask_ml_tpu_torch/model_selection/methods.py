"""Task bodies for the hyper-parameter search driver of the PyTorch port (a
port of ``dask_ml_tpu/model_selection/methods.py``; the card's machine has
no scikit-learn, so :class:`FitFailedWarning` is the port's own).

The reference stores these callables inside hand-built dask graph tuples
(reference: model_selection/methods.py). Here they are invoked by the
host-side thread-pool driver in :mod:`._search`; the semantics carried over
verbatim are the ones the reference's test-suite pins down:

- ``FIT_FAILURE`` sentinel + ``error_score`` handling: any exception inside a
  fit is caught, warned as ``FitFailedWarning``, and propagated as a sentinel
  that scoring converts into the numeric ``error_score``
  (reference: methods.py:50-59, 194-249).
- per-task fit/score wall-times surfaced into ``cv_results_``
  (reference: methods.py:213-224, 261-269 → :338-339).
- ``create_cv_results``: sklearn-compatible results dict with masked param
  arrays, mean/std over splits, optional iid weighting, and min-rank
  tie-breaking (reference: methods.py:286-368).

Estimator copying uses ``copy.deepcopy`` — the same choice the reference makes
because ``sklearn.clone`` is not thread-safe (reference:
model_selection/utils.py:71-76); our driver is threaded too.
"""

from __future__ import annotations

import copy
import warnings
from timeit import default_timer

import numpy as np
from scipy.stats import rankdata


class FitFailedWarning(RuntimeWarning, UserWarning):
    """A fit in a search failed and its score was set to ``error_score``
    (scikit-learn's ``sklearn.exceptions.FitFailedWarning``)."""


class FitFailure:
    """Singleton marking a failed fit (reference: methods.py:50-53)."""

    _instance = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self):
        return "FIT_FAILURE"


FIT_FAILURE = FitFailure()


def warn_fit_failure(error_score, exc):
    warnings.warn(
        "Classifier fit failed. The score on this train-test partition for "
        f"these parameters will be set to {error_score}. Details:\n{exc!r}",
        FitFailedWarning,
    )


def copy_estimator(est):
    """Thread-safe estimator copy (reference: model_selection/utils.py:71-76)."""
    return copy.deepcopy(est)


def set_params(est, params):
    est.set_params(**params)
    return est


def _run_attempts(attempt, retry_policy, label):
    """Run one fit attempt, optionally under a transient-error retry policy
    (each attempt starts from a FRESH estimator copy inside ``attempt``, so
    a partially-fitted failure never leaks into the retry). Non-transient
    errors propagate immediately and fall into ``error_score`` handling
    exactly as before."""
    if retry_policy is None:
        return attempt()
    return retry_policy.run(attempt, kind="search-fit", detail=label)


def fit(est, X, y, params=None, fit_params=None, error_score="raise",
        retry_policy=None):
    """Fit a (copied) estimator; returns ``(fitted_or_FIT_FAILURE, fit_time)``
    (reference: methods.py:194-224). ``retry_policy`` retries transient
    failures (host I/O, device transfer) before the ``error_score``
    degradation applies."""
    start = default_timer()

    def attempt():
        e2 = copy_estimator(est)
        if params:
            set_params(e2, params)
        if X is FIT_FAILURE:
            raise ValueError("Upstream pipeline stage failed to fit")
        e2.fit(X, y, **(fit_params or {}))
        return e2

    try:
        est = _run_attempts(attempt, retry_policy, type(est).__name__)
    except Exception as e:
        if error_score == "raise":
            raise
        warn_fit_failure(error_score, e)
        est = FIT_FAILURE
    return est, default_timer() - start


def fit_transform(est, X, y, params=None, fit_params=None, error_score="raise",
                  retry_policy=None):
    """Fit+transform for pipeline stages; returns
    ``((fitted, Xt) | (FIT_FAILURE, FIT_FAILURE), fit_time)``
    (reference: methods.py:227-249)."""
    start = default_timer()

    def attempt():
        e2 = copy_estimator(est)
        if params:
            set_params(e2, params)
        if X is FIT_FAILURE:
            raise ValueError("Upstream pipeline stage failed to fit")
        if hasattr(e2, "fit_transform"):
            Xt = e2.fit_transform(X, y, **(fit_params or {}))
        else:
            e2.fit(X, y, **(fit_params or {}))
            Xt = e2.transform(X)
        return e2, Xt

    try:
        est, Xt = _run_attempts(attempt, retry_policy, type(est).__name__)
    except Exception as e:
        if error_score == "raise":
            raise
        warn_fit_failure(error_score, e)
        est = FIT_FAILURE
        Xt = FIT_FAILURE
    return (est, Xt), default_timer() - start


def score(est, X_test, y_test, X_train, y_train, scorers, error_score):
    """Score a fitted estimator; ``scorers`` is ``{name: scorer}`` or a single
    callable under the key ``"score"``. Returns
    ``(test_scores, train_scores_or_None, score_time)``
    (reference: methods.py:252-269).
    """
    start = default_timer()
    if est is FIT_FAILURE:
        if error_score == "raise":  # pragma: no cover - guarded upstream
            raise ValueError("Fit failed with error_score='raise'")
        test = {name: float(error_score) for name in scorers}
        train = {name: float(error_score) for name in scorers}
    else:
        test = {name: float(s(est, X_test, y_test)) for name, s in scorers.items()}
        train = None
        if X_train is not None:
            train = {
                name: float(s(est, X_train, y_train))
                for name, s in scorers.items()
            }
    if X_train is None:
        train = None
    return test, train, default_timer() - start


MISSING = type("MissingParameter", (), {"__repr__": lambda s: "MISSING"})()


def create_cv_results(
    scores,
    candidate_params,
    n_splits: int,
    error_score,
    test_weights,
    multimetric: bool,
    return_train_score: bool,
):
    """Assemble the sklearn-compatible ``cv_results_`` dict
    (reference: methods.py:286-368).

    ``scores`` is a list (one entry per candidate×split, candidate-major) of
    ``(test_scores: dict, train_scores: dict|None, fit_time, score_time)``.
    ``test_weights`` (iid weighting) is an (n_candidates, n_splits) array of
    test-set sizes or None.
    """
    n_candidates = len(candidate_params)
    assert len(scores) == n_candidates * n_splits

    fit_times = np.array([s[2] for s in scores]).reshape(n_candidates, n_splits)
    score_times = np.array([s[3] for s in scores]).reshape(n_candidates, n_splits)

    results = {
        "mean_fit_time": fit_times.mean(axis=1),
        "std_fit_time": fit_times.std(axis=1),
        "mean_score_time": score_times.mean(axis=1),
        "std_score_time": score_times.std(axis=1),
        "params": candidate_params,
    }

    # param_<name> masked arrays (MISSING where a candidate lacks the key)
    keys = sorted({k for p in candidate_params for k in p})
    for key in keys:
        values = [p.get(key, MISSING) for p in candidate_params]
        mask = [v is MISSING for v in values]
        results[f"param_{key}"] = np.ma.MaskedArray(
            np.array(values, dtype=object), mask=mask
        )

    metric_names = sorted(scores[0][0]) if scores else ["score"]

    def _store(name_suffix, table, weights=None, rank=False):
        results.update(
            {
                f"split{i}_{name_suffix}": table[:, i]
                for i in range(n_splits)
            }
        )
        if weights is not None:
            mean = np.average(table, axis=1, weights=weights)
        else:
            mean = table.mean(axis=1)
        results[f"mean_{name_suffix}"] = mean
        # weighted std about the (possibly weighted) mean, as sklearn does
        if weights is not None:
            std = np.sqrt(
                np.average((table - mean[:, None]) ** 2, axis=1, weights=weights)
            )
        else:
            std = table.std(axis=1)
        results[f"std_{name_suffix}"] = std
        if rank:
            results[f"rank_{name_suffix}"] = np.asarray(
                rankdata(-mean, method="min"), dtype=np.int32
            )

    for m in metric_names:
        suffix = f"test_{m}" if multimetric else "test_score"
        table = np.array(
            [s[0][m] for s in scores], dtype=np.float64
        ).reshape(n_candidates, n_splits)
        w = None
        if test_weights is not None:
            w = np.asarray(test_weights, dtype=np.float64).reshape(
                n_candidates, n_splits
            )
        _store(suffix, table, weights=w, rank=True)
        if return_train_score:
            tsuffix = f"train_{m}" if multimetric else "train_score"
            ttable = np.array(
                [
                    (s[1][m] if s[1] is not None else np.nan)
                    for s in scores
                ],
                dtype=np.float64,
            ).reshape(n_candidates, n_splits)
            _store(tsuffix, ttable)

    return results

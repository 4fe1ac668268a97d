"""Scorer registry of the PyTorch port (counterpart of
``dask_ml_tpu/metrics/scorer.py``), in numpy: the card's machine has no
scikit-learn, so :func:`make_scorer` is the port's own.

Scorers follow the scikit-learn convention ``scorer(estimator, X, y) ->
float``. A name outside :data:`SCORERS` resolves through scikit-learn's
registry where scikit-learn imports, as the JAX package's does, and raises
elsewhere.
"""

from __future__ import annotations

import inspect

from dask_ml_tpu_torch.metrics.classification import accuracy_score, log_loss
from dask_ml_tpu_torch.metrics.regression import (
    mean_absolute_error,
    mean_squared_error,
    r2_score,
)


class _Scorer:
    """``score_func(y, response(X), **kwargs)`` times ``sign``, the
    response being ``estimator.<response_method>(X)``."""

    def __init__(self, score_func, sign: int, response_method: str,
                 kwargs: dict):
        self._score_func = score_func
        self._sign = sign
        self._response_method = response_method
        self._kwargs = kwargs

    def __call__(self, estimator, X, y, sample_weight=None):
        y_pred = getattr(estimator, self._response_method)(X)
        kw = dict(self._kwargs)
        if sample_weight is not None:
            kw["sample_weight"] = sample_weight
        return self._sign * self._score_func(y, y_pred, **kw)


def make_scorer(score_func, *, greater_is_better: bool = True,
                response_method: str = "predict", **kwargs):
    """A scorer from a metric ``score_func(y_true, y_pred, **kwargs)``, as
    scikit-learn's ``make_scorer``: the metric of the estimator's
    ``response_method`` output, negated where smaller is better."""
    return _Scorer(score_func, 1 if greater_is_better else -1,
                   response_method, kwargs)


# the JAX package's registry
SCORERS = {
    "accuracy": make_scorer(accuracy_score),
    "neg_mean_squared_error": make_scorer(mean_squared_error,
                                          greater_is_better=False),
    "neg_mean_absolute_error": make_scorer(mean_absolute_error,
                                           greater_is_better=False),
    "neg_log_loss": make_scorer(log_loss, greater_is_better=False,
                                response_method="predict_proba"),
    "r2": make_scorer(r2_score),
}


def get_scorer(scoring, compute: bool = True):
    """Resolve a scoring name or callable to a scorer. A name outside
    :data:`SCORERS` goes to scikit-learn's registry where scikit-learn
    imports; an unknown name raises ``ValueError``. ``compute`` is taken
    and, as in the JAX package, changes nothing: a scorer returns a
    float."""
    if isinstance(scoring, str):
        if scoring in SCORERS:
            return SCORERS[scoring]
        try:
            import sklearn.metrics
        except ImportError:
            sklearn = None
        try:
            if sklearn is not None:
                return sklearn.metrics.get_scorer(scoring)
        except ValueError:
            pass
        raise ValueError(
            f"{scoring!r} is not a valid scoring value; valid options "
            f"are {sorted(SCORERS)} or any sklearn scorer name")
    if callable(scoring):
        return scoring
    raise ValueError(f"Invalid scoring: {scoring!r}")


def _looks_like_raw_metric(fn) -> bool:
    """Whether a callable passed as a scorer ``s(estimator, X, y)`` is a
    metric ``f(y_true, y_pred)`` instead, by its structure (the JAX
    package's rule): made scorers (``_score_func`` / ``_response_method``)
    are scorers; plain functions of a metrics module are metrics; else a
    first positional parameter named for a ground truth, or a second one
    named for a prediction, marks a metric."""
    if hasattr(fn, "_score_func") or hasattr(fn, "_response_method"):
        return False
    if getattr(fn, "__module__", "").startswith(
            ("dask_ml_tpu_torch.metrics", "dask_ml_tpu.metrics",
             "sklearn.metrics")):
        return True
    try:
        params = list(inspect.signature(fn).parameters.values())
    except (TypeError, ValueError):  # builtins and C callables: can't tell
        return False
    positional = [p for p in params
                  if p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)]
    if not positional:
        return False
    if positional[0].name.lower() in ("y_true", "y", "labels",
                                      "labels_true"):
        return True
    second = positional[1].name.lower() if len(positional) > 1 else ""
    return second in ("y_pred", "y_score", "y_prob", "labels_pred")


def check_scoring(estimator, scoring=None, **kwargs):
    """Validate ``scoring`` for ``estimator``: ``None`` needs the
    estimator's own ``score``; a raw metric function is refused (wrap it
    with :func:`make_scorer`); else the resolved scorer."""
    if scoring is None:
        if not hasattr(estimator, "score"):
            raise TypeError(
                f"estimator {estimator!r} has no score method; pass "
                f"scoring=")
        return None
    if callable(scoring) and _looks_like_raw_metric(scoring):
        raise ValueError(
            "scoring value looks like a raw metric function (signature "
            "starts with y_true/y_pred, not an estimator); wrap it with "
            "make_scorer")
    return get_scorer(scoring)

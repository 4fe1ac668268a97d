"""scikit-learn-style GLM estimators of the PyTorch port (counterpart of
``dask_ml_tpu/linear_model/glm.py``) over the solvers of
:mod:`dask_ml_tpu_torch.models.glm`.

The same constructor surface and defaults (``solver`` still defaults to
``"admm"`` for API parity, and ADMM is not ported yet, so such a fit
raises ``NotImplementedError`` naming ``solver="lbfgs"``), the same
``lamduh = 1/C`` mapping and solver-specific pruning, the same
deviations from the reference: the intercept is not penalized, and
``LinearRegression.score`` is R².

Dense input stages as a float32 tensor; sparse input (scipy CSR or a
:class:`~dask_ml_tpu_torch.ops.sparse.SparseRows` container) stages as a
container, whose linear predictor on the card is the K6 SpMV kernel, in
the fit and in ``decision_function`` / ``predict`` / ``score``. Fits and
predictions run on the configured device (``config.device``, "cuda" by
default). Not ported yet: ``fit_blocks``, ``partial_fit``, the
batched-search hooks, ``checkpoint``, and the multinomial fit with more
than two classes.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dask_ml_tpu_torch.base import BaseEstimator
from dask_ml_tpu_torch.metrics import accuracy_score, r2_score
from dask_ml_tpu_torch.models import glm as core
from dask_ml_tpu_torch.ops import sparse as sparse_ops
from dask_ml_tpu_torch.parallel import telemetry
from dask_ml_tpu_torch.parallel.sharding import prepare_data
from dask_ml_tpu_torch.utils.validation import check_array


def add_intercept(X):
    """Append a ones column to a dense tensor, or the intercept as one
    extra slot per row (column ``d``, value 1) to a container."""
    if isinstance(X, sparse_ops.SparseRows):
        return sparse_ops.add_intercept_ell(X)
    return torch.cat([X, X.new_ones((X.shape[0], 1))], dim=1)


def eta_program(Xs, coef, *, intercept: bool):
    """The whole linear predictor over staged rows: the intercept append,
    then ``X @ coef`` (``coef`` (width,)) or ``X @ coef.T`` (``coef``
    (n_classes, width), OVR) — the K6 SpMV (or the gather-matmat) for a
    container, ``torch.matmul`` for a dense tensor."""
    if intercept:
        Xs = add_intercept(Xs)
    ct = coef.T if coef.ndim == 2 else coef
    if isinstance(Xs, sparse_ops.SparseRows):
        return (sparse_ops.matmat(Xs, ct) if ct.ndim == 2
                else sparse_ops.matvec(Xs, ct))
    return torch.matmul(Xs, ct)


def proba_from_eta(eta: np.ndarray, multiclass: str) -> np.ndarray:
    """Host map from a linear predictor to probabilities, row by row.
    Binary: the 1-D sigmoid of the positive class's score. Multiclass:
    softmax for 'multinomial', per-class sigmoids normalized per row for
    'ovr'."""
    from scipy.special import expit

    if eta.ndim == 2 and multiclass == "multinomial":
        z = np.exp(eta - eta.max(axis=1, keepdims=True))
        return z / z.sum(axis=1, keepdims=True)
    scores = expit(eta)
    if scores.ndim == 2:
        denom = np.maximum(scores.sum(axis=1, keepdims=True), 1e-30)
        return scores / denom
    return scores


def labels_from_proba(proba: np.ndarray, classes) -> np.ndarray:
    """Host map from probabilities to class labels, row by row."""
    if proba.ndim == 2:
        return np.asarray(classes)[np.argmax(proba, axis=1)]
    mask = proba > 0.5
    if classes is not None:
        return np.asarray(classes)[mask.astype(np.int64)]
    return mask


class _GLM(BaseEstimator):
    """Shared GLM facade (reference: linear_model/glm.py:86-177).

    Fitted attributes: ``coef_``, ``intercept_`` (with ``fit_intercept``),
    ``n_iter_``, and ``fit_phase_seconds_`` — ``{"stage": s, "solve": s}``,
    the wall seconds of validation, the host→device copy and the intercept
    append (ended by a device sync), then of the solver up to the
    coefficients on the host.
    """

    family = None  # set by subclasses: 'logistic' | 'normal' | 'poisson'

    #: solvers that optimize the unregularized objective, as in the
    #: reference (glm.py:120-122 pops regularizer/lamduh)
    _UNREGULARIZED_SOLVERS = ("gradient_descent", "newton")

    def __init__(self, penalty="l2", dual=False, tol=1e-4, C=1.0,
                 fit_intercept=True, intercept_scaling=1.0, class_weight=None,
                 random_state=None, solver="admm", multiclass="ovr",
                 verbose=0, warm_start=False, n_jobs=1, max_iter=100,
                 solver_kwargs=None, checkpoint=None, checkpoint_every=50):
        self.penalty = penalty
        self.dual = dual
        self.tol = tol
        self.C = C
        self.fit_intercept = fit_intercept
        self.intercept_scaling = intercept_scaling
        self.class_weight = class_weight
        self.random_state = random_state
        self.solver = solver
        self.multiclass = multiclass
        self.verbose = verbose
        self.warm_start = warm_start
        self.n_jobs = n_jobs
        self.max_iter = max_iter
        self.solver_kwargs = solver_kwargs
        self.checkpoint = checkpoint
        self.checkpoint_every = checkpoint_every

    def _get_solver_kwargs(self):
        """``lamduh = 1/C`` mapping + per-solver pruning
        (reference: glm.py:114-139)."""
        if self.solver not in core.SOLVERS:
            raise ValueError(
                f"'solver' must be {set(core.SOLVERS)}. "
                f"Got '{self.solver}' instead")
        kwargs = {
            "max_iter": self.max_iter,
            "family": self.family,
            "tol": self.tol,
            "regularizer": self.penalty,
            "lamduh": 1.0 / self.C,
        }
        if self.solver in self._UNREGULARIZED_SOLVERS:
            kwargs["lamduh"] = 0.0
            kwargs["regularizer"] = "l2"
        if self.solver == "admm":
            kwargs.pop("tol")  # uses reltol / abstol instead (glm.py:124-126)
        if self.solver_kwargs:
            kwargs.update(self.solver_kwargs)
        return kwargs

    def _encode_y(self, y):
        """Hook for family-specific target validation/encoding."""
        return np.asarray(y)

    def fit(self, X, y=None, sample_weight=None):
        if self.checkpoint:
            raise NotImplementedError(
                "checkpoint= is not ported to the PyTorch package yet")
        kwargs = self._get_solver_kwargs()
        solver = core.solver_fn(self.solver)
        t0 = time.perf_counter()
        X = check_array(X, accept_sparse=True)
        y = self._encode_y(y)
        data = prepare_data(X, sample_weight=sample_weight, y=y)
        if self.fit_intercept:
            # the appended container replaces the staged one, which is
            # freed here: at the sparse flagship both exist only briefly
            data.X = add_intercept(data.X)
        d = int(data.X.shape[1])
        dev = data.weights.device
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        t_stage = time.perf_counter()
        # penalty mask: the intercept column is not regularized
        mask = torch.ones(d, dtype=torch.float32, device=dev)
        if self.fit_intercept:
            mask[-1] = 0.0
        beta0 = torch.zeros(d, dtype=torch.float32, device=dev)
        with telemetry.span(f"glm-{self.solver}"):
            results = [solver(data.X, y_dev, data.weights, beta0, mask,
                              **kwargs)
                       for y_dev in self._solve_targets(data)]
        self.n_features_in_ = d - 1 if self.fit_intercept else d
        self.n_iter_ = int(max(n for _, n in results))
        self._finalize_coef([b.cpu().numpy() for b, _ in results])
        self.fit_phase_seconds_ = {"stage": t_stage - t0,
                                   "solve": time.perf_counter() - t_stage}
        return self

    def _solve_targets(self, data):
        """Device target vectors, one solver run each. The base GLM solves a
        single problem; multiclass OVR (LogisticRegression) overrides."""
        return [data.y]

    def _finalize_coef(self, betas):
        self._coef = betas[0]
        if self.fit_intercept:
            self.coef_ = self._coef[:-1]
            self.intercept_ = self._coef[-1]
        else:
            self.coef_ = self._coef

    def _decision_function(self, X):
        """Linear predictor on staged rows, returned to the host. ``_coef``
        is 1-D for a single problem and (n_classes, width) for OVR, which
        gives an (n, n_classes) score matrix, like scikit-learn."""
        X = check_array(X, accept_sparse=True)
        if X.shape[1] != self.n_features_in_:
            raise ValueError(
                f"X has {X.shape[1]} features; the model was fitted with "
                f"{self.n_features_in_}")
        data = prepare_data(X)
        coef = torch.as_tensor(np.asarray(self._coef, dtype=np.float32),
                               device=data.weights.device)
        eta = eta_program(data.X, coef, intercept=bool(self.fit_intercept))
        return eta.cpu().numpy()


class LogisticRegression(_GLM):
    """Logistic regression (reference: linear_model/glm.py:180-232).

    Binary fits keep the reference's surface (1-D ``coef_``, 1-D
    ``predict_proba``); any two labels map to {0, 1} through
    ``classes_``. With more than two classes, ``multiclass="ovr"`` fits
    one binary problem per class against the same staged data (the
    indicator targets are built on the device) with sigmoid-normalized
    ``predict_proba``; ``multiclass="multinomial"`` with more than two
    classes is not ported yet and raises ``NotImplementedError``."""

    family = "logistic"

    def _encode_y(self, y):
        if self.multiclass not in ("ovr", "multinomial"):
            raise ValueError(
                f"multiclass must be 'ovr' or 'multinomial', got "
                f"{self.multiclass!r}")
        y = np.asarray(y)
        classes = np.unique(y)
        if len(classes) < 2:
            raise ValueError(
                f"LogisticRegression requires at least 2 classes, got "
                f"{len(classes)}: {classes!r}")
        if len(classes) > 2 and self.multiclass == "multinomial":
            raise NotImplementedError(
                "multiclass='multinomial' with more than 2 classes is not "
                "ported to the PyTorch package yet; use multiclass='ovr'")
        self.classes_ = classes
        if len(classes) == 2:
            return (y == classes[1]).astype(np.float32)
        # multiclass: stage class indices once; the per-class {0, 1}
        # targets are derived on the device in _solve_targets
        return np.searchsorted(classes, y).astype(np.float32)

    def _solve_targets(self, data):
        k = len(self.classes_)
        if k == 2:
            return [data.y]
        return [(data.y == float(c)).to(torch.float32) for c in range(k)]

    def _finalize_coef(self, betas):
        if len(betas) == 1:
            return super()._finalize_coef(betas)
        self._coef = np.stack(betas)  # (n_classes, width)
        if self.fit_intercept:
            self.coef_ = self._coef[:, :-1]
            self.intercept_ = self._coef[:, -1]
        else:
            self.coef_ = self._coef

    def decision_function(self, X):
        return self._decision_function(X)

    def predict_proba(self, X):
        return proba_from_eta(self._decision_function(X), self.multiclass)

    def predict(self, X):
        return labels_from_proba(self.predict_proba(X),
                                 getattr(self, "classes_", None))

    def score(self, X, y):
        return accuracy_score(np.asarray(y), self.predict(X))


class LinearRegression(_GLM):
    """Linear (Normal-family) regression (reference: glm.py:235-290)."""

    family = "normal"

    def predict(self, X):
        return self._decision_function(X)

    def score(self, X, y):
        return r2_score(np.asarray(y), self.predict(X))


class PoissonRegression(_GLM):
    """Poisson count regression (reference: glm.py:293-325)."""

    family = "poisson"

    def _encode_y(self, y):
        y = np.asarray(y)
        if np.any(y < 0):
            raise ValueError("Poisson regression requires y >= 0")
        return y

    def predict(self, X):
        return np.exp(self._decision_function(X))

    def get_deviance(self, X, y):
        y = np.asarray(y, dtype=np.float64)
        mu = np.asarray(self.predict(X), dtype=np.float64)
        # 2·Σ [y·log(y/mu) − (y − mu)], with the y = 0 limit handled
        with np.errstate(divide="ignore", invalid="ignore"):
            term = np.where(y > 0, y * np.log(y / mu), 0.0)
        return float(2.0 * np.sum(term - (y - mu)))

"""scikit-learn-style GLM estimators of the PyTorch port (counterpart of
``dask_ml_tpu/linear_model/glm.py``) over the solvers of
:mod:`dask_ml_tpu_torch.models.glm`.

The same constructor surface and defaults (``solver="admm"``: consensus
ADMM, here over one row block, as on a one-device mesh), the same
``lamduh = 1/C`` mapping and solver-specific pruning, the same
deviations from the reference: the intercept is not penalized, and
``LinearRegression.score`` is R².

Dense input stages as a float32 tensor; sparse input (scipy CSR or a
:class:`~dask_ml_tpu_torch.ops.sparse.SparseRows` container) stages as a
container, whose linear predictor on the card is the K6 SpMV kernel, in
the fit and in ``decision_function`` / ``predict`` / ``score``. Fits and
predictions run on the configured device (``config.device``, "cuda" by
default).

``checkpoint=`` (a path prefix) makes ``fit`` resumable: each fit problem
runs through :func:`~dask_ml_tpu_torch.checkpoint.solve_checkpointed` in
chunks of ``checkpoint_every`` iterations, saved to the prefix suffixed
with the problem's fingerprint. ``fit_blocks`` fits from streamed row
blocks (:func:`~dask_ml_tpu_torch.models.glm.admm_streamed`), data larger
than the card's memory. ``partial_fit`` takes one proximal-SGD step per
block (:func:`~dask_ml_tpu_torch.models.glm.get_stream_step`), and
``_incremental_begin`` / ``_incremental_finalize`` let
:class:`~dask_ml_tpu_torch.wrappers.Incremental` run the chain of blocks
on the device. ``_batched_fit_score`` and its hooks are the search
driver's batched-candidate protocol over ``C``.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from dask_ml_tpu_torch.base import BaseEstimator
from dask_ml_tpu_torch.config import resolve_device
from dask_ml_tpu_torch.metrics import accuracy_score, r2_score
from dask_ml_tpu_torch.models import glm as core
from dask_ml_tpu_torch.models.glm import add_intercept
from dask_ml_tpu_torch.ops import sparse as sparse_ops
from dask_ml_tpu_torch.parallel import precision, telemetry
from dask_ml_tpu_torch.parallel.sharding import is_sparse_input, prepare_data
from dask_ml_tpu_torch.utils.validation import check_array


def _intercept_block(blk):
    """Block-tuple intercept append of host-streamed fits, applied on the
    device to each block of a ``HostBlockSource``."""
    X_b, y_b, w_b = blk
    return add_intercept(X_b), y_b, w_b


def _checkpointed(solver, X, y, w, beta0, mask, kwargs, prefix, every):
    """``solve_checkpointed`` at ``prefix`` suffixed with the problem's
    fingerprint (max_iter left out of it, so a larger budget resumes the
    same snapshot): each distinct problem, each OVR class included, keeps
    its own snapshot."""
    from dask_ml_tpu_torch.checkpoint import (problem_fingerprint,
                                              solve_checkpointed)

    kwargs = dict(kwargs)
    max_iter = int(kwargs.pop("max_iter"))
    fp = problem_fingerprint(solver, X, y, w, beta0, mask, **kwargs)
    return solve_checkpointed(
        solver, X, y, w, beta0, mask, path=f"{prefix}.{fp[:16]}",
        chunk_iters=int(every), max_iter=max_iter, fingerprint=fp, **kwargs)


def eta_program(Xs, coef, *, intercept: bool):
    """The whole linear predictor over staged rows: the intercept append,
    then ``X @ coef`` (``coef`` (width,)) or ``X @ coef.T`` (``coef``
    (n_classes, width), OVR) — the K6 SpMV (or the gather-matmat) for a
    container, :func:`~dask_ml_tpu_torch.parallel.precision.pmatmul` for a
    dense tensor (a bf16 X staged on the precision wire: bf16 operands,
    f32 scores)."""
    if intercept:
        Xs = add_intercept(Xs)
    ct = coef.T if coef.ndim == 2 else coef
    if isinstance(Xs, sparse_ops.SparseRows):
        return (sparse_ops.matmat(Xs, ct) if ct.ndim == 2
                else sparse_ops.matvec(Xs, ct))
    return precision.pmatmul(Xs, ct)


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

    def _stage(self, X, y, sample_weight):
        """Stage the validated X, y and weights and append the intercept.
        Returns (data, the penalty mask, the clock at the end of staging);
        the mask leaves the intercept column unregularized."""
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
        mask = torch.ones(d, dtype=torch.float32, device=dev)
        if self.fit_intercept:
            mask[-1] = 0.0
        self.n_features_in_ = d - 1 if self.fit_intercept else d
        return data, mask, t_stage

    def fit(self, X, y=None, sample_weight=None):
        kwargs = self._get_solver_kwargs()
        solver = core.solver_fn(self.solver)
        t0 = time.perf_counter()
        X = check_array(X, accept_sparse=True)
        y = self._encode_y(y)
        data, mask, t_stage = self._stage(X, y, sample_weight)
        beta0 = torch.zeros_like(mask)

        def solve_one(y_dev):
            if self.checkpoint:
                return _checkpointed(self.solver, data.X, y_dev,
                                     data.weights, beta0, mask, kwargs,
                                     self.checkpoint, self.checkpoint_every)
            return solver(data.X, y_dev, data.weights, beta0, mask, **kwargs)

        with telemetry.span(f"glm-{self.solver}"):
            results = [solve_one(y_dev)
                       for y_dev in self._solve_targets(data)]
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

    def fit_blocks(self, block_fn, n_blocks, n_samples, n_features,
                   classes=None, sw_total=None, elastic=None):
        """Fit from streamed row blocks: data larger than the card's memory.

        ``block_fn(b) -> (X_b, y_b, w_b)`` is a callable making block ``b``
        on the device, or a
        :class:`~dask_ml_tpu_torch.parallel.stream.HostBlockSource` of host
        blocks (dense, or a sparse element); either way one block is
        resident at a time inside
        :func:`~dask_ml_tpu_torch.models.glm.admm_streamed`, and both take
        the same trajectory. ``y_b`` is numeric already ({0, 1} for
        logistic; ``classes`` fixes ``classes_``). Requires
        ``solver="admm"``. Blocks carry no intercept column: with
        ``fit_intercept`` it is appended to each block on the device.
        ``sw_total`` (default ``n_samples``, right for unit weights only)
        is the total sample weight over all blocks.

        With ``checkpoint=`` (source mode only) the fit is
        preemption-safe: a snapshot every ``checkpoint_every`` blocks at
        ``checkpoint + ".stream"``, a graceful drain on SIGTERM/SIGINT
        (:class:`~dask_ml_tpu_torch.parallel.faults.Preempted` after the
        save), and a rerun resumes from the last complete block on a
        bit-identical trajectory. The source's counters include the
        copies the fit made. ``elastic=`` is not ported and raises."""
        from dask_ml_tpu_torch.parallel.stream import HostBlockSource

        if self.solver != "admm":
            raise ValueError(
                "fit_blocks streams through consensus ADMM; construct the "
                "estimator with solver='admm'")
        kwargs = self._get_solver_kwargs()
        kwargs.pop("family", None)
        d = int(n_features) + (1 if self.fit_intercept else 0)
        mask = np.ones(d, dtype=np.float32)
        if self.fit_intercept:
            mask[-1] = 0.0
        host = isinstance(block_fn, HostBlockSource)
        ck = {}
        if self.checkpoint:
            if not host:
                raise ValueError(
                    "checkpoint= on fit_blocks requires a HostBlockSource "
                    "block source (a callable block_fn is chunked through "
                    "models.glm.admm_streamed's state/return_state carry "
                    "instead)")
            ck = dict(checkpoint_path=f"{self.checkpoint}.stream",
                      checkpoint_every=int(self.checkpoint_every))
        if not self.fit_intercept:
            wrapped = block_fn
        elif host:
            wrapped = block_fn.with_transform(_intercept_block)
        else:
            def wrapped(b):
                return _intercept_block(block_fn(b))
        try:
            with telemetry.span("glm-admm-streamed", blocks=int(n_blocks)):
                beta, n_iter = core.admm_streamed(
                    wrapped, int(n_blocks), d,
                    float(n_samples if sw_total is None else sw_total),
                    mask, family=self.family, elastic=elastic, **ck,
                    **kwargs)
        finally:
            if host and wrapped is not block_fn:
                # the intercept copy's counters, on the caller's source
                block_fn.bytes_streamed += wrapped.bytes_streamed
                block_fn.logical_bytes_streamed += \
                    wrapped.logical_bytes_streamed
                block_fn.blocks_started += wrapped.blocks_started
        self.n_iter_ = int(n_iter)
        self.n_features_in_ = int(n_features)
        self._finalize_coef([beta.cpu().numpy()])
        if classes is not None:
            self.classes_ = np.asarray(classes)
        elif self.family == "logistic":
            self.classes_ = np.array([0, 1])
        return self

    # -- streaming / incremental training ----------------------------------
    #
    # The estimator implements partial_fit itself (one proximal-SGD step
    # per block) and exposes the hooks through which
    # wrappers.Incremental runs the whole chain of blocks on the device
    # (wrappers.incremental_scan).

    def _encode_y_partial(self, y, classes=None):
        return self._encode_y(y)

    def _sgd_config(self):
        sk = dict(self.solver_kwargs or {})
        regularizer, lamduh = self.penalty, 1.0 / self.C
        if self.solver in self._UNREGULARIZED_SOLVERS:
            # these solvers fit the unregularized objective; streaming
            # matches, or fit and partial_fit would solve other problems
            regularizer, lamduh = "l2", 0.0
        return dict(
            family=self.family,
            regularizer=regularizer,
            lamduh=lamduh,
            eta0=float(sk.get("eta0", 0.1)),
            power_t=float(sk.get("power_t", 0.5)),
            fit_intercept=bool(self.fit_intercept),
        )

    def _pf_width(self, n_features: int) -> int:
        return n_features + 1 if self.fit_intercept else n_features

    def _pf_coef_shape(self, width: int) -> tuple:
        """The streaming state's coefficient shape: (width,) for one
        problem; LogisticRegression widens it to (width, K) for softmax."""
        return (width,)

    def _pf_state_device(self, n_features: int):
        """The streaming state ``(beta, t)`` on the configured device: the
        running state, else a warm start from a batch-fitted ``_coef``
        (the scikit-learn partial_fit contract: continue, don't reset),
        else zeros."""
        dev = resolve_device()

        def staged(beta, t):
            return (torch.as_tensor(np.asarray(beta, dtype=np.float32),
                                    device=dev),
                    torch.tensor(float(t), dtype=torch.float32, device=dev))

        shape = self._pf_coef_shape(self._pf_width(n_features))
        state = getattr(self, "_pf_state", None)
        if state is None:
            coef = getattr(self, "_coef", None)
            if coef is not None:
                # a multiclass _coef is (K, width): the state holds its
                # transpose
                if len(shape) == 1 and coef.shape == shape:
                    return staged(coef, 0.0)
                if len(shape) == 2 and coef.shape == shape[::-1]:
                    return staged(coef.T, 0.0)
            return staged(np.zeros(shape, np.float32), 0.0)
        beta, t = state
        if tuple(beta.shape) != shape:
            raise ValueError(
                f"partial_fit block has {n_features} features but the "
                f"running state was built for coefficient shape "
                f"{tuple(beta.shape)}")
        return staged(beta, t)

    def _store_pf_state(self, state):
        beta = state[0].cpu().numpy()
        t = float(state[1])
        self._pf_state = (beta, t)
        self._coef = beta.T if beta.ndim == 2 else beta
        if self.fit_intercept:
            self.coef_ = self._coef[..., :-1]
            self.intercept_ = self._coef[..., -1]
        else:
            self.coef_ = self._coef
        self.n_features_in_ = int(beta.shape[0]) - (
            1 if self.fit_intercept else 0)
        self.n_iter_ = int(t)

    def partial_fit(self, X, y=None, classes=None, sample_weight=None):
        """One proximal-SGD step on this block (dense, CSR or a
        container), resumable across calls."""
        X = check_array(X, accept_sparse=True)
        y_enc = self._encode_y_partial(y, classes)
        state = self._pf_state_device(int(X.shape[1]))
        _, apply_one = core.get_stream_step(**self._sgd_config())
        data = prepare_data(X, sample_weight=sample_weight, y=y_enc,
                            device=state[0].device)
        self._store_pf_state(apply_one(state, data.X, data.y, data.weights))
        return self

    def _incremental_begin(self, X, y, classes=None):
        """The hook of :class:`dask_ml_tpu_torch.wrappers.Incremental`:
        ``(step_fn, init_state, y_encoded)``."""
        y_enc = self._encode_y_partial(y, classes)
        step, _ = core.get_stream_step(**self._sgd_config())
        return step, self._pf_state_device(int(X.shape[1])), y_enc

    def _incremental_finalize(self, state):
        self._store_pf_state(state)
        return self

    def _decision_function(self, X):
        """Linear predictor on staged rows, returned to the host. ``_coef``
        is 1-D for a single problem and (n_classes, width) for OVR, which
        gives an (n, n_classes) score matrix, like scikit-learn."""
        X = check_array(X, accept_sparse=True)
        if X.shape[1] != self.n_features_in_:
            raise ValueError(
                f"X has {X.shape[1]} features; the model was fitted with "
                f"{self.n_features_in_}")
        data = prepare_data(X)  # on precision.staging_wire_dtype()
        coef = torch.as_tensor(np.asarray(self._coef, dtype=np.float32),
                               device=data.weights.device)
        eta = eta_program(data.X, coef, intercept=bool(self.fit_intercept))
        return eta.cpu().numpy()

    # -- batched-candidate protocol (the search driver's fast path) -------
    #
    # A C grid over one GLM is the same problem at other regularization
    # strengths: the driver's batched path stages the data once, solves
    # every member (models/glm.py batched_glm_path) and scores all members
    # in one product, with the scores left on the card for the driver's
    # one copy to the host.

    _batchable_params = frozenset({"C"})

    def _supports_batched(self, static_params) -> bool:
        """The four smooth solvers only (ADMM keeps per-block state), and
        no estimator-level solver_kwargs or checkpoint plumbing, whose
        per-member interactions the batched path does not model."""
        solver = static_params.get("solver", self.solver)
        if solver not in core._PATH_SOLVERS:
            return False
        if static_params.get("solver_kwargs", self.solver_kwargs):
            return False
        if static_params.get("checkpoint", self.checkpoint):
            return False
        return self.family in ("logistic", "normal")

    def _member_lamduh(self, member):
        if self.solver in self._UNREGULARIZED_SOLVERS:
            return 0.0  # C never reaches these solvers
        return 1.0 / float(member.get("C", self.C))

    def _batchable_member_ok(self, member_params, n_train_min) -> bool:
        """C = 0 or a non-finite C can't form a lamduh: such members run
        per cell, so that only THEY fail under error_score. The solver is
        read from the merged params (a grid can override it)."""
        if member_params.get(
                "solver", self.solver) in self._UNREGULARIZED_SOLVERS:
            return True
        try:
            c = float(member_params.get("C", self.C))
        except (TypeError, ValueError):
            return False
        return bool(np.isfinite(c)) and c != 0.0

    def _encode_eval_y(self, y):
        if self.family == "logistic":
            # a label outside the training fold's classes encodes to -1:
            # no {0, 1} prediction matches it, as the per-cell accuracy on
            # raw labels counts it wrong
            ye = np.asarray(y)
            return np.where(
                ye == self.classes_[1], np.float32(1.0),
                np.where(ye == self.classes_[0], np.float32(0.0),
                         np.float32(-1.0))).astype(np.float32)
        return np.asarray(y, dtype=np.float32)

    def _batched_fit_score(self, X, y, members, eval_sets):
        """Solve every member's ``C`` on the data staged once, then score
        each member on each eval set (accuracy / R², as ``score``).
        Returns ``{"n_iter": (M,), "scores": [per eval set (M,)], "coef":
        (M, width)}`` as device tensors (``coef`` with the intercept as
        its last column, as ``_coef``). Declines (``NotImplemented``) on
        multiclass targets: those run per cell, with the same results."""
        y_enc = self._encode_y(y)
        if len(getattr(self, "classes_", ())) > 2:
            return NotImplemented

        def prep(Xa, ya):
            Xin = Xa if isinstance(Xa, torch.Tensor) else check_array(
                Xa, accept_sparse=True)
            data = prepare_data(Xin, y=ya)
            if self.fit_intercept:
                data.X = add_intercept(data.X)
            return data

        data = prep(X, y_enc)
        d = int(data.X.shape[1])
        mask = torch.ones(d, dtype=torch.float32, device=data.y.device)
        if self.fit_intercept:
            mask[-1] = 0.0
        kwargs = self._get_solver_kwargs()
        betas, n_iters = core.batched_glm_path(
            data.X, data.y, data.weights, torch.zeros_like(mask), mask,
            [self._member_lamduh(m) for m in members], solver=self.solver,
            family=kwargs["family"], regularizer=kwargs["regularizer"],
            max_iter=int(kwargs["max_iter"]), tol=kwargs["tol"])
        self.n_features_in_ = d - 1 if self.fit_intercept else d
        scores = []
        for E, y_e in eval_sets:
            ed = prep(E, self._encode_eval_y(y_e))
            scores.append(core.batched_eval_scores(
                ed.X, ed.y, ed.weights, betas, family=self.family))
        return {"n_iter": n_iters, "scores": scores, "coef": betas}


class LogisticRegression(_GLM):
    """Logistic regression (reference: linear_model/glm.py:180-232).

    Binary fits keep the reference's surface (1-D ``coef_``, 1-D
    ``predict_proba``); any two labels map to {0, 1} through
    ``classes_``. With more than two classes, ``multiclass="ovr"`` fits
    one binary problem per class against the same staged data (the
    indicator targets are built on the device) with sigmoid-normalized
    ``predict_proba``; ``multiclass="multinomial"`` with more than two
    classes fits one softmax problem over the (d, K) coefficients —
    ``multinomial_lbfgs`` for every smooth solver name,
    ``admm_multinomial`` (dense input only) for ``"admm"`` — with softmax
    ``predict_proba``. Either way ``coef_`` is (n_classes, n_features)."""

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
        self.classes_ = classes
        if len(classes) == 2:
            return (y == classes[1]).astype(np.float32)
        # multiclass: stage class indices once; the per-class {0, 1}
        # targets are derived on the device in _solve_targets
        return np.searchsorted(classes, y).astype(np.float32)

    def fit(self, X, y=None, sample_weight=None):
        if self.multiclass == "multinomial" and y is not None:
            idx = self._encode_y(y)  # sets classes_
            if len(self.classes_) > 2:
                return self._fit_multinomial(X, idx, sample_weight)
        return super().fit(X, y, sample_weight=sample_weight)

    def _fit_multinomial(self, X, idx, sample_weight=None):
        """One softmax problem over all classes: L-BFGS for every smooth
        solver name, consensus ADMM for ``solver="admm"``. The objective
        follows the estimator's configuration either way (unregularized
        solvers keep ``lamduh=0``, ``solver_kwargs`` apply)."""
        kwargs = self._get_solver_kwargs()
        t0 = time.perf_counter()
        X = check_array(X, accept_sparse=True)
        use_admm = self.solver == "admm"
        if use_admm and is_sparse_input(X):
            raise ValueError(core.SPARSE_MULTINOMIAL_ADMM)  # before staging
        K = len(self.classes_)
        data, mask, t_stage = self._stage(X, idx, sample_weight)
        B0 = torch.zeros((int(data.X.shape[1]), K), dtype=torch.float32,
                         device=mask.device)
        mn_kwargs = dict(n_classes=K, regularizer=kwargs["regularizer"],
                         lamduh=kwargs["lamduh"],
                         max_iter=int(kwargs["max_iter"]))
        if use_admm:
            solver, name = core.admm_multinomial, "admm_multinomial"
            # admm's own knobs (rho, abstol, ...) from solver_kwargs
            mn_kwargs.update({k: v for k, v in kwargs.items()
                              if k not in ("max_iter", "family",
                                           "regularizer", "lamduh")})
        else:
            solver, name = core.multinomial_lbfgs, "multinomial_lbfgs"
            mn_kwargs["tol"] = kwargs.get("tol", self.tol)
        with telemetry.span(f"glm-{name}"):
            if self.checkpoint:
                B, n_iter = _checkpointed(name, data.X, data.y, data.weights,
                                          B0, mask, mn_kwargs,
                                          self.checkpoint,
                                          self.checkpoint_every)
            else:
                B, n_iter = solver(data.X, data.y, data.weights, B0, mask,
                                   **mn_kwargs)
        self._coef = B.T.cpu().numpy()  # (K, width), the OVR layout
        self.n_iter_ = int(n_iter)
        self.coef_ = self._coef[:, :-1] if self.fit_intercept else self._coef
        if self.fit_intercept:
            self.intercept_ = self._coef[:, -1]
        self.fit_phase_seconds_ = {"stage": t_stage - t0,
                                   "solve": time.perf_counter() - t_stage}
        return self

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

    def _encode_y_partial(self, y, classes=None):
        # blocks may not show every class: the class set is pinned on the
        # first call, from classes= or from the first block
        y = np.asarray(y)
        if classes is not None:
            classes = np.asarray(classes)
            prior = getattr(self, "_pf_classes", None)
            if prior is not None and not np.array_equal(classes, prior):
                raise ValueError(
                    f"classes={classes!r} changed between partial_fit calls "
                    f"(was {prior!r})")
            self._pf_classes = classes
        if getattr(self, "_pf_classes", None) is None:
            # warm-starting a batch-fitted model: its class set carries
            # over, where one block could miss a class
            fitted = getattr(self, "classes_", None)
            self._pf_classes = (np.asarray(fitted) if fitted is not None
                                else np.unique(y))
        k = len(self._pf_classes)
        if k < 2:
            raise ValueError(
                f"streaming partial_fit requires at least 2 classes, got "
                f"{k}: {self._pf_classes!r} (pass classes= on the first "
                "call when the first block can't show them all)")
        if k > 2 and self.multiclass != "multinomial":
            raise ValueError(
                f"streaming partial_fit with {k} classes trains the "
                "softmax (multinomial) objective; construct the estimator "
                "with multiclass='multinomial' (per-class OVR streaming "
                "is not provided — use batch fit for OVR)")
        self.classes_ = self._pf_classes
        if not np.isin(y, self._pf_classes).all():
            raise ValueError("y contains labels outside `classes`")
        if k == 2:
            return (y == self.classes_[1]).astype(np.float32)
        # class indices, whatever the order of an explicit classes=
        idx = np.argmax(
            y[:, None] == np.asarray(self._pf_classes)[None, :], axis=1)
        return idx.astype(np.float32)

    def _sgd_config(self):
        cfg = super()._sgd_config()
        pf = getattr(self, "_pf_classes", None)
        if pf is not None and len(pf) > 2:
            cfg["n_classes"] = len(pf)
        return cfg

    def _pf_coef_shape(self, width: int) -> tuple:
        pf = getattr(self, "_pf_classes", None)
        if pf is not None and len(pf) > 2:
            return (width, len(pf))
        return (width,)

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

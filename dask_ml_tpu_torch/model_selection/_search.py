"""GridSearchCV / RandomizedSearchCV of the PyTorch port: a host-side
work-sharing driver (a port of ``dask_ml_tpu/model_selection/_search.py``).

There is no task graph: the compute inside an estimator's ``fit`` already
runs on the card, so the search layer is a **host-side thread-pool
driver** with a future-based memo table:

- work-sharing/CSE: each pipeline stage fit is keyed by
  ``token(stage-config, upstream-token, split-id)`` and computed exactly
  once however many candidates share it; identical whole candidates dedupe
  the same way.
- batched candidates: homogeneous candidates (one terminal estimator
  class, the same static params and pipeline prefix) are fit and scored as
  one group through the estimator's ``_batched_fit_score`` protocol
  (KMeans over ``(n_clusters, tol)``, the GLMs over ``C``); the group's
  outputs stay on the card and every group's scores come back in one
  device-to-host copy.
- parallelism: independent candidate×split cells run on host threads;
  PyTorch releases the GIL while it launches and waits on the card.
- ``error_score``/``FIT_FAILURE`` semantics, ``cv_results_`` structure, iid
  weighting, multimetric + refit: see :mod:`.methods`.

The port's own :class:`~dask_ml_tpu_torch.pipeline.Pipeline` and
``FeatureUnion`` are expanded stage by stage; scikit-learn's are too where
scikit-learn imports (it is loaded only when the driver looks for them).
"""

from __future__ import annotations

import numbers
import threading
from concurrent.futures import Future, ThreadPoolExecutor
from contextlib import contextmanager
from typing import Optional

import numpy as np
import torch

from dask_ml_tpu_torch import config as config_lib
from dask_ml_tpu_torch.base import BaseEstimator, is_classifier
from dask_ml_tpu_torch.model_selection import methods
from dask_ml_tpu_torch.model_selection._params import (ParameterGrid,
                                                       ParameterSampler)
from dask_ml_tpu_torch.model_selection._split import check_cv
from dask_ml_tpu_torch.model_selection._tokenize import tokenize
from dask_ml_tpu_torch.model_selection.methods import FIT_FAILURE
from dask_ml_tpu_torch.parallel import mesh as mesh_lib
from dask_ml_tpu_torch.parallel import telemetry
from dask_ml_tpu_torch.pipeline import FeatureUnion, Pipeline, union_concat

__all__ = ["BaseSearchCV", "GridSearchCV", "RandomizedSearchCV",
           "TPUBaseSearchCV"]

#: device-to-host copies of batched-group outputs: ``"bulk"`` counts the
#: one copy of every group's stacked scores a fit makes, ``"cell"`` any
#: score a cell had to read from the card on its own (none, by design)
fetch_counts = {"bulk": 0, "cell": 0}


def reset_fetch_counts() -> None:
    for k in fetch_counts:
        fetch_counts[k] = 0


_COMPOSITE_TYPES: dict = {}


def _composite_types():
    """``(pipeline classes, union classes)``: the port's, and
    scikit-learn's where scikit-learn imports (loaded on first use)."""
    if not _COMPOSITE_TYPES:
        pipes, unions = [Pipeline], [FeatureUnion]
        try:
            from sklearn.pipeline import FeatureUnion as SkUnion
            from sklearn.pipeline import Pipeline as SkPipeline
        except ImportError:
            pass
        else:
            pipes.append(SkPipeline)
            unions.append(SkUnion)
        _COMPOSITE_TYPES.update(pipes=tuple(pipes), unions=tuple(unions))
    return _COMPOSITE_TYPES["pipes"], _COMPOSITE_TYPES["unions"]


def _is_pipeline(est) -> bool:
    return isinstance(est, _composite_types()[0])


def _is_union(est) -> bool:
    return isinstance(est, _composite_types()[1])


# ---------------------------------------------------------------------------
# data slicing / caching (the reference's CVCache, methods.py:67-124)
# ---------------------------------------------------------------------------


def run_with_soft_deadline(fn, timeout, *, caller_cfg=None,
                           name="search-cell"):
    """Run ``fn()`` under a soft daemon-thread deadline: the caller waits
    at most ``timeout`` seconds, then abandons the thread (threads cannot
    be killed — the stray computation finishes in the background but no
    longer blocks the run). Returns ``(value, timed_out)``; exceptions
    from ``fn`` re-raise on the caller. A falsy ``timeout`` runs inline.

    ``caller_cfg`` (a :func:`dask_ml_tpu_torch.config.get_config` subset)
    is re-entered on the deadline thread — config is thread-local, so the
    caller's device/staging knobs must travel with the work.

    One timeout discipline, two consumers: the grid/random driver's
    per-CELL deadline (below) and the JAX package's incremental ASHA
    driver's per-RUNG deadline, whose contract differs only in what a
    timeout means — error_score for a cell, *degrade to the last
    completed rung score* for a streaming candidate.
    """
    if not timeout:
        return fn(), False
    box: dict = {}

    def target():
        # config is thread-local: the deadline thread re-enters it
        try:
            if caller_cfg is None:
                box["result"] = fn()
            else:
                with config_lib.config_context(**caller_cfg):
                    box["result"] = fn()
        except BaseException as e:  # re-raised on the caller
            box["error"] = e

    t = threading.Thread(target=target, daemon=True, name=name)
    t.start()
    t.join(float(timeout))
    if t.is_alive():
        return None, True
    if "error" in box:
        raise box["error"]
    return box["result"], False


def _is_pairwise(est) -> bool:
    try:
        return bool(est.__sklearn_tags__().input_tags.pairwise)
    except Exception:
        return bool(getattr(est, "_pairwise", False))


def _n_rows(a) -> int:
    """Sample count for any X container (ndarray, scipy sparse, frame,
    list) — ``np.asarray(sparse)`` would 0-d wrap it."""
    shape = getattr(a, "shape", None)
    if shape is not None and len(shape) >= 1:
        return int(shape[0])
    return len(a)


def _index(a, idx):
    if a is None:
        return None
    if hasattr(a, "iloc"):
        return a.iloc[idx]
    if hasattr(a, "tocsr"):  # scipy sparse: np.asarray would 0-d wrap it
        return a.tocsr()[idx]
    from dask_ml_tpu_torch.ops.sparse import SparseRows

    if isinstance(a, SparseRows):  # sparse container: row-gather both
        return a[idx]              # leaves (np.asarray would 0-d wrap it)
    if isinstance(a, torch.Tensor):  # rows gathered where they lie
        return a[torch.as_tensor(np.asarray(idx), device=a.device)]
    return np.asarray(a)[idx]


def _content_array(a):
    """A content-hashable stand-in for checkpoint keys: numeric data as the
    actual array (tokenize hashes its bytes), object-dtype / exotic inputs as
    their pickle bytes — so journal keys change whenever data VALUES change,
    not just shapes."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    try:
        arr = np.asarray(a)
    except Exception:
        arr = None
    if arr is not None and arr.dtype != object:
        return arr
    import pickle

    try:
        return pickle.dumps(a, protocol=4)
    except Exception:
        return repr(a)


class CVCache:
    """Materialized train/test slices per split, cached per search
    (reference: methods.py:67-124). ``extract(..., pairwise=True)`` slices
    both axes of a precomputed kernel matrix the way the reference does
    (methods.py:110-124).

    ``device_slices=True`` (set by the driver when every candidate stage
    is one of the port's estimators): X uploads to the configured device
    ONCE, as one float32 tensor, and train/test slices are
    ``index_select`` gathers there — uploading every CV slice separately
    costs ~2× the bytes of X per split pair. The upload makes one NaN/inf
    scan (one host read); finite data marks every slice trusted in the
    active staging scope, so the estimators skip their own scans.
    Non-finite data is not an error here: its slices stay untrusted, each
    estimator's ``check_array`` raises inside ``methods.fit`` and the cells
    follow ``error_score``. y and pairwise-kernel slicing stay host-side.
    The upload and the cache are under locks: the cell pool drives them
    from several threads.
    """

    def __init__(self, splits, X, y, cache: bool = True,
                 device_slices: bool = False):
        self.splits = list(splits)
        self.X = X
        self.y = y
        self.cache = {} if cache else None
        self._cache_lock = threading.Lock()
        self._x_dev = None
        self._x_finite = False
        self._dev_lock = threading.Lock()
        self.device_slices = bool(device_slices) and self._device_sliceable(X)

    @staticmethod
    def _device_sliceable(X) -> bool:
        if X is None or hasattr(X, "iloc"):
            return False
        if isinstance(X, torch.Tensor):
            return X.ndim == 2 and not X.is_complex()
        try:
            arr = np.asarray(X)
        except Exception:
            return False
        return arr.ndim == 2 and arr.dtype.kind in "fiub"

    def _device_slice(self, idx):
        from dask_ml_tpu_torch.parallel.sharding import _current_memo

        with self._dev_lock:
            if self._x_dev is None:
                dev = config_lib.resolve_device()
                x = torch.as_tensor(self.X).to(device=dev,
                                               dtype=torch.float32)
                self._x_finite = bool(torch.isfinite(x).all())
                self._x_dev = x.contiguous()
        index = torch.as_tensor(np.asarray(idx, dtype=np.int64)).to(
            self._x_dev.device, non_blocking=True)
        out = torch.index_select(self._x_dev, 0, index)
        memo = _current_memo()
        if memo is not None and self._x_finite:
            memo.trust(out)
        return out

    def n_test(self, split_idx: int) -> int:
        return len(self.splits[split_idx][1])

    def planned_buckets(self) -> list:
        """Sorted sample counts the fold slices stage to. On one device
        (or a world of one rank) the port pads nothing: the exact train
        and test sizes. Over a mesh of more than one data shard staging
        pads each slice to the active policy's bucket aligned to the
        shard count, as the JAX package plans it."""
        from dask_ml_tpu_torch.parallel import shapes

        mesh = mesh_lib.collective_mesh()
        sizes = {len(idx) for tr, te in self.splits for idx in (tr, te)}
        if not mesh_lib.is_sharded(mesh):
            return sorted(sizes)
        align = mesh_lib.n_data_shards(mesh)
        return sorted({shapes.bucket_rows(n, align=align, record=False)
                       for n in sizes})

    def extract(self, split_idx: int, train: bool, is_x: bool = True,
                pairwise: bool = False):
        key = (split_idx, train, is_x, pairwise)
        if self.cache is not None:
            with self._cache_lock:
                if key in self.cache:
                    return self.cache[key]
        train_idx, test_idx = self.splits[split_idx]
        idx = train_idx if train else test_idx
        if not is_x:
            out = _index(self.y, idx)
        elif pairwise:
            X = np.asarray(self.X)
            if X.ndim != 2 or X.shape[0] != X.shape[1]:
                raise ValueError(
                    "X should be a square kernel matrix for pairwise "
                    "estimators"
                )
            out = X[np.ix_(idx, train_idx)]
        elif self.device_slices:
            out = self._device_slice(idx)
        else:
            out = _index(self.X, idx)
        if self.cache is not None:
            with self._cache_lock:
                out = self.cache.setdefault(key, out)
        return out


# ---------------------------------------------------------------------------
# future-based memo (the analogue of graph-key CSE)
# ---------------------------------------------------------------------------


class _Memo:
    """token → Future; the first thread to claim a token computes it, every
    other candidate sharing the token waits on the same future. This gives the
    reference's graph-level CSE (one task per distinct key) under threads.

    Each entry also records a human label, its upstream keys, and how many
    cells consumed it — the data behind ``shared_fit_report()`` /
    ``visualize()`` (the reference's ``GridSearchCV.visualize`` renders the
    shared-fit dask graph the same way, _search.py:870-894)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._futures: dict[str, Future] = {}
        self._meta: dict[str, dict] = {}
        self._peek_depth = 0

    @contextmanager
    def peek_scope(self):
        """Scope whose ``get_or_run`` calls don't count as consumers — the
        driver's batched-group pre-pass dispatches every group program for
        bulk-fetching, but only CELLS consume results; counting the
        pre-pass would inflate ``shared_fit_report``/``visualize`` by one
        per (group, split) and per pre-fetched prefix node. Single-threaded
        use only (the pre-pass runs before the worker pool starts)."""
        self._peek_depth += 1
        try:
            yield
        finally:
            self._peek_depth -= 1

    def get_or_run(self, key: str, fn, label: Optional[str] = None,
                   parents: tuple = ()):
        with self._lock:
            meta = self._meta.setdefault(
                key, {"label": label, "parents": tuple(parents),
                      "consumers": 0})
            if not self._peek_depth:
                meta["consumers"] += 1
            if label and not meta["label"]:
                meta["label"] = label
            fut = self._futures.get(key)
            owner = fut is None
            if owner:
                fut = Future()
                self._futures[key] = fut
        if owner:
            try:
                fut.set_result(fn())
            except BaseException as e:  # error_score='raise' path
                fut.set_exception(e)
        return fut.result()

    @property
    def n_entries(self) -> int:
        return len(self._futures)

    def report(self) -> dict:
        with self._lock:
            return {k: dict(m) for k, m in self._meta.items()}


# ---------------------------------------------------------------------------
# scoring resolution
# ---------------------------------------------------------------------------


def _passthrough_scorer(est, X, y):
    return est.score(X, y)


def _scoring_identity(scoring):
    """Content identity of a ``scoring=`` spec, for checkpoint cell keys.

    Journal records must invalidate when the scoring CHANGES, including a
    different custom callable under the same slot name (ADVICE r3: keying on
    ``sorted(scorers)`` alone restored stale scores after swapping a scorer).
    String specs identify by name; callables by code/attribute content
    (bytecode + global names + consts + closure values — see
    ``_tokenize._callable_identity``), which is stable across processes AND
    changes when the scorer's implementation changes — pickle bytes would do
    neither for module-level functions (serialized by reference) or lambdas
    (unpicklable).
    """
    from dask_ml_tpu_torch.model_selection._tokenize import (
        _callable_identity, _stable_repr)

    if scoring is None or isinstance(scoring, str):
        return ("named", scoring)
    if callable(scoring):
        return _callable_identity(scoring)
    if isinstance(scoring, (list, tuple, set)):
        return ("list", tuple(sorted(scoring)))
    if isinstance(scoring, dict):
        return ("dict", tuple(
            (name, _scoring_identity(s))
            for name, s in sorted(scoring.items())
        ))
    return ("repr", _stable_repr(scoring))


def _lookup_scorer(name: str):
    from dask_ml_tpu_torch.metrics.scorer import get_scorer

    return get_scorer(name)


def _resolve_scoring(estimator, scoring):
    """→ (scorers: {name: callable}, multimetric: bool).

    Mirrors the reference's scorer setup incl. multimetric
    (reference: _search.py:789-818)."""
    if scoring is None:
        if not hasattr(estimator, "score"):
            raise TypeError(
                f"estimator {estimator!r} has no score method; pass scoring="
            )
        return {"score": _passthrough_scorer}, False
    if isinstance(scoring, str):
        return {"score": _lookup_scorer(scoring)}, False
    if callable(scoring):
        return {"score": scoring}, False
    if isinstance(scoring, (list, tuple, set)):
        names = list(scoring)
        if len(set(names)) != len(names):
            raise ValueError(f"Duplicate scorer names in {names!r}")
        if not all(isinstance(n, str) for n in names):
            raise ValueError(
                "multimetric scoring as a list requires string names"
            )
        return {n: _lookup_scorer(n) for n in names}, True
    if isinstance(scoring, dict):
        return (
            {
                n: (_lookup_scorer(s) if isinstance(s, str) else s)
                for n, s in scoring.items()
            },
            True,
        )
    raise ValueError(f"Invalid scoring: {scoring!r}")


# ---------------------------------------------------------------------------
# candidate execution with pipeline-prefix sharing
# ---------------------------------------------------------------------------


def _split_pipeline_params(steps, params):
    """Partition candidate params into per-stage dicts keyed by stage name;
    top-level (non-prefixed) params are rejected the way set_params would be."""
    names = [name for name, _ in steps]
    per_stage = {name: {} for name in names}
    top = {}
    for key, value in params.items():
        if "__" in key:
            stage, _, sub = key.partition("__")
            if stage in per_stage:
                per_stage[stage][sub] = value
                continue
        top[key] = value
    return per_stage, top


def _is_dropped(trans) -> bool:
    return trans is None or trans == "drop"


class _CandidateRunner:
    """Executes one (candidate, split) cell with memoized stage fits."""

    def __init__(self, estimator, cv_cache: CVCache, memo: _Memo, scorers,
                 error_score, return_train_score: bool, fit_params=None,
                 retry_policy=None):
        self.estimator = estimator
        self.cv_cache = cv_cache
        self.memo = memo
        self.scorers = scorers
        self.error_score = error_score
        self.return_train_score = return_train_score
        self.fit_params = fit_params or {}
        # transient-error retry for cell fits (parallel/faults.RetryPolicy):
        # a flaky-I/O or device-transfer failure re-attempts from a fresh
        # estimator copy before degrading to error_score semantics
        self.retry_policy = retry_policy
        self._n_samples = (
            None if cv_cache.X is None else _n_rows(cv_cache.X)
        )
        self._fp_cache: dict[int, dict] = {}
        self._fp_lock = threading.Lock()
        self.n_batched_done = 0  # cells that actually took the batched path
        self._batched_lock = threading.Lock()

    def _fit_params_for(self, split_idx):
        """Per-split fit params: array-likes aligned with the sample axis are
        sliced by the split's train indices (sklearn's _check_method_params
        behavior); everything else passes through whole."""
        if not self.fit_params:
            return {}
        with self._fp_lock:
            if split_idx in self._fp_cache:
                return self._fp_cache[split_idx]
        train_idx, _ = self.cv_cache.splits[split_idx]
        out = {}
        for name, value in self.fit_params.items():
            if (
                hasattr(value, "__len__")
                and not isinstance(value, str)
                and self._n_samples is not None
                and len(value) == self._n_samples
            ):
                out[name] = _index(value, train_idx)
            else:
                out[name] = value
        with self._fp_lock:
            self._fp_cache[split_idx] = out
        return out

    # -- plain estimator -------------------------------------------------
    def _fit_plain(self, params, split_idx):
        est = self.estimator
        pairwise = _is_pairwise(est)
        key = tokenize("fit", type(est), est.get_params(deep=True),
                       params, sorted(self.fit_params), split_idx, pairwise)

        def run():
            X = self.cv_cache.extract(split_idx, train=True, pairwise=pairwise)
            y = self.cv_cache.extract(split_idx, train=True, is_x=False)
            return methods.fit(
                est, X, y, params=params,
                fit_params=self._fit_params_for(split_idx),
                error_score=self.error_score,
                retry_policy=self.retry_policy,
            )

        return self.memo.get_or_run(
            key, run, label=f"fit:{type(est).__name__}")

    # -- recursive composite expansion with CSE --------------------------
    #
    # Pipelines and FeatureUnions are expanded recursively so every leaf
    # transformer fit is its own memo entry: pipeline prefixes are shared
    # across candidates (reference: _search.py:462-503 ``_do_pipeline``) and
    # union sub-transformers are shared across candidates *including ones that
    # differ only in transformer_weights*, because weights apply at the concat
    # step, not the fit (reference: _search.py:524-593 ``_do_featureunion``,
    # methods.py:169-187).

    def _root_token(self, split_idx):
        return tokenize("pipe-root", split_idx)

    def _resolve_input(self, upstream, split_idx, root_pairwise: bool = False):
        """Train-side input identified by ``upstream``: the original slice at
        the root token, else the transformed output stored in the upstream
        node's memo entry. Safe to read here: any thread reaching node *i+1*
        already passed through node *i*'s ``get_or_run`` in its own recursion,
        so the upstream future exists and resolving it cannot race."""
        if upstream == self._root_token(split_idx):
            return self.cv_cache.extract(split_idx, train=True,
                                         pairwise=root_pairwise)

        def missing():  # pragma: no cover - ordering invariant
            raise RuntimeError("upstream node output missing")

        (_, Xt), _t = self.memo.get_or_run(upstream, missing)
        return Xt

    def _y_train(self, split_idx):
        return self.cv_cache.extract(split_idx, train=True, is_x=False)

    def _fit_transform_any(self, est, params, sfit, upstream, split_idx,
                           root_pairwise=False):
        """Fit+transform a node in the composite tree.
        Returns ``(token, fitted, Xt, fit_time, failed)``; ``token`` has a
        memo entry of shape ``((fitted, Xt), time)`` so it can serve as the
        ``upstream`` of downstream nodes."""
        if _is_pipeline(est):
            return self._ft_pipeline(est, params, sfit, upstream, split_idx,
                                     root_pairwise, need_transform=True)
        if _is_union(est):
            return self._ft_union(est, params, sfit, upstream, split_idx,
                                  root_pairwise, need_transform=True)
        key = tokenize("stage", upstream, type(est),
                       est.get_params(deep=True), params, sorted(sfit), "ft")

        def run_stage():
            Xin = self._resolve_input(upstream, split_idx, root_pairwise)
            return methods.fit_transform(
                est, Xin, self._y_train(split_idx), params=params,
                fit_params=sfit, error_score=self.error_score,
                retry_policy=self.retry_policy,
            )

        (fitted, Xt), t = self.memo.get_or_run(
            key, run_stage, label=f"fit_transform:{type(est).__name__}",
            parents=(upstream,))
        return key, fitted, Xt, t, fitted is FIT_FAILURE

    def _fit_any(self, est, params, sfit, upstream, split_idx,
                 root_pairwise=False):
        """Fit-only variant (terminal nodes: the last pipeline stage, or the
        search estimator itself). Returns ``(token, fitted, fit_time,
        failed)``."""
        if _is_pipeline(est):
            token, fitted, _Xt, t, failed = self._ft_pipeline(
                est, params, sfit, upstream, split_idx, root_pairwise,
                need_transform=False,
            )
            return token, fitted, t, failed
        if _is_union(est):
            token, fitted, _Xt, t, failed = self._ft_union(
                est, params, sfit, upstream, split_idx, root_pairwise,
                need_transform=False,
            )
            return token, fitted, t, failed
        key = tokenize("stage", upstream, type(est),
                       est.get_params(deep=True), params, sorted(sfit), "fit")

        def run_fit():
            Xin = self._resolve_input(upstream, split_idx, root_pairwise)
            return methods.fit(
                est, Xin, self._y_train(split_idx), params=params,
                fit_params=sfit, error_score=self.error_score,
                retry_policy=self.retry_policy,
            )

        fitted, t = self.memo.get_or_run(
            key, run_fit, label=f"fit:{type(est).__name__}",
            parents=(upstream,))
        return key, fitted, t, fitted is FIT_FAILURE

    def _ft_atomic_fallback(self, est, params, sfit, upstream, split_idx,
                            root_pairwise, need_transform):
        """Whole-object fit for composites whose candidate params target the
        composite itself (e.g. ``steps=``/``transformer_list=`` overrides):
        no sub-sharing is possible, same fallback the reference takes."""
        mode = "ft" if need_transform else "fit"
        key = tokenize("whole", upstream, type(est),
                       est.get_params(deep=True), params, sorted(sfit), mode)

        def run_whole():
            Xin = self._resolve_input(upstream, split_idx, root_pairwise)
            y = self._y_train(split_idx)
            if need_transform:
                return methods.fit_transform(
                    est, Xin, y, params=params, fit_params=sfit,
                    error_score=self.error_score,
                    retry_policy=self.retry_policy,
                )
            return methods.fit(
                est, Xin, y, params=params, fit_params=sfit,
                error_score=self.error_score,
                retry_policy=self.retry_policy,
            )

        wl = f"whole-{mode}:{type(est).__name__}"
        if need_transform:
            (fitted, Xt), t = self.memo.get_or_run(
                key, run_whole, label=wl, parents=(upstream,))
        else:
            fitted, t = self.memo.get_or_run(
                key, run_whole, label=wl, parents=(upstream,))
            Xt = None
        return key, fitted, Xt, t, fitted is FIT_FAILURE

    def _ft_pipeline(self, pipe, params, sfit, upstream, split_idx,
                     root_pairwise, need_transform):
        per_stage, top = _split_pipeline_params(pipe.steps, params)
        per_stage_fp, top_fp = _split_pipeline_params(pipe.steps, sfit)
        if top or top_fp:
            return self._ft_atomic_fallback(
                pipe, params, sfit, upstream, split_idx, root_pairwise,
                need_transform,
            )
        token = upstream
        fitted_steps = []
        total_time = 0.0
        failed = False
        Xt = None
        for i, (name, stage) in enumerate(pipe.steps):
            if _is_dropped(stage) or stage == "passthrough":
                # identity stage: downstream input IS the upstream data, so
                # the token must stay unchanged (it has a resolvable memo
                # entry / root slice; a synthetic re-token would not)
                fitted_steps.append((name, stage))
                continue
            sparams = per_stage[name]
            stage_fp = per_stage_fp.get(name) or {}
            is_last = i == len(pipe.steps) - 1
            if is_last and not need_transform:
                token, fitted, t, f = self._fit_any(
                    stage, sparams, stage_fp, token, split_idx, root_pairwise)
            else:
                token, fitted, Xt, t, f = self._fit_transform_any(
                    stage, sparams, stage_fp, token, split_idx, root_pairwise)
            total_time += t
            if f:
                failed = True
                fitted_steps.append((name, FIT_FAILURE))
                break
            fitted_steps.append((name, fitted))
        if failed:
            return token, FIT_FAILURE, FIT_FAILURE, total_time, True
        out = methods.copy_estimator(pipe)
        out.steps = fitted_steps
        if need_transform and Xt is None:
            # every stage was identity (passthrough/dropped): the pipeline's
            # transform output IS its input — resolve it so a FeatureUnion
            # parent has a real array to concatenate, like sklearn's
            # identity branch
            Xt = self._resolve_input(token, split_idx, root_pairwise)
        # `token` is the last real stage's token; its memo entry already holds
        # Xt, but for a fit-only tail there is no transform output to expose.
        return token, out, Xt, total_time, False

    _UNION_SELF_PARAMS = ("n_jobs", "verbose", "verbose_feature_names_out")

    def _ft_union(self, union, params, sfit, upstream, split_idx,
                  root_pairwise, need_transform):
        per_sub, top = _split_pipeline_params(union.transformer_list, params)
        per_sub_fp, top_fp = _split_pipeline_params(union.transformer_list, sfit)
        top = dict(top)
        weights = union.transformer_weights
        if "transformer_weights" in top:
            weights = top.pop("transformer_weights")
        self_params = {
            k: top.pop(k) for k in list(top) if k in self._UNION_SELF_PARAMS
        }
        if top or top_fp:
            # e.g. transformer_list= overrides, or params for an unknown name
            return self._ft_atomic_fallback(
                union, params, sfit, upstream, split_idx, root_pairwise,
                need_transform,
            )

        sub_tokens = []
        sub_fitted = []
        sub_parts = []  # (name, Xt) for concat, transform-producing subs only
        total_time = 0.0
        failed = False
        for name, trans in union.transformer_list:
            if _is_dropped(trans):
                sub_tokens.append("drop")
                sub_fitted.append((name, trans))
                continue
            if trans == "passthrough":
                # identity member (sklearn accepts the sentinel here too):
                # contributes the union's INPUT columns unchanged. Candidate
                # params targeting it cannot apply — hard error, as
                # sklearn's set_params would raise (never a silent drop
                # that would also collapse distinct candidates' memo keys)
                stray = dict(per_sub.get(name) or {})
                stray.update(per_sub_fp.get(name) or {})
                if stray:
                    raise ValueError(
                        f"parameters {sorted(stray)} target union member "
                        f"'{name}', which is 'passthrough'"
                    )
                sub_tokens.append(upstream)
                sub_fitted.append((name, trans))
                if need_transform:
                    sub_parts.append((name, self._resolve_input(
                        upstream, split_idx, root_pairwise)))
                continue
            if need_transform:
                tok, fitted, Xt, t, f = self._fit_transform_any(
                    trans, per_sub[name], per_sub_fp.get(name) or {},
                    upstream, split_idx, root_pairwise,
                )
                sub_parts.append((name, Xt))
            else:
                tok, fitted, t, f = self._fit_any(
                    trans, per_sub[name], per_sub_fp.get(name) or {},
                    upstream, split_idx, root_pairwise,
                )
            total_time += t
            failed = failed or f
            sub_tokens.append(tok)
            sub_fitted.append((name, fitted))

        wkey = sorted(weights.items()) if weights else None
        mode = "ft" if need_transform else "fit"
        ckey = tokenize("union-concat", sub_tokens, wkey,
                        sorted(self_params.items()), mode)

        def assemble():
            if failed:
                return (FIT_FAILURE, FIT_FAILURE), 0.0
            out = methods.copy_estimator(union)
            if self_params:
                out.set_params(**self_params)
            out.transformer_list = list(sub_fitted)
            out.transformer_weights = weights
            Xt = None
            if need_transform:
                n_rows = _n_rows(
                    self._resolve_input(upstream, split_idx, root_pairwise))
                Xt = union_concat(sub_parts, weights, n_rows)
            return (out, Xt), 0.0

        (fitted_union, Xt), t_assemble = self.memo.get_or_run(
            ckey, assemble, label="union-concat",
            parents=tuple(t for t in sub_tokens if t != "drop"))
        total_time += t_assemble
        return (ckey, fitted_union, Xt, total_time,
                fitted_union is FIT_FAILURE)

    # -- batched candidate cells (fast path) -----------------------------
    #
    # Homogeneous candidates (same estimator class, same static params,
    # same upstream pipeline prefix) are fit+scored as ONE group via the
    # terminal estimator's ``_batched_fit_score`` protocol, which leaves
    # its scores on the card for the driver's one bulk copy, instead of a
    # fit, a score and a host read per cell. The memo makes the group run
    # exactly once however many member cells land on the pool.

    def _prefix_root_pairwise(self, est):
        if not _is_pipeline(est):
            return _is_pairwise(est)
        first_real = next(
            (s for _, s in est.steps
             if not _is_dropped(s) and s != "passthrough"),
            None,
        )
        return _is_pairwise(first_real) if first_real is not None else False

    _PREFIX_FAILED = "prefix-failed"

    def batched_group_out(self, params, split_idx, group):
        """Dispatch (or memo-hit) a group's fit+score program.

        Returns ``(result, t_prefix)`` where ``result`` is
        ``(out_dict, t_group)``, ``None`` (group program failed under a
        numeric error_score), or ``_PREFIX_FAILED``. ``out_dict['scores']``
        may hold device tensors: a batched fit reads nothing back from the
        card, and the driver's pre-pass copies every group's scores to
        the host in ONE copy (:func:`_bulk_fetch`) before cells read
        member values — a read per group would wait on the card each
        time."""
        from timeit import default_timer

        est = self.estimator
        root_pairwise = self._prefix_root_pairwise(est)
        t_prefix = 0.0
        if _is_pipeline(est):
            term_name, term_est = est.steps[-1]
            prefix_steps = est.steps[:-1]
            root = self._root_token(split_idx)
            prefix_params = {
                k: v for k, v in params.items()
                if not k.startswith(term_name + "__")
            }
            if prefix_steps:
                # the prefix fits through the SAME recursive CSE machinery
                # (and thus the same memo tokens) as unbatched candidates
                token, fitted_prefix, Xt, t_prefix, failed = (
                    self._ft_pipeline(
                        type(est)(prefix_steps), prefix_params, {}, root,
                        split_idx, root_pairwise, need_transform=True,
                    ))
                if failed:
                    return self._PREFIX_FAILED, t_prefix
            else:
                token = root
                Xt = self._resolve_input(root, split_idx, root_pairwise)
                fitted_prefix = None
        else:
            term_est = est
            token = self._root_token(split_idx)
            Xt = self.cv_cache.extract(split_idx, train=True,
                                       pairwise=root_pairwise)
            fitted_prefix = None

        def compute_test_input():
            Xe = self.cv_cache.extract(split_idx, train=False,
                                       pairwise=root_pairwise)
            if fitted_prefix is not None:
                for _name, stage in fitted_prefix.steps:
                    if _is_dropped(stage) or stage == "passthrough":
                        continue
                    Xe = stage.transform(Xe)
            return Xe

        test_key = tokenize("batch-test-input", token, split_idx)
        X_test = self.memo.get_or_run(
            test_key, compute_test_input, label="batch-test-input",
            parents=(token,))

        gkey = tokenize(
            "batch-cells", token, split_idx, type(term_est),
            term_est.get_params(deep=True), sorted(group.static.items()),
            group.token, self.return_train_score,
        )

        def run_group():
            t0 = default_timer()
            y_test = self.cv_cache.extract(split_idx, train=False,
                                           is_x=False)
            evals = [(X_test, y_test)]
            if self.return_train_score:
                evals.append((Xt, self._y_train(split_idx)))

            def attempt():
                # fresh copy per attempt: a transient failure mid-program
                # must not leak partially-mutated estimator state (e.g.
                # classes_ set by _encode_y) into the retry
                est_c = methods.copy_estimator(term_est)
                if group.static:
                    est_c.set_params(**group.static)
                return est_c._batched_fit_score(
                    Xt, self._y_train(split_idx), group.members, evals)

            try:
                if self.retry_policy is None:
                    out = attempt()
                else:
                    out = self.retry_policy.run(
                        attempt, kind="search-fit",
                        detail=f"batch:{type(term_est).__name__}")
            except Exception as e:
                if self.error_score == "raise":
                    raise
                methods.warn_fit_failure(self.error_score, e)
                return None  # whole-group failure
            if out is NotImplemented:
                # the estimator declined at runtime (e.g. the program's
                # memory footprint): members run per-cell instead
                return NotImplemented
            return out, default_timer() - t0

        result = self.memo.get_or_run(
            gkey, run_group,
            label=(f"batch-cells:{type(term_est).__name__}"
                   f"[{len(group.members)} members]"),
            parents=(token,))
        return result, t_prefix

    def run_batched(self, params, split_idx, group, member_idx):
        """One cell through its batch group. Same result contract as
        :meth:`run`; the group fit+score executes once per (group, split)."""
        result, t_prefix = self.batched_group_out(params, split_idx, group)
        if result is NotImplemented:
            # runtime decline by the estimator: the per-cell path still
            # shares prefix fits through the same memo tokens
            return self.run(params, split_idx)
        if result is self._PREFIX_FAILED or result is None:
            test, train, score_time = methods.score(
                FIT_FAILURE, None, None,
                None if not self.return_train_score else FIT_FAILURE,
                None, self.scorers, self.error_score)
            return test, train, t_prefix, score_time, True
        out, t_group = result
        with self._batched_lock:
            self.n_batched_done += 1
        n_members = max(len(group.members), 1)
        test = {"score": _member_score(out["scores"][0], member_idx)}
        train = None
        if self.return_train_score:
            train = {"score": _member_score(out["scores"][1], member_idx)}
        # wall-time attribution: the group's cost is shared evenly
        return test, train, t_prefix + t_group / n_members, 0.0, False

    # -- one cell --------------------------------------------------------
    def run(self, params, split_idx):
        est = self.estimator
        if (_is_pipeline(est) or _is_union(est)):
            root = self._root_token(split_idx)
            root_pairwise = False
            if _is_pipeline(est):
                first_real = next(
                    (s for _, s in est.steps
                     if not _is_dropped(s) and s != "passthrough"),
                    None,
                )
                root_pairwise = (
                    _is_pairwise(first_real) if first_real is not None else False
                )
            _tok, fitted, fit_time, _failed = self._fit_any(
                est, params, self._fit_params_for(split_idx), root, split_idx,
                root_pairwise,
            )
        else:
            fitted, fit_time = self._fit_plain(params, split_idx)

        pairwise = _is_pairwise(est)
        X_test = self.cv_cache.extract(split_idx, train=False, pairwise=pairwise)
        y_test = self.cv_cache.extract(split_idx, train=False, is_x=False)
        X_train = y_train = None
        if self.return_train_score:
            X_train = self.cv_cache.extract(split_idx, train=True,
                                            pairwise=pairwise)
            y_train = self.cv_cache.extract(split_idx, train=True, is_x=False)
        test, train, score_time = methods.score(
            fitted, X_test, y_test, X_train, y_train, self.scorers,
            self.error_score,
        )
        return test, train, fit_time, score_time, fitted is FIT_FAILURE


def _member_score(scores, member_idx) -> float:
    """One member's score from a group output: a host array after the
    driver's bulk fetch. A score still on the card (a group that missed
    the bulk fetch) is read alone, and counted."""
    if isinstance(scores, torch.Tensor):
        fetch_counts["cell"] += 1
        return float(scores[member_idx])
    return float(np.asarray(scores)[member_idx])


def _bulk_fetch(outs) -> None:
    """Every group output's score vectors to the host in ONE device-to-host
    copy per device (the stacked scores), replacing the tensors in place
    with host arrays. Per-group reads would each wait on the card."""
    for o in outs:
        o["scores"] = list(o["scores"])
    slots = [(o, i) for o in outs for i, t in enumerate(o["scores"])
             if isinstance(t, torch.Tensor)]
    by_dev: dict = {}
    for o, i in slots:
        by_dev.setdefault(o["scores"][i].device, []).append((o, i))
    for members in by_dev.values():
        flat = [o["scores"][i].reshape(-1).to(torch.float64)
                for o, i in members]
        host = torch.cat(flat).cpu().numpy()
        fetch_counts["bulk"] += 1
        at = 0
        for (o, i), t in zip(members, flat):
            o["scores"][i] = host[at:at + t.numel()]
            at += t.numel()


# ---------------------------------------------------------------------------
# batched-candidate planning
# ---------------------------------------------------------------------------


class _BatchGroup:
    """A bucket of homogeneous candidates fit+scored as one program."""

    __slots__ = ("members", "static", "token")

    def __init__(self, members, static, token):
        self.members = members  # list of varying-param dicts, one/member
        self.static = static  # terminal-stage overrides shared by the group
        self.token = token


def _plan_batched_groups(estimator, candidate_params, scorers, fit_params,
                         n_train_min=None):
    """→ ``{candidate_index: (_BatchGroup, member_idx)}`` for candidates
    eligible for the batched fast path (empty dict = everything runs the
    per-cell path).

    Eligibility: passthrough scoring only (the estimator's own ``score`` is
    what the batched program can compute in bulk; arbitrary scorer callables
    can't be batched), no fit_params, a terminal estimator declaring the
    protocol (``_batchable_params`` + ``_batched_fit_score``), candidates
    whose terminal params vary ONLY in batchable keys grouped by (prefix
    params, static terminal params), groups of ≥ 2. A candidate the
    estimator's ``_batchable_member_ok`` hook rejects (e.g. KMeans with
    ``n_clusters`` > the smallest train split) is EXCLUDED from its group
    and takes the per-cell path, so its individual failure follows
    error_score semantics instead of poisoning the whole group's program.
    """
    if fit_params:
        return {}
    if set(scorers) != {"score"} or scorers["score"] is not _passthrough_scorer:
        return {}
    if _is_pipeline(estimator):
        if not estimator.steps:
            return {}
        term_name, term = estimator.steps[-1]
        if _is_dropped(term) or term == "passthrough" or _is_pipeline(
                term) or _is_union(term):
            return {}
        prefix = term_name + "__"

        def split_params(p):
            tp, rest = {}, {}
            for k, v in p.items():
                if k.startswith(prefix):
                    tp[k[len(prefix):]] = v
                else:
                    rest[k] = v
            return tp, rest

    elif _is_union(estimator):
        return {}
    else:
        term = estimator

        def split_params(p):
            return dict(p), {}

    batchable = getattr(type(term), "_batchable_params", None)
    if not batchable or not hasattr(term, "_batched_fit_score"):
        return {}

    buckets: dict = {}
    for ci, p in enumerate(candidate_params):
        if _is_pipeline(estimator) and any(
                "__" not in k for k in p):
            continue  # top-level overrides (steps=, stage replacement)
        tp, rest = split_params(p)
        varying = {k: v for k, v in tp.items() if k in batchable}
        static = {k: v for k, v in tp.items() if k not in batchable}
        merged = {**term.get_params(deep=False), **static}
        try:
            if not term._supports_batched(merged):
                continue
            member_ok = getattr(term, "_batchable_member_ok", None)
            if member_ok is not None and not member_ok(
                    {**merged, **varying}, n_train_min):
                continue
        except Exception:
            continue
        gk = tokenize("plan", sorted(rest.items()), sorted(static.items()))
        b = buckets.setdefault(gk, {"static": static, "members": [],
                                    "cis": []})
        b["members"].append(varying)
        b["cis"].append(ci)

    plan: dict = {}
    for b in buckets.values():
        if len(b["cis"]) < 2:
            continue
        grp = _BatchGroup(
            b["members"], b["static"],
            tokenize("members", b["members"], sorted(b["static"].items())),
        )
        for mi, ci in enumerate(b["cis"]):
            plan[ci] = (grp, mi)
    return plan


def _all_stages_device_native(estimator) -> bool:
    """True when the estimator (or every pipeline stage) is one of the
    port's estimators — the condition under which the driver turns on
    ``device_outputs`` so stage outputs chain device→device. The test is
    the module prefix with its dot: the JAX package's estimators
    (``dask_ml_tpu.``) are foreign here."""
    def native(e):
        return type(e).__module__.startswith("dask_ml_tpu_torch.")

    if _is_pipeline(estimator):
        stages = [s for _, s in estimator.steps
                  if not _is_dropped(s) and s != "passthrough"]
        return bool(stages) and all(native(s) for s in stages)
    return native(estimator)


# ---------------------------------------------------------------------------
# the estimators
# ---------------------------------------------------------------------------


def _normalize_n_jobs(n_jobs):
    """-1 → one thread per host core (reference: _search.py:659-666)."""
    import os

    if n_jobs is None:
        return 1
    if n_jobs == -1:
        return os.cpu_count() or 1
    if n_jobs < 1:
        raise ValueError(f"n_jobs must be -1 or >= 1, got {n_jobs}")
    return int(n_jobs)


class BaseSearchCV(BaseEstimator):
    """Shared driver for grid and randomized search
    (reference: _search.py:669-894 ``DaskBaseSearchCV``)."""

    def __init__(self, estimator, scoring=None, iid=True, refit=True, cv=None,
                 error_score="raise", return_train_score=True, scheduler=None,
                 n_jobs=-1, cache_cv=True, checkpoint=None,
                 cell_retries=0, cell_timeout=None):
        self.estimator = estimator
        self.scoring = scoring
        self.iid = iid
        self.refit = refit
        self.cv = cv
        self.error_score = error_score
        self.return_train_score = return_train_score
        # accepted for reference-signature parity; placement is the
        # configured device's job
        self.scheduler = scheduler
        self.n_jobs = n_jobs
        self.cache_cv = cache_cv
        # path to an append-only cell journal; fit() resumes from it
        # (SURVEY §5.4 — capability-parity-plus over the reference)
        self.checkpoint = checkpoint
        # fault tolerance (docs/robustness.md): cell_retries re-attempts a
        # cell fit after a TRANSIENT failure (host I/O, device transfer —
        # parallel/faults.RetryPolicy classification) before the usual
        # error_score degradation; cell_timeout (seconds) is a SOFT per-cell
        # deadline — an overrunning cell scores error_score and the sweep
        # moves on, instead of one hung candidate poisoning the run
        self.cell_retries = cell_retries
        self.cell_timeout = cell_timeout

    def _get_param_iterator(self):  # pragma: no cover - abstract
        raise NotImplementedError

    # -- fit -------------------------------------------------------------
    def fit(self, X, y=None, groups=None, **fit_params):
        estimator = self.estimator
        if not (
            isinstance(self.error_score, numbers.Number)
            or self.error_score == "raise"
        ):
            raise ValueError(
                "error_score must be the string 'raise' or a numeric value"
            )
        scorers, multimetric = _resolve_scoring(estimator, self.scoring)
        refit_metric = self._check_refit(multimetric, scorers)

        # plain python sequences are legal inputs (sklearn's indexable()
        # contract); the split/slice machinery wants arrays
        if (X is not None and not hasattr(X, "shape")
                and not hasattr(X, "iloc") and not hasattr(X, "tocsr")):
            X = np.asarray(X)
        if (y is not None and not hasattr(y, "shape")
                and not hasattr(y, "iloc")):
            y = np.asarray(y)

        cv = check_cv(self.cv, y, classifier=is_classifier(estimator))
        splits = list(cv.split(X, y, groups))
        n_splits = len(splits)
        device_native = _all_stages_device_native(estimator)
        cv_cache = CVCache(splits, X, y, cache=self.cache_cv,
                           device_slices=device_native)

        candidate_params = list(self._get_param_iterator())
        n_candidates = len(candidate_params)

        memo = _Memo()
        retry_policy = None
        if self.cell_retries:
            from dask_ml_tpu_torch.parallel.faults import RetryPolicy

            retry_policy = RetryPolicy(max_retries=int(self.cell_retries))
        runner = _CandidateRunner(
            estimator, cv_cache, memo, scorers,
            self.error_score, self.return_train_score, fit_params=fit_params,
            retry_policy=retry_policy,
        )

        cells = [
            (ci, si)
            for ci in range(n_candidates)
            for si in range(n_splits)
        ]
        # the pool keeps the size asked for on one device. In a world of
        # ranks every fit and group reduces over the ranks, and two
        # threads' collectives would interleave in another order on each
        # rank: the cells and the groups then run one at a time, in one
        # order (the JAX package caps its pool at one worker for the same
        # reason on XLA:CPU)
        serial = mesh_lib.collective_mesh() is not None
        n_workers = 1 if serial else _normalize_n_jobs(self.n_jobs)

        # Batched-candidate fast path: bucket homogeneous candidates and let
        # the terminal estimator fit+score each bucket as one group (see
        # _plan_batched_groups). Unplanned candidates take the per-cell
        # path; both share the same prefix-fit memo tokens.
        batch_plan = _plan_batched_groups(
            estimator, candidate_params, scorers, fit_params,
            n_train_min=min((len(tr) for tr, _te in splits), default=None))

        # Checkpoint/resume: completed cells live in an append-only journal
        # keyed by content — estimator config + candidate params + the
        # split's ACTUAL index arrays + the CONTENT of X/y/fit_params +
        # scoring identity — so a re-fit with the same checkpoint path restores
        # finished cells and computes only the rest, while any change to
        # grid, data values, sample weights, or scoring changes the keys and
        # naturally misses. Cells that FAILED under a numeric error_score
        # are never journaled: an interrupted run's transient failures (OOM,
        # preemption) retry on resume instead of being restored as scores.
        # (SURVEY §5.4; the reference can only re-run from zero.)
        journal = done_cells = None
        cell_keys = {}
        legacy_keys = {}
        if self.checkpoint:
            from dask_ml_tpu_torch.checkpoint import CellJournal

            journal = CellJournal(self.checkpoint)
            done_cells = journal.load()
            est_token = tokenize(
                type(estimator), estimator.get_params(deep=True),
                _content_array(X), _content_array(y),
                {k: _content_array(v) for k, v in fit_params.items()},
            )
            scoring_id = _scoring_identity(self.scoring)
            # Journals written before scoring identity keyed cells on scorer
            # NAMES (sorted(scorers)). Probe the legacy key on a miss ONLY
            # for list-of-strings specs, where the names that reached the
            # legacy key ARE the metrics. Everything else is ambiguous in
            # legacy keys: None/single-string collapsed to ['score'], and a
            # dict's keys are arbitrary slot names whose mapped metric could
            # have changed — a legacy record can't prove WHICH metric
            # produced it. Callable scoring's legacy records are exactly the
            # stale ones the identity change invalidates. No journal loaded
            # → nothing to bridge, skip the second hashing pass entirely.
            named_scoring = (
                isinstance(self.scoring, (list, tuple, set))
                and all(isinstance(s, str) for s in self.scoring)
            )
            for ci, si in cells:
                cell_keys[(ci, si)] = tokenize(
                    "cell", est_token, candidate_params[ci],
                    splits[si][0], splits[si][1], scoring_id,
                    self.return_train_score,
                )
                if named_scoring and done_cells:
                    legacy_keys[(ci, si)] = tokenize(
                        "cell", est_token, candidate_params[ci],
                        splits[si][0], splits[si][1], sorted(scorers),
                        self.return_train_score,
                    )
        self.n_resumed_cells_ = sum(
            1 for cs, k in cell_keys.items()
            if k in (done_cells or {})
            or (cs in legacy_keys and legacy_keys[cs] in (done_cells or {}))
        )

        # Thread-local config (device, dtype, ...) set on the CALLING thread
        # must reach the pool's worker threads, or
        # `config_context(device="cpu"): search.fit(...)` would run its
        # cells on the default device under n_jobs > 1.
        caller_cfg = config_lib.thread_config()
        if device_native:
            # all-native candidate pipelines: stage outputs flow
            # device→device between pipeline steps for the whole search
            # (over a slow host link, per-stage fetch+restage dominates) —
            # scoped to the cells, so refit and the returned estimator keep
            # the numpy sklearn contract
            caller_cfg["device_outputs"] = True

        def _compute_cell(ci, si):
            if ci in batch_plan:
                group, mi = batch_plan[ci]
                return runner.run_batched(candidate_params[ci], si, group, mi)
            return runner.run(candidate_params[ci], si)

        # Soft per-cell timeout: the cell runs on a dedicated daemon thread
        # and the worker waits at most cell_timeout seconds. A cell that
        # overruns scores error_score (never journaled, so a resume retries
        # it) and the sweep proceeds — threads cannot be killed, so the
        # stray fit finishes in the background, but it no longer blocks the
        # run or poisons its results. "Soft" is the honest contract here.
        timeout_counts = [0]
        timeout_lock = threading.Lock()

        def _timed_out_result(ci, si):
            if self.error_score == "raise":
                raise TimeoutError(
                    f"search cell (candidate {ci}, split {si}) exceeded "
                    f"cell_timeout={self.cell_timeout}s")
            methods.warn_fit_failure(
                self.error_score,
                TimeoutError(f"cell exceeded cell_timeout="
                             f"{self.cell_timeout}s"))
            test, train, score_time = methods.score(
                FIT_FAILURE, None, None,
                FIT_FAILURE if self.return_train_score else None,
                None, scorers, self.error_score)
            return test, train, float(self.cell_timeout), score_time, True

        def _compute_cell_deadline(ci, si):
            with telemetry.span("search.cell", candidate=int(ci),
                                split=int(si)):
                return _compute_cell_deadline_inner(ci, si)

        def _compute_cell_deadline_inner(ci, si):
            value, timed_out = run_with_soft_deadline(
                lambda: _compute_cell(ci, si), self.cell_timeout,
                caller_cfg=caller_cfg, name=f"search-cell-{ci}-{si}")
            if timed_out:
                with timeout_lock:
                    timeout_counts[0] += 1
                # registry mirror of the timeout count surfaced as
                # n_cell_timeouts_ (same increment site)
                telemetry.counter("search.cell_timeouts").inc()
                return _timed_out_result(ci, si)
            return value

        def run_cell(ci, si):
            with config_lib.config_context(**caller_cfg):
                if journal is not None:
                    key = cell_keys[(ci, si)]
                    hit = done_cells.get(key)
                    if hit is None and (ci, si) in legacy_keys:
                        hit = done_cells.get(legacy_keys[(ci, si)])
                        if hit is not None:  # migrate to the current key
                            journal.append(key, hit)
                    if hit is not None:
                        return hit
                    result = _compute_cell_deadline(ci, si)
                    if not result[-1]:  # journal only non-failed cells
                        journal.append(key, result)
                    return result
                return _compute_cell_deadline(ci, si)

        # Device-staging memo: native candidates re-stage their CV slice
        # inside fit; within this scope identical (slice, role) pairs upload
        # once for the whole search (the analogue of the reference's
        # data-key sharing, model_selection/utils.py:53-68).
        from dask_ml_tpu_torch.parallel.sharding import staging_memo

        with staging_memo() as dmemo:
            # Pre-pass for batched groups: dispatch every group's fit+score
            # (its outputs stay on the card under device_outputs) and copy
            # ALL groups' scores to the host at once — a read per group
            # would wait on the card each time.
            if batch_plan:
                group_cis: dict = {}
                for ci, (group, _mi) in batch_plan.items():
                    group_cis.setdefault(id(group), (group, []))[1].append(ci)
                def _cell_journaled(cj, si):
                    if cell_keys[(cj, si)] in done_cells:
                        return True
                    lk = legacy_keys.get((cj, si))
                    return lk is not None and lk in done_cells

                jobs = [
                    (group, cis,
                     [si for si in range(n_splits)
                      if journal is None or not all(
                          _cell_journaled(cj, si) for cj in cis)])
                    for group, cis in group_cis.values()
                ]
                jobs = [j for j in jobs if j[2]]

                def _dispatch_group(job, only_first=False):
                    group, cis, sis = job
                    out = []
                    # config is thread-local: re-enter it per worker
                    with config_lib.config_context(**caller_cfg):
                        for si in (sis[:1] if only_first else sis):
                            res, _tp = runner.batched_group_out(
                                candidate_params[cis[0]], si, group)
                            out.append(
                                res[0] if isinstance(res, tuple) else None)
                    return out

                # One serial job first (the first split of the first
                # group: the upload of X and the prefix fits the groups
                # share), then the other (group, splits) jobs fan out on a
                # pool; a group's splits run inside one job. The
                # memo/CVCache are lock-protected (the n_jobs>1 cell pool
                # drives them concurrently too); the peek scope is entered
                # once here, on this thread, before the workers start.
                with memo.peek_scope():
                    head = (_dispatch_group(jobs[0], only_first=True)
                            if jobs else [])
                    rests = ([(jobs[0][0], jobs[0][1], jobs[0][2][1:])]
                             if jobs else [])
                    rests += jobs[1:]
                    rests = [j for j in rests if j[2]]
                    if len(rests) <= 1 or serial:
                        tails = [_dispatch_group(j) for j in rests]
                    else:
                        with ThreadPoolExecutor(
                            max_workers=min(8, len(rests))
                        ) as pre_pool:
                            tails = list(
                                pre_pool.map(_dispatch_group, rests))
                pending = [p for chunk in [head] + tails for p in chunk
                           if p is not None]
                if pending:
                    _bulk_fetch(pending)

            if n_workers == 1:
                results = [run_cell(ci, si) for ci, si in cells]
            else:
                with ThreadPoolExecutor(max_workers=n_workers) as pool:
                    futs = [
                        pool.submit(run_cell, ci, si) for ci, si in cells
                    ]
                    results = [f.result() for f in futs]
        self.n_device_stagings_ = dmemo.n_stagings
        self.n_staging_hits_ = dmemo.hits
        results = [r[:4] for r in results]  # drop the cell failure flag

        test_weights = None
        if self.iid:
            test_weights = np.array(
                [cv_cache.n_test(si) for _, si in cells], dtype=np.float64
            )

        self.cv_results_ = methods.create_cv_results(
            results, candidate_params, n_splits, self.error_score,
            test_weights, multimetric, self.return_train_score,
        )
        self.n_splits_ = n_splits
        self.multimetric_ = multimetric
        self.scorer_ = scorers if multimetric else scorers["score"]
        self.n_shared_fits_ = memo.n_entries  # CSE observability
        # the fold slices' sample counts (exact: the port pads nothing)
        self.shape_buckets_ = cv_cache.planned_buckets()
        # cells that ACTUALLY read a batched group's result this fit —
        # runtime declines (NotImplemented) and journal-resumed cells are
        # excluded, so the attribute is evidence of which path ran
        self.n_batched_cells_ = runner.n_batched_done
        self._shared_fit_graph = memo.report()
        # fault-tolerance observability: transient retries spent on cell
        # fits and cells cut off by the soft timeout, surfaced both as
        # attributes and in shared_fit_report()
        self.n_cell_retries_ = (retry_policy.retries
                                if retry_policy is not None else 0)
        self.n_cell_timeouts_ = timeout_counts[0]
        self.retry_stats_ = (retry_policy.stats()
                             if retry_policy is not None else None)

        # best_* availability follows sklearn: single-metric scoring gets
        # best_index_/best_score_/best_params_ even with refit=False;
        # multimetric needs refit=<metric name> to define "best"
        if self.refit or not multimetric:
            rank_key = (
                f"rank_test_{refit_metric}" if multimetric else "rank_test_score"
            )
            self.best_index_ = int(np.argmin(self.cv_results_[rank_key]))
            mean_key = (
                f"mean_test_{refit_metric}" if multimetric else "mean_test_score"
            )
            self.best_score_ = float(
                self.cv_results_[mean_key][self.best_index_]
            )
            self.best_params_ = candidate_params[self.best_index_]
        if self.refit:
            # refit always raises on failure (reference: _search.py:965-969)
            best = methods.copy_estimator(estimator)
            best.set_params(**self.best_params_)
            best.fit(X, y, **fit_params)
            self.best_estimator_ = best
        return self

    def _check_refit(self, multimetric, scorers):
        if not multimetric:
            return None
        if self.refit is False:
            return None
        if not isinstance(self.refit, str) or self.refit not in scorers:
            raise ValueError(
                "For multimetric scoring, refit must be the name of the "
                f"scorer used to find the best parameters; got {self.refit!r}"
            )
        return self.refit

    # -- search introspection (reference: _search.py:870-894) ------------

    def shared_fit_report(self) -> str:
        """Human-readable view of the work-sharing (CSE) DAG: every
        memoized node with how many cells consumed it, ordered by sharing.

        The reference's ``visualize()`` renders the merged dask graph to
        show that pipeline-prefix fits are shared (reference:
        _search.py:870-894, docs/source/hyper-parameter-search.rst:78-135);
        this is the same evidence as text — each node ran its computation
        ONCE however many consumers it lists.
        """
        if not hasattr(self, "_shared_fit_graph"):
            raise AttributeError("Not fitted; call fit first")
        nodes = self._shared_fit_graph
        header = (f"{len(nodes)} distinct computations served "
                  f"{sum(m['consumers'] for m in nodes.values())} consumers")
        retries = getattr(self, "n_cell_retries_", 0)
        timeouts = getattr(self, "n_cell_timeouts_", 0)
        if retries or timeouts:
            header += (f"; {retries} transient fit retr"
                       f"{'y' if retries == 1 else 'ies'}, "
                       f"{timeouts} timed-out cell"
                       f"{'' if timeouts == 1 else 's'}")
        lines = [
            header,
            "",
            f"{'consumers':>9}  {'node':<40} key",
        ]
        order = sorted(nodes.items(),
                       key=lambda kv: -kv[1]["consumers"])
        for key, m in order:
            label = m["label"] or "(input)"
            lines.append(f"{m['consumers']:>9}  {label:<40} {key[:12]}")
        # the telemetry counters (cell timeouts, journal records): shown
        # when the knob is on OR when counters were recorded — a fit run
        # under config_context(telemetry=True) keeps its section even when
        # the report is read outside that scope
        if telemetry.enabled() or telemetry.counters():
            lines += ["", telemetry.render_counters()]
        return "\n".join(lines)

    def visualize(self, filename: Optional[str] = "mydask",
                  format: Optional[str] = None, **kwargs):
        """Render the shared-fit DAG with graphviz (parity with the
        reference's ``DaskBaseSearchCV.visualize``, _search.py:870-894 —
        same ``(filename, format=None, **kwargs)`` surface, defaulting to
        png). Requires the optional ``graphviz`` package; use
        :meth:`shared_fit_report` for the dependency-free text view."""
        if not hasattr(self, "_shared_fit_graph"):
            raise AttributeError("Not fitted; call fit first")
        try:
            import graphviz
        except ImportError as e:  # pragma: no cover - optional dep
            raise ImportError(
                "visualize() needs the optional 'graphviz' package; "
                "shared_fit_report() provides the same information as text"
            ) from e
        g = graphviz.Digraph("shared_fits")
        nodes = self._shared_fit_graph
        for key, m in nodes.items():
            label = m["label"] or "input"
            g.node(key[:12], f"{label}\\n×{m['consumers']}")
        for key, m in nodes.items():
            for p in m["parents"]:
                if p in nodes:
                    g.edge(p[:12], key[:12])
        if filename:
            g.render(filename, format=format or "png", cleanup=True,
                     **kwargs)
        return g

    # -- post-fit delegation (reference: _search.py:728-762) -------------
    def _check_is_fitted(self, method_name):
        if not self.refit:
            raise AttributeError(
                f"This {type(self).__name__} instance was initialized with "
                f"refit=False; {method_name} is only available after refitting"
            )
        if not hasattr(self, "best_estimator_"):
            raise AttributeError("Not fitted; call fit first")

    @property
    def classes_(self):
        self._check_is_fitted("classes_")
        return self.best_estimator_.classes_

    def predict(self, X):
        self._check_is_fitted("predict")
        return self.best_estimator_.predict(X)

    def predict_proba(self, X):
        self._check_is_fitted("predict_proba")
        return self.best_estimator_.predict_proba(X)

    def predict_log_proba(self, X):
        self._check_is_fitted("predict_log_proba")
        return self.best_estimator_.predict_log_proba(X)

    def decision_function(self, X):
        self._check_is_fitted("decision_function")
        return self.best_estimator_.decision_function(X)

    def transform(self, X):
        self._check_is_fitted("transform")
        return self.best_estimator_.transform(X)

    def inverse_transform(self, X):
        self._check_is_fitted("inverse_transform")
        return self.best_estimator_.inverse_transform(X)

    def score(self, X, y=None):
        self._check_is_fitted("score")
        if self.multimetric_:
            # score with the refit metric, as sklearn's BaseSearchCV does
            if isinstance(self.refit, str):
                return self.scorer_[self.refit](self.best_estimator_, X, y)
            return self.best_estimator_.score(X, y)
        return self.scorer_(self.best_estimator_, X, y)


#: the JAX package's name of the shared driver
TPUBaseSearchCV = BaseSearchCV


_DOC_NOTE = """
    Execution model: a host-side thread pool drives candidate x split fits;
    pipeline-prefix fits are content-addressed and computed once across
    candidates (work-sharing), the analogue of the reference's graph CSE
    (reference: _search.py:281-345,462-503). `n_shared_fits_` exposes how many
    distinct fit tasks actually ran.
"""


class GridSearchCV(BaseSearchCV):
    __doc__ = (
        "Exhaustive search over a parameter grid "
        "(reference: _search.py:1141-1170).\n" + _DOC_NOTE
    )

    def __init__(self, estimator, param_grid, scoring=None, iid=True,
                 refit=True, cv=None, error_score="raise",
                 return_train_score=True, scheduler=None, n_jobs=-1,
                 cache_cv=True, checkpoint=None, cell_retries=0,
                 cell_timeout=None):
        super().__init__(
            estimator, scoring=scoring, iid=iid, refit=refit, cv=cv,
            error_score=error_score, return_train_score=return_train_score,
            scheduler=scheduler, n_jobs=n_jobs, cache_cv=cache_cv,
            checkpoint=checkpoint, cell_retries=cell_retries,
            cell_timeout=cell_timeout,
        )
        self.param_grid = param_grid

    def _get_param_iterator(self):
        return ParameterGrid(self.param_grid)


class RandomizedSearchCV(BaseSearchCV):
    __doc__ = (
        "Sampled search over parameter distributions "
        "(reference: _search.py:1232-1265).\n" + _DOC_NOTE
    )

    def __init__(self, estimator, param_distributions, n_iter=10, scoring=None,
                 iid=True, refit=True, cv=None, random_state=None,
                 error_score="raise", return_train_score=True, scheduler=None,
                 n_jobs=-1, cache_cv=True, checkpoint=None, cell_retries=0,
                 cell_timeout=None):
        super().__init__(
            estimator, scoring=scoring, iid=iid, refit=refit, cv=cv,
            error_score=error_score, return_train_score=return_train_score,
            scheduler=scheduler, n_jobs=n_jobs, cache_cv=cache_cv,
            checkpoint=checkpoint, cell_retries=cell_retries,
            cell_timeout=cell_timeout,
        )
        self.param_distributions = param_distributions
        self.n_iter = n_iter
        self.random_state = random_state

    def _get_param_iterator(self):
        return ParameterSampler(
            self.param_distributions, self.n_iter,
            random_state=self.random_state,
        )

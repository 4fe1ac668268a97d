"""Meta-estimators of the PyTorch port (counterpart of
``dask_ml_tpu/wrappers.py``): :class:`ParallelPostFit` (blockwise
inference) and :class:`Incremental` (a chain of ``partial_fit`` over row
blocks), with the functional :func:`fit` and :func:`incremental_scan`.

Two paths, as in the JAX package:

- **native estimators** (this package's): ``predict`` / ``transform`` get
  the whole array, since the estimator stages it onto the card itself;
  an estimator with ``_incremental_begin`` trains through
  :func:`incremental_scan`, the chain of blocks as a loop of device work
  that reads nothing back to the host between blocks;
- **foreign (scikit-learn-style) estimators** run on the host:
  ``ParallelPostFit`` fans row blocks over a thread pool and concatenates
  the results, ``Incremental`` feeds the blocks to ``partial_fit`` one
  after the other.

Both copy the learned ``*_`` attributes onto themselves and take nested
``estimator__<param>`` names. ``ParallelPostFit(serving=loop)`` makes
the wrapper a client of a
:class:`~dask_ml_tpu_torch.parallel.serving.ServingLoop` (or a
:class:`~dask_ml_tpu_torch.parallel.fleet.ServingFleet`). Nothing here
imports scikit-learn.
"""

from __future__ import annotations

import logging
from concurrent.futures import ThreadPoolExecutor
from timeit import default_timer as tic

import numpy as np
import torch

from dask_ml_tpu_torch.base import BaseEstimator, clone
from dask_ml_tpu_torch.config import (config_context, get_config,
                                      resolve_device)
from dask_ml_tpu_torch.metrics.scorer import check_scoring, get_scorer
from dask_ml_tpu_torch.parallel.precision import staging_wire_dtype
from dask_ml_tpu_torch.parallel.sharding import is_sparse_input
from dask_ml_tpu_torch.utils._utils import copy_learned_attributes

logger = logging.getLogger(__name__)

#: rows per block of the host-side loops over foreign estimators and of
#: the incremental chain
DEFAULT_BLOCK_SIZE = 100_000

def _is_native(estimator) -> bool:
    """Whether the estimator is this package's (it stages its own input);
    the JAX package's names, which share the prefix ``dask_ml_tpu``, are
    foreign here."""
    mod = type(estimator).__module__ or ""
    return mod == "dask_ml_tpu_torch" or mod.startswith("dask_ml_tpu_torch.")


def _block_slices(n: int, block_size: int):
    for start in range(0, n, block_size):
        yield slice(start, min(start + block_size, n))


def _as_rowsliceable(X):
    """A row-sliceable view of X, sparse kept sparse."""
    from dask_ml_tpu_torch.ops.sparse import SparseRows

    if isinstance(X, (SparseRows, torch.Tensor)):
        return X
    if hasattr(X, "tocsr"):
        return X.tocsr()
    return np.asarray(X)


def _concat_rows(parts):
    if parts and hasattr(parts[0], "tocsr"):
        import scipy.sparse

        return scipy.sparse.vstack(parts)
    return np.concatenate(parts, axis=0)


#: fit kwargs that are per row (sliced per block), and metadata (never)
_ROW_ALIGNED_KWARGS = {"sample_weight"}
_NEVER_SLICED_KWARGS = {"classes"}


def _slice_kwargs(kwargs, s, n):
    """Per-row fit kwargs cut to a block: ``sample_weight`` in any sequence
    form, never ``classes``, any other only as a row-aligned ndarray."""
    out = {}
    for k, v in kwargs.items():
        if k in _NEVER_SLICED_KWARGS:
            out[k] = v
        elif k in _ROW_ALIGNED_KWARGS and v is not None:
            out[k] = np.asarray(v)[s]
        elif isinstance(v, np.ndarray) and v.ndim >= 1 and len(v) == n:
            out[k] = v[s]
        else:
            out[k] = v
    return out


class ParallelPostFit(BaseEstimator):
    """Fit an estimator as it is, then predict and transform blockwise.

    ``scoring`` (a name or a scorer) replaces the estimator's ``score``;
    ``block_size`` is the rows of a host block for a foreign estimator (a
    native one gets the whole array).

    ``serving`` takes a started
    :class:`~dask_ml_tpu_torch.parallel.serving.ServingLoop` or
    :class:`~dask_ml_tpu_torch.parallel.fleet.ServingFleet`: ``predict`` /
    ``predict_proba`` / ``transform`` then go through it. The estimator is
    registered in its registry on first use (once, by identity; under
    ``serving_model`` when given), a request above the loop's
    per-request cap (or ``block_size``) is sent in chunks whose results
    are gathered in order, and each logical request is one
    ``serving.request`` span. Sparse input and methods the loop does not
    serve take the direct path. :meth:`fit` drops the registration, so a
    refitted model's old state is never served."""

    def __init__(self, estimator=None, scoring=None,
                 block_size: int = DEFAULT_BLOCK_SIZE,
                 serving=None, serving_model=None):
        self.estimator = estimator
        self.scoring = scoring
        self.block_size = block_size
        self.serving = serving
        self.serving_model = serving_model

    @property
    def _postfit_estimator(self):
        return self.estimator

    def fit(self, X, y=None, **kwargs):
        start = tic()
        if self.serving is not None:
            # the runners staged the previous fitted state: drop them
            # before it changes, so a racing request never serves a
            # half-updated model
            self.serving.registry.invalidate(self.estimator)
        try:
            result = self.estimator.fit(X, y, **kwargs)
        finally:
            if self.serving is not None:
                # a predict racing this fit may have registered the
                # estimator again mid-fit; drop that too, so the next
                # request stages the final state
                self.serving.registry.invalidate(self.estimator)
        logger.info("Finished fit, %0.2f", tic() - start)
        copy_learned_attributes(result, self)
        return self

    def _check_method(self, method):
        estimator = self._postfit_estimator
        if not hasattr(estimator, method):
            raise AttributeError(
                f"The wrapped estimator '{estimator}' does not have a "
                f"'{method}' method.")
        return getattr(estimator, method)

    def _serving_name(self):
        est = self._postfit_estimator
        return self.serving.registry.ensure(est, name=self.serving_model)

    def _serving_call(self, method, X):
        """One logical request through the serving loop: chunks of at most
        the loop's per-request cap, all submitted (they coalesce with
        concurrent traffic), gathered in order, inside one
        ``serving.request`` span."""
        from dask_ml_tpu_torch.parallel import telemetry

        loop = self.serving
        name = self._serving_name()
        X = np.asarray(X)
        n = X.shape[0]
        with telemetry.span("serving.request", model=name, method=method,
                            rows=n):
            cap = min(int(self.block_size), loop.max_request_rows)
            if n <= cap:
                return loop.submit(name, X, method=method).result()
            futs = [loop.submit(name, X[s], method=method)
                    for s in _block_slices(n, cap)]
            return np.concatenate([f.result() for f in futs], axis=0)

    def _dispatch(self, method, X):
        if self.serving is not None and not is_sparse_input(X):
            self._check_method(method)  # the AttributeError contract first
            entry = None
            if not getattr(self, "_serving_unsupported", False):
                try:
                    name = self._serving_name()
                    entry = self.serving.registry.get(name)
                except ValueError as e:
                    if self.serving_model is not None:
                        # the user named this registration: a collision or
                        # an unservable family is a configuration error
                        raise
                    self._serving_unsupported = True
                    logger.warning(
                        "serving registration failed for %s; falling back "
                        "to the direct path: %s",
                        type(self._postfit_estimator).__name__, e)
            if entry is not None and method in entry.runners:
                return self._serving_call(method, X)
        return self._blockwise(self._check_method(method), X)

    def _blockwise(self, fn, X):
        """``fn`` over row blocks of ``X``: the whole array for a native
        estimator, else one block per host thread under the caller's
        configuration, concatenated."""
        if _is_native(self._postfit_estimator):
            return fn(X)
        X = _as_rowsliceable(X)
        n = X.shape[0]
        if n <= self.block_size:
            return fn(X)
        slices = list(_block_slices(n, self.block_size))
        cfg = get_config()  # the caller's scope, in every worker thread

        def block(s):
            with config_context(**cfg):
                return fn(X[s])

        with ThreadPoolExecutor(max_workers=min(8, len(slices))) as pool:
            parts = list(pool.map(block, slices))
        return _concat_rows(parts)

    def predict(self, X):
        return self._dispatch("predict", X)

    def predict_proba(self, X):
        return self._dispatch("predict_proba", X)

    def predict_log_proba(self, X):
        return self._blockwise(self._check_method("predict_log_proba"), X)

    def transform(self, X):
        return self._dispatch("transform", X)

    def score(self, X, y):
        """The configured scorer, else the estimator's own ``score``."""
        if self.scoring:
            return get_scorer(self.scoring)(self, X, y)
        return self._postfit_estimator.score(X, y)


class Incremental(ParallelPostFit):
    """Feed row blocks of ``block_size`` to a ``partial_fit`` estimator one
    after the other. The fitted clone lives in ``estimator_`` and its
    learned attributes are copied onto the wrapper; inference is
    :class:`ParallelPostFit`'s.

    A native estimator with ``_incremental_begin`` (the GLMs) trains
    through :func:`incremental_scan` on dense input; sparse input raises
    there (stream it through :func:`fit` or ``partial_fit``, which take
    CSR blocks). Any other estimator gets ``partial_fit`` block by
    block."""

    @property
    def _postfit_estimator(self):
        if not hasattr(self, "estimator_"):
            raise AttributeError(
                f"This {type(self).__name__} instance is not fitted yet; "
                f"call 'fit' first")
        return self.estimator_

    def _fit_for_estimator(self, estimator, X, y, **fit_kwargs):
        check_scoring(estimator, self.scoring)
        start = tic()
        if _is_native(estimator) and hasattr(estimator,
                                             "_incremental_begin"):
            if is_sparse_input(X):
                raise ValueError(
                    "Incremental's device chain takes dense X; stream "
                    "sparse rows through wrappers.fit(estimator, X, y) or "
                    "estimator.partial_fit, which take CSR blocks")
            sample_weight = fit_kwargs.pop("sample_weight", None)
            if not hasattr(X, "shape"):
                X = np.asarray(X)
            step, state, y_enc = estimator._incremental_begin(
                X, y, **fit_kwargs)
            state = incremental_scan(step, state, X, y_enc,
                                     sample_weight=sample_weight,
                                     block_size=self.block_size)
            estimator._incremental_finalize(state)
            logger.info("Finished device incremental fit, %0.2f",
                        tic() - start)
        else:
            X = _as_rowsliceable(X)
            y = None if y is None else np.asarray(y)
            n = X.shape[0]
            for s in _block_slices(n, self.block_size):
                estimator.partial_fit(X[s], None if y is None else y[s],
                                      **_slice_kwargs(fit_kwargs, s, n))
            logger.info("Finished incremental fit, %0.2f", tic() - start)
        copy_learned_attributes(estimator, self)
        self.estimator_ = estimator
        return self

    def fit(self, X, y=None, **fit_kwargs):
        return self._fit_for_estimator(clone(self.estimator), X, y,
                                       **fit_kwargs)

    def partial_fit(self, X, y=None, **fit_kwargs):
        """Continue from ``estimator_`` where there is one."""
        estimator = getattr(self, "estimator_", None)
        if estimator is None:
            estimator = clone(self.estimator)
        return self._fit_for_estimator(estimator, X, y, **fit_kwargs)


def fit(model, X, y=None, compute: bool = True,
        block_size: int = DEFAULT_BLOCK_SIZE, **kwargs):
    """The chain of ``partial_fit`` calls over row blocks of ``X`` (dense,
    CSR or a container), in order; returns ``model``, fitted in place.
    ``compute`` keeps the reference's positional slot and does nothing:
    the chain runs eagerly, and the card's work queues behind the host
    loop anyway."""
    del compute
    if not hasattr(model, "partial_fit"):
        raise TypeError(f"{model!r} does not implement partial_fit")
    X = _as_rowsliceable(X)
    y = None if y is None else np.asarray(y)
    if X.ndim != 2:
        raise ValueError("X must be 2-D")
    n = X.shape[0]
    for s in _block_slices(n, block_size):
        model.partial_fit(X[s], None if y is None else y[s],
                          **_slice_kwargs(kwargs, s, n))
    return model


def _staged(a, dev, dtype=torch.float32):
    t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
    return t.to(device=dev, dtype=dtype)


def incremental_scan(step_fn, init_state, X, y=None, sample_weight=None,
                     block_size: int = 1024):
    """Run ``step_fn(state, (x_block, y_block, w_block)) -> state`` over
    row blocks of ``block_size``, in order, on the device of ``init_state``
    (else the configured one).

    ``X``, ``y`` and the weights are staged once; the blocks are views of
    them, and the last block, where it is short, is padded with zero rows
    of weight 0, which leave the step's weighted sums unchanged, so a
    remainder is trained on, not dropped (its sums run over more rows than
    a ``partial_fit`` of the short block, so their last bits may differ
    on the card). ``w_block`` is ``sample_weight``
    (default 1). ``y``'s trailing dims are kept. The loop only queues
    device work: it reads nothing back to the host between blocks."""
    leaf = (init_state[0] if isinstance(init_state, (tuple, list))
            else init_state)
    dev = (leaf.device if isinstance(leaf, torch.Tensor)
           else resolve_device())
    X = _staged(X, dev, staging_wire_dtype() or torch.float32)
    n = int(X.shape[0])
    if n == 0:
        raise ValueError("X has no rows")
    block_size = min(int(block_size), n)
    if sample_weight is None:
        w = torch.ones(n, dtype=torch.float32, device=dev)
    else:
        w = _staged(sample_weight, dev)
        if tuple(w.shape) != (n,):
            raise ValueError(
                f"sample_weight shape {tuple(w.shape)} != ({n},)")
    y = (torch.zeros(n, dtype=X.dtype, device=dev) if y is None
         else _staged(y, dev))

    def padded(a, rows):
        tail = a.new_zeros((rows - a.shape[0], *a.shape[1:]))
        return torch.cat([a, tail])

    state = init_state
    with torch.no_grad():
        for s in _block_slices(n, block_size):
            blk = (X[s], y[s], w[s])
            if s.stop - s.start < block_size:
                blk = tuple(padded(a, block_size) for a in blk)
            state = step_fn(state, blk)
    return state

"""KMeans estimator of the PyTorch port and the module functions
``k_means``, ``compute_inertia``, ``evaluate_cost``, ``k_init``,
``init_scalable``, ``init_random`` and ``init_pp`` (counterpart of
``dask_ml_tpu/cluster/k_means.py``).

The sklearn-style shell keeps the JAX estimator's constructor signature
and learned attributes; the compute path is the functional core in
:mod:`dask_ml_tpu_torch.models.kmeans`, which runs on the configured
device (``config.device``, default ``"cuda"``) through the hand-written
kernels: ``algorithm="full"`` (alias ``"lloyd"``), ``"bounded"`` (alias
``"elkan"``), ``"auto"`` and ``"sketched"``.
"""

from __future__ import annotations

import logging
from timeit import default_timer as tic

import numpy as np
import torch

from dask_ml_tpu_torch.base import BaseEstimator, TransformerMixin
from dask_ml_tpu_torch.config import maybe_host, resolve_device
from dask_ml_tpu_torch.models import kmeans as core
from dask_ml_tpu_torch.ops import fast_transform as ftm
from dask_ml_tpu_torch.ops.pairwise import euclidean_distances
from dask_ml_tpu_torch.parallel import telemetry
from dask_ml_tpu_torch.parallel.precision import lloyd_bounds_dtype
from dask_ml_tpu_torch.parallel.sharding import prepare_data, unpad_rows
from dask_ml_tpu_torch.utils.validation import check_array, check_random_state

logger = logging.getLogger(__name__)

_ALGORITHMS = ("full", "lloyd", "bounded", "elkan", "auto", "sketched")

#: the sketched fit's restricted Lloyd rounds run through the bounded loop
#: (True, as in the JAX package) or the single-pass loop (False); both
#: give the same trajectory
_SKETCHED_BOUNDED = True


class KMeans(TransformerMixin, BaseEstimator):
    """Scalable KMeans with k-means|| initialization.

    Parameters mirror the JAX estimator:

    n_clusters : int, default 8
    init : {'k-means||', 'k-means++', 'random'} or ndarray
    oversampling_factor : float, default 2
        ℓ = oversampling_factor · n_clusters candidates per init round.
    max_iter : int, default 300
    tol : float, default 1e-4 — scaled by mean feature variance.
    random_state : int, numpy RandomState, torch.Generator or None
    algorithm : {'full', 'lloyd', 'bounded', 'elkan', 'auto', 'sketched'},
        default 'full'
        'full' (alias 'lloyd') is the single-pass Lloyd loop; 'bounded'
        (alias 'elkan') carries Elkan/Yinyang center-movement bounds and
        skips the distance pass group-wise for rows whose bounds prove the
        label unchanged, with the same centers, labels and ``n_iter_``,
        and exposes ``lloyd_pruning_``; 'auto' takes 'bounded' when
        n ≥ 2^16 and k ≥ 4. 'sketched' is the approximate QuicK-means fit:
        centers are held to a learned fast-transform sketch on
        ``sketch_cols`` transform columns, and Lloyd runs in that
        p-column space (attributes ``fast_transform_``, ``sketch_*``).
    init_max_iter : int or None — cap on k-means|| rounds.
    sketch_cols : int or None, default None ('sketched' only)
        Columns p of the shared sketch support; None takes
        ``max(4, n_features // 4)``.
    sketch_iters : int, default 8 ('sketched' only)
        palm4MSA sweeps fitting the transform.
    device : str, torch.device or None
        Where fit/predict run; None takes ``config.device`` ("cuda").
    precompute_distances / copy_x / n_jobs are accepted for signature
        parity and ignored.

    Attributes
    ----------
    cluster_centers_ : (n_clusters, n_features) float32 ndarray
    labels_ : (n_samples,) int32 ndarray
    inertia_ : float
    n_iter_ : int
    n_features_in_ : int
    fit_phase_seconds_ : {"init": s, "lloyd": s}
    lloyd_pruning_ : dict, bounded fits only — rows_skipped,
        rows_considered, distances_avoided, pruned_fraction_per_iter,
        bound_held_fraction_per_iter (over positive-weight rows)
    """

    def __init__(
        self,
        n_clusters: int = 8,
        init="k-means||",
        oversampling_factor: float = 2.0,
        max_iter: int = 300,
        tol: float = 1e-4,
        precompute_distances: str = "auto",
        random_state=None,
        copy_x: bool = True,
        n_jobs: int = 1,
        algorithm: str = "full",
        init_max_iter=None,
        sketch_cols=None,
        sketch_iters: int = 8,
        device=None,
    ):
        self.n_clusters = n_clusters
        self.init = init
        self.oversampling_factor = oversampling_factor
        self.max_iter = max_iter
        self.tol = tol
        self.precompute_distances = precompute_distances
        self.random_state = random_state
        self.copy_x = copy_x
        self.n_jobs = n_jobs
        self.algorithm = algorithm
        self.init_max_iter = init_max_iter
        self.sketch_cols = sketch_cols
        self.sketch_iters = sketch_iters
        self.device = device

    def _check_params(self, n_samples=None):
        if self.n_clusters < 1:
            raise ValueError("n_clusters must be >= 1")
        if self.max_iter < 1:
            raise ValueError("max_iter must be >= 1")
        if n_samples is not None and self.n_clusters > n_samples:
            raise ValueError(
                f"n_clusters={self.n_clusters} must be <= "
                f"n_samples={n_samples}")
        if self.algorithm not in _ALGORITHMS:
            raise ValueError(
                "algorithm must be 'full'/'lloyd', 'bounded'/'elkan', "
                f"'auto', or 'sketched'; got {self.algorithm!r}")
        if self.sketch_cols is not None and int(self.sketch_cols) < 1:
            raise ValueError("sketch_cols must be >= 1")
        if int(self.sketch_iters) < 0:
            raise ValueError("sketch_iters must be >= 0")

    def _use_bounded(self, n: int, d: int) -> bool:
        if self.algorithm in ("bounded", "elkan"):
            return True
        if self.algorithm == "auto":
            return core._bounded_auto_wins(n, self.n_clusters, d)
        return False

    def fit(self, X, y=None, sample_weight=None):
        t0 = tic()
        X = check_array(X)
        self._check_params(n_samples=int(X.shape[0]))
        dev = resolve_device(self.device)
        with telemetry.span("kmeans.fit", n=int(X.shape[0]),
                            d=int(X.shape[1]), k=int(self.n_clusters)):
            data = prepare_data(X, sample_weight=sample_weight, device=dev)
            gen = check_random_state(self.random_state, device=dev)
            with telemetry.span("kmeans.init"):
                centers = core.k_init(
                    data.X, data.weights, data.n, self.n_clusters, gen,
                    init=self.init,
                    oversampling_factor=self.oversampling_factor,
                    max_iter=self.init_max_iter)
                _sync(dev)
            t_init = tic()
            # a refit must not keep the attributes of another algorithm:
            # predict goes through the sketch when fast_transform_ exists
            for name in ("fast_transform_", "lloyd_pruning_",
                         "sketch_pruning_"):
                self.__dict__.pop(name, None)
            if self.algorithm == "sketched":
                self._fit_sketched(data, centers, gen)
            else:
                self._fit_lloyd(data, centers)
        logger.info("Lloyd finished in %.2fs: %d iterations, inertia %.4g",
                    tic() - t_init, self.n_iter_, self.inertia_)
        self.fit_phase_seconds_ = {"init": t_init - t0,
                                   "lloyd": tic() - t_init}
        return self

    def _fit_lloyd(self, data, centers):
        tol = core.scaled_tolerance(data.X, data.weights, self.tol)
        bounded = self._use_bounded(data.n, data.n_features)
        with telemetry.span("kmeans-lloyd",
                            algorithm="bounded" if bounded else "lloyd"):
            if bounded:
                centers, _, n_iter, _, _, stats = core.lloyd_loop_bounded(
                    data.X, data.weights, centers, tol,
                    max_iter=self.max_iter,
                    bounds_dtype=lloyd_bounds_dtype(data.X.dtype))
            else:
                centers, _, n_iter, _ = core.lloyd_loop_fused(
                    data.X, data.weights, centers, tol,
                    max_iter=self.max_iter)
        # inertia against the FINAL centers, so inertia_ agrees with
        # cluster_centers_, labels_ and score(X)
        with telemetry.span("kmeans.finalize"):
            inertia = core.compute_inertia(data.X, data.weights, centers)
            labels = core.predict_labels(data.X, centers)
            self.cluster_centers_ = centers.cpu().numpy()
            self.labels_ = unpad_rows(labels, data.n).cpu().numpy()
            self.inertia_ = float(inertia)
        self.n_iter_ = int(n_iter)
        self.n_features_in_ = data.n_features
        if bounded:
            self.lloyd_pruning_ = _pruning_summary(
                [(stats, n_iter)], data.weights, self.n_clusters)

    def _fit_sketched(self, data, centers, gen):
        """The QuicK-means fit: palm4MSA-fit a fast transform and shared
        support to the (centered) init centers, stage the data once into
        the p support columns, and run Lloyd there — exact for the
        sketch-constrained problem, since for an orthogonal transform
        with a fixed support the restricted M-step is the full-space one
        followed by re-projection. A second round refits the transform on
        the converged centers and runs again. ``labels_`` come from the
        sketched assignment that ``predict`` runs; ``cluster_centers_``
        and ``inertia_`` are the exact weighted means of that partition
        and its exact cost."""
        d = data.n_features
        p = (int(self.sketch_cols) if self.sketch_cols is not None
             else max(4, d // 4))
        w = data.weights
        with telemetry.span("kmeans.sketch-fit", p=p,
                            iters=int(self.sketch_iters)):
            # center first: a shared mean component would spend support
            # budget on a direction that cancels in every comparison
            mu = ((w @ data.X.to(torch.float32))
                  / torch.clamp(w.sum(), min=1e-12))
            ft, support, vals0, fit_loss = ftm.palm4msa_fit(
                centers - mu[None, :], p, n_iter=int(self.sketch_iters),
                generator=gen)
            Zp = _sketch_stage(ft, data.X, mu, support)

        def restricted_lloyd(Zp_, vals0_):
            tol = core.scaled_tolerance(Zp_, w, self.tol)
            if _SKETCHED_BOUNDED:
                vals_, _, n_it, _, _, stats = core.lloyd_loop_bounded(
                    Zp_, w, vals0_, tol, max_iter=self.max_iter,
                    bounds_dtype=lloyd_bounds_dtype(Zp_.dtype))
                return vals_, n_it, stats
            vals_, _, n_it, _ = core.lloyd_loop_fused(
                Zp_, w, vals0_, tol, max_iter=self.max_iter)
            return vals_, n_it, None

        with telemetry.span("kmeans-lloyd", algorithm="sketched"):
            vals, n_iter1, stats1 = restricted_lloyd(Zp, vals0)
            with telemetry.span("kmeans.sketch-refit", p=p):
                ft, support, vals0, fit_loss = ftm.palm4msa_fit(
                    ftm.reconstruct(ft, vals, support), p,
                    n_iter=int(self.sketch_iters), generator=gen)
                Zp = _sketch_stage(ft, data.X, mu, support)
            vals, n_iter2, stats2 = restricted_lloyd(Zp, vals0)
        with telemetry.span("kmeans.finalize"):
            centers_sk = ftm.reconstruct(ft, vals, support) + mu[None, :]
            Wp = ftm.support_matrix(ft, support)
            off = mu @ Wp
            labels = core.predict_labels_sketched(data.X, Wp, off, vals,
                                                  centers_sk)
            centers_dense = _polish_centers(data.X, w, labels, centers_sk)
            inertia = _assigned_inertia(data.X, w, labels, centers_dense)
        self.cluster_centers_ = centers_dense.cpu().numpy()
        self.fast_transform_ = ftm.FastTransform(
            ft.angles.cpu().numpy(), ft.d, ft.d_pad, ft.perms.cpu().numpy())
        self.sketch_mean_ = mu.cpu().numpy()
        self.sketch_centers_ = centers_sk.cpu().numpy()
        self.sketch_support_ = support.cpu().numpy()
        self.sketch_vals_ = vals.cpu().numpy()
        self.sketch_staging_ = Wp.cpu().numpy()
        self.sketch_offset_ = off.cpu().numpy()
        self.sketch_loss_ = float(fit_loss)
        if stats1 is not None:
            self.sketch_pruning_ = _pruning_summary(
                [(stats1, n_iter1), (stats2, n_iter2)], w, self.n_clusters)
        self.labels_ = unpad_rows(labels, data.n).cpu().numpy()
        self.inertia_ = float(inertia)
        self.n_iter_ = int(n_iter1) + int(n_iter2)
        self.n_features_in_ = data.n_features

    def _sketch_args(self, dev):
        """(Wp, off, vals, centers) of a sketched fit on ``dev``: the
        arguments of ``models.kmeans.predict_labels_sketched``. The dense
        centers are ``sketch_centers_`` (the reconstruction), not the
        polished ``cluster_centers_``, so both of its branches assign to
        the model the sketch encodes."""
        return tuple(torch.as_tensor(a, dtype=torch.float32, device=dev)
                     for a in (self.sketch_staging_, self.sketch_offset_,
                               self.sketch_vals_, self.sketch_centers_))

    def _check_fitted(self):
        if not hasattr(self, "cluster_centers_"):
            raise AttributeError("Model not fitted; call fit first")

    def _staged(self, X):
        self._check_fitted()
        X = check_array(X)
        if X.shape[1] != self.cluster_centers_.shape[1]:
            raise ValueError(
                f"X has {X.shape[1]} features; the model was fitted with "
                f"{self.cluster_centers_.shape[1]}")
        dev = resolve_device(self.device)
        data = prepare_data(X, device=dev)
        centers = torch.as_tensor(self.cluster_centers_, dtype=torch.float32,
                                  device=dev)
        return data, centers

    def predict(self, X):
        """Nearest-center labels (int32); a sketched model assigns through
        its sketch, as its fit did."""
        data, centers = self._staged(X)
        if getattr(self, "fast_transform_", None) is not None:
            labels = core.predict_labels_sketched(
                data.X, *self._sketch_args(data.X.device))
        else:
            labels = core.predict_labels(data.X, centers)
        return maybe_host(unpad_rows(labels, data.n))

    def transform(self, X):
        """Distances to each center."""
        data, centers = self._staged(X)
        return maybe_host(unpad_rows(euclidean_distances(data.X, centers),
                                     data.n))

    def score(self, X, y=None):
        """Negative inertia on X (higher is better), matching sklearn."""
        data, centers = self._staged(X)
        return -float(core.compute_inertia(data.X, data.weights, centers))

    # -- batched-candidate protocol (the search driver's fast path) -------
    #
    # The search driver buckets homogeneous candidates (same estimator
    # class, same static params, same upstream data) and fits and scores
    # each bucket as one group. KMeans batches over (n_clusters, tol): tol
    # variants share one Lloyd trajectory, each k runs its own (see
    # models/kmeans.py batched_lloyd_cells).

    _batchable_params = frozenset({"n_clusters", "tol"})

    #: the trajectory history a group may keep on the card, and the
    #: longest trajectory it runs (a group runs every step of max_iter,
    #: where a per-cell fit stops at convergence)
    _BATCH_HISTORY_BYTES = 512 * 1024 * 1024
    _BATCH_MAX_ITER = 4096

    def _supports_batched(self, static_params) -> bool:
        """Batchable only with ``init='random'``: the k-means|| and
        k-means++ inits are host-driven loops that would serialize the
        group, and per-candidate inits would defeat trajectory
        sharing."""
        return static_params.get("init", self.init) == "random"

    def _batchable_member_ok(self, member_params, n_train_min) -> bool:
        """A member whose n_clusters can't fit the smallest train split
        runs per-cell, so that ITS failure follows error_score semantics
        instead of failing the whole group."""
        k = int(member_params.get("n_clusters", self.n_clusters))
        return k >= 1 and (n_train_min is None or k <= n_train_min)

    def _batched_fit_score(self, X, y, members, eval_sets):
        """Fit every member (a dict of batchable-param overrides) and
        score it (negative inertia) against each eval set — ``eval_sets``
        is a list of ``(X_eval, y_eval)`` pairs (y unused). Returns
        ``{"n_iter": (M,), "scores": [per eval set (M,)]}`` as device
        tensors: nothing is read back from the card (trusted device
        inputs skip ``check_array``'s scan); the search driver copies
        every group's scores to the host at once.

        Returns ``NotImplemented`` — and the driver runs the group per
        cell, where each fit stops at convergence — when the history the
        group keeps on the card (Σ over unique k of max_iter × k × d f32
        centers; the port keeps each k at its own width) exceeds 512 MB,
        or when ``max_iter`` exceeds 4096 steps."""
        ks = {int(m.get("n_clusters", self.n_clusters)) for m in members}
        T = int(self.max_iter)
        hist_bytes = sum(T * k * int(X.shape[1]) * 4 for k in ks)
        if hist_bytes > self._BATCH_HISTORY_BYTES or \
                T > self._BATCH_MAX_ITER:
            return NotImplemented
        dev = resolve_device(self.device)
        data = prepare_data(check_array(X), device=dev)
        evals = [prepare_data(check_array(E), device=dev)
                 for E, _y in eval_sets]
        pairs = [(int(m.get("n_clusters", self.n_clusters)),
                  float(m.get("tol", self.tol))) for m in members]
        for k, _ in pairs:
            if k < 1 or k > data.n:
                raise ValueError(
                    f"n_clusters={k} must be in [1, n_samples={data.n}]")
        gen = check_random_state(self.random_state, device=dev)
        n_iters, _train_inertia, eval_inertias = core.batched_lloyd_cells(
            data, pairs, evals, max_iter=T, generator=gen)
        return {"n_iter": n_iters,
                "scores": [-inert for inert in eval_inertias]}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _pruning_summary(runs, w, k: int) -> dict:
    """``lloyd_pruning_`` from the (stats, n_iter) of one or more bounded
    loops. The loops count positive-weight rows only, so the fractions
    are over those."""
    skip = np.concatenate([st["rows_skipped"][:int(ni)].cpu().numpy()
                           for st, ni in runs])
    held = np.concatenate([st["bounds_held"][:int(ni)].cpu().numpy()
                           for st, ni in runs])
    n_real = int((w > 0).sum())
    denom = max(n_real, 1)
    return {
        "rows_skipped": int(skip.sum()),
        "rows_considered": len(skip) * n_real,
        "distances_avoided": int(skip.sum()) * int(k),
        "pruned_fraction_per_iter": [float(s) / denom for s in skip],
        "bound_held_fraction_per_iter": [float(h) / denom for h in held],
    }


def _sketch_stage(ft, X, mu, support):
    """``Z_p = (X − μ) @ Wᵀ[:, support]`` (n, p): the array the sketched
    Lloyd rounds run on, one f32 matmul through the materialized slice,
    kept in X's dtype (bf16 staged data gives a bf16 ``Z_p``, as in the
    JAX package)."""
    Wp = ftm.support_matrix(ft, support).to(X.device)
    return ((X - mu[None, :]) @ Wp).to(X.dtype)


def _polish_centers(X, w, labels, fallback_centers):
    """Exact weighted means of a fixed partition (one-hot matmul); empty
    clusters keep their fallback center."""
    k = fallback_centers.shape[0]
    oh = (torch.nn.functional.one_hot(labels.long(), k).to(torch.float32)
          * w[:, None])
    cnt = oh.sum(dim=0)
    means = ((oh.T @ X.to(torch.float32))
             / torch.clamp(cnt, min=1e-12)[:, None])
    return torch.where((cnt > 0)[:, None], means, fallback_centers)


def _assigned_inertia(X, w, labels, centers):
    """Weighted squared distance of each row to its ASSIGNED center."""
    return (w * ((X - centers[labels.long()]) ** 2).sum(dim=1)).sum()


# ---------------------------------------------------------------------------
# module functions (thin facades over models/kmeans.py)
# ---------------------------------------------------------------------------


def k_means(X, n_clusters, init="k-means||", precompute_distances="auto",
            n_init=1, max_iter=300, verbose=False, tol=1e-4,
            random_state=None, copy_x=True, n_jobs=-1, algorithm="full",
            return_n_iter=False, oversampling_factor=2, init_max_iter=None):
    """Functional k-means: a :class:`KMeans` fit. ``n_init`` is 1 in
    effect (k-means|| makes restarts unnecessary); the other scikit-learn
    settings are accepted for signature parity. Returns
    ``(centroids, labels, inertia[, n_iter])``."""
    est = KMeans(
        n_clusters=n_clusters, init=init,
        oversampling_factor=oversampling_factor, max_iter=max_iter, tol=tol,
        precompute_distances=precompute_distances, random_state=random_state,
        copy_x=copy_x, n_jobs=n_jobs, algorithm=algorithm,
        init_max_iter=init_max_iter,
    ).fit(X)
    if return_n_iter:
        return est.cluster_centers_, est.labels_, est.inertia_, est.n_iter_
    return est.cluster_centers_, est.labels_, est.inertia_


def _staged_for_init(X, random_state=None):
    data = prepare_data(check_array(X))
    return data, check_random_state(random_state, device=data.X.device)


def compute_inertia(X, labels, centers):
    """Sum of squared distances of the rows to their ASSIGNED centers.
    Deliberate deviation, as in the JAX package: the reference's code sums
    raw differences (no square, so it can go negative); this is the
    squared quantity, which scikit-learn and ``inertia_`` report."""
    data, _ = _staged_for_init(X)
    dev = data.X.device
    labels = torch.as_tensor(np.asarray(labels), device=dev)
    centers = torch.as_tensor(np.asarray(centers, np.float32), device=dev)
    return float(_assigned_inertia(data.X, data.weights, labels, centers))


def evaluate_cost(X, centers):
    """Σ of each row's squared distance to its nearest center (the
    k-means|| sampling cost), through the fused argmin (K2 on the
    card)."""
    data, _ = _staged_for_init(X)
    centers = torch.as_tensor(np.asarray(centers, np.float32),
                              device=data.X.device)
    return float(core.compute_inertia(data.X, data.weights, centers))


def k_init(X, n_clusters, init="k-means||", random_state=None, max_iter=None,
           oversampling_factor=2):
    """Initial centers by ``init`` (``models.kmeans.k_init``), as a host
    ``(n_clusters, n_features)`` array."""
    data, gen = _staged_for_init(X, random_state)
    return core.k_init(
        data.X, data.weights, data.n, int(n_clusters), gen, init=init,
        oversampling_factor=oversampling_factor,
        max_iter=max_iter).cpu().numpy()


def init_scalable(X, n_clusters, random_state=None, max_iter=None,
                  oversampling_factor=2):
    """k-means|| init: the rounds on K3, the candidate weighting on K4,
    then k-means++ and a small Lloyd loop over the weighted candidates,
    whose assignment is K2 and whose update a plain one-hot product (on
    the card; K1 does not run here)."""
    data, gen = _staged_for_init(X, random_state)
    return core.init_scalable(
        data.X, data.weights, data.n, int(n_clusters), gen,
        oversampling_factor=oversampling_factor,
        max_iter=max_iter).cpu().numpy()


def init_random(X, n_clusters, random_state=None):
    """``n_clusters`` distinct random rows."""
    data, gen = _staged_for_init(X, random_state)
    return core.init_random(data.X, data.weights, data.n, int(n_clusters),
                            gen).cpu().numpy()


def init_pp(X, n_clusters, random_state=None):
    """k-means++ on the host with scikit-learn's ``kmeans_plusplus`` (for
    modest n, as in the reference); raises ``ImportError`` where
    scikit-learn is not installed."""
    data, gen = _staged_for_init(X, random_state)
    return core.init_pp(data.X, data.n, int(n_clusters), gen).cpu().numpy()

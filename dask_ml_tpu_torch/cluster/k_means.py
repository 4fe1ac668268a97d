"""KMeans estimator of the PyTorch port (counterpart of
``dask_ml_tpu/cluster/k_means.py``).

The sklearn-style shell keeps the JAX estimator's constructor signature
and learned attributes; the compute path is the functional core in
:mod:`dask_ml_tpu_torch.models.kmeans`, which runs on the configured
device (``config.device``, default ``"cuda"``) through the hand-written
kernels. This slice ports ``algorithm="full"`` (alias ``"lloyd"``).
"""

from __future__ import annotations

import logging
from timeit import default_timer as tic

import torch

from dask_ml_tpu_torch.base import BaseEstimator, TransformerMixin
from dask_ml_tpu_torch.config import maybe_host, resolve_device
from dask_ml_tpu_torch.models import kmeans as core
from dask_ml_tpu_torch.ops.pairwise import euclidean_distances
from dask_ml_tpu_torch.parallel import telemetry
from dask_ml_tpu_torch.parallel.sharding import prepare_data, unpad_rows
from dask_ml_tpu_torch.utils.validation import check_array, check_random_state

logger = logging.getLogger(__name__)

_LATER = {
    "bounded": "bounded Lloyd (the argmin_min2 kernel) is the next slice",
    "elkan": "it aliases 'bounded', bounded Lloyd (the argmin_min2 kernel), "
             "the next slice",
    "auto": "it selects bounded Lloyd, the next slice",
    "sketched": "sketched k-means (the argmin_min kernel's x2d option) "
                "comes with the remaining estimators",
}


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
    algorithm : {'full', 'lloyd'}, default 'full'
        'bounded', 'elkan', 'auto' and 'sketched' raise
        ``NotImplementedError``: they are later slices of the port.
    init_max_iter : int or None — cap on k-means|| rounds.
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
        if self.algorithm in _LATER:
            raise NotImplementedError(
                f"algorithm={self.algorithm!r} is not ported to PyTorch yet: "
                f"{_LATER[self.algorithm]}. Use algorithm='full'.")
        if self.algorithm not in ("full", "lloyd"):
            raise ValueError(
                f"algorithm must be 'full' or 'lloyd'; got {self.algorithm!r}")

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
            tol = core.scaled_tolerance(data.X, data.weights, self.tol)
            with telemetry.span("kmeans-lloyd"):
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
        logger.info("Lloyd finished in %.2fs: %d iterations, inertia %.4g",
                    tic() - t_init, self.n_iter_, self.inertia_)
        self.fit_phase_seconds_ = {"init": t_init - t0,
                                   "lloyd": tic() - t_init}
        return self

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
        """Nearest-center labels (int32)."""
        data, centers = self._staged(X)
        return maybe_host(unpad_rows(core.predict_labels(data.X, centers),
                                     data.n))

    def transform(self, X):
        """Distances to each center."""
        data, centers = self._staged(X)
        return maybe_host(unpad_rows(euclidean_distances(data.X, centers),
                                     data.n))

    def score(self, X, y=None):
        """Negative inertia on X (higher is better), matching sklearn."""
        data, centers = self._staged(X)
        return -float(core.compute_inertia(data.X, data.weights, centers))

    def _batched_fit_score(self, X, y, members, eval_sets):
        raise NotImplementedError(
            "the batched-candidate search protocol is not ported to PyTorch "
            "yet; it comes with model selection, a later slice")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)

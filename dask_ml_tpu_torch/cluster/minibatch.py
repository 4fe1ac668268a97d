"""Mini-batch KMeans of the PyTorch port (counterpart of
``dask_ml_tpu/cluster/minibatch.py``), and the deprecated
``PartialMiniBatchKMeans``.

:class:`MiniBatchKMeans` is Sculley's web-scale k-means (2010): each step
draws a batch, assigns it to the nearest centers and moves each center
toward its batch mean with a per-center rate ``1/v_j`` (``v_j``: the
weight the center has absorbed). The assignment is
:func:`~dask_ml_tpu_torch.ops.fused_distance.fused_argmin_min`, the K2
kernel on the card; the per-center sums and counts are a one-hot product
(``torch.matmul``, as the JAX package forms them outside its kernel), so
a rerun repeats its bits. ``fit`` draws every step's row indices with
one ``torch.randint`` on the device up front and then runs its steps
with no host read between them.

``PartialMiniBatchKMeans`` subclasses scikit-learn's estimator and loads
on first access (module ``__getattr__``), so this module imports where
scikit-learn is not installed.
"""

from __future__ import annotations

import numpy as np
import torch

from dask_ml_tpu_torch.base import BaseEstimator, TransformerMixin
from dask_ml_tpu_torch.config import maybe_host, resolve_device
from dask_ml_tpu_torch.models import kmeans as core
from dask_ml_tpu_torch.ops.fused_distance import fused_argmin_min
from dask_ml_tpu_torch.parallel.sharding import prepare_data, unpad_rows
from dask_ml_tpu_torch.utils.validation import check_array, check_random_state

__all__ = ["MiniBatchKMeans", "PartialMiniBatchKMeans"]


def _minibatch_update(batch, wb, centers, v, kernel: str = "auto"):
    """One Sculley update from a batch: the fused argmin (K2 on the
    card), per-center weighted sums and counts by the one-hot product,
    then ``c_j <- (1 - eta_j) c_j + eta_j mean_j`` with
    ``eta_j = n_j / v_j``; a center that caught nothing stays put.
    Returns (centers, v, labels)."""
    k = centers.shape[0]
    labels, _ = fused_argmin_min(batch, centers, kernel=kernel)
    onehot = (torch.nn.functional.one_hot(labels.long(), k)
              .to(torch.float32) * wb[:, None])
    sums = onehot.T @ batch.to(torch.float32)  # (k, d), f32 for bf16 X
    counts = onehot.sum(dim=0)  # (k,)
    v_new = v + counts
    caught = counts > 0
    eta = torch.where(caught, counts / torch.clamp(v_new, min=1.0),
                      torch.zeros_like(counts))
    mean = sums / torch.clamp(counts, min=1e-30)[:, None]
    centers = torch.where(caught[:, None],
                          (1.0 - eta)[:, None] * centers
                          + eta[:, None] * mean, centers)
    return centers, v_new, labels


def _minibatch_steps(X, w, centers, v, idx):
    """Every step of a fit: step t updates from the rows ``idx[t]`` (the
    JAX package's ``lax.scan``, here a loop with no host read)."""
    for t in range(idx.shape[0]):
        rows = idx[t]
        centers, v, _ = _minibatch_update(X[rows], w[rows], centers, v)
    return centers, v


class MiniBatchKMeans(TransformerMixin, BaseEstimator):
    """Mini-batch KMeans (Sculley 2010) over the fused assignment kernel.

    Parameters
    ----------
    n_clusters : int, default 8
    init : {'k-means||', 'k-means++', 'random'} or ndarray, default
        'k-means||' — the dispatch of :class:`KMeans`
        (``models.kmeans.k_init``). The Sculley update never moves a
        center that catches no batch point, so a good init matters more
        here than for full Lloyd.
    batch_size : int, default 1024
    max_iter : int, default 10
        Epochs: each runs ``ceil(n / batch_size)`` batches drawn
        uniformly with replacement (an epoch is a work budget, not a
        partition).
    compute_labels : bool, default True
        One full assignment pass after fitting for ``labels_`` and
        ``inertia_``.
    random_state : int, numpy RandomState, torch.Generator or None
    oversampling_factor, init_max_iter : the k-means|| settings.
    device : str, torch.device or None — where fit and predict run; None
        takes ``config.device`` ("cuda").

    Attributes: ``cluster_centers_``, ``labels_``, ``inertia_``,
    ``n_iter_`` (mini-batch steps in all), ``counts_`` (the weight each
    center absorbed: the streaming state ``partial_fit`` continues from),
    all on the host.
    """

    def __init__(self, n_clusters: int = 8, init="k-means||",
                 batch_size: int = 1024, max_iter: int = 10,
                 compute_labels: bool = True, random_state=None,
                 oversampling_factor: float = 2.0, init_max_iter=None,
                 device=None):
        self.n_clusters = n_clusters
        self.init = init
        self.batch_size = batch_size
        self.max_iter = max_iter
        self.compute_labels = compute_labels
        self.random_state = random_state
        self.oversampling_factor = oversampling_factor
        self.init_max_iter = init_max_iter
        self.device = device

    def _init_centers(self, data, gen):
        return core.k_init(
            data.X, data.weights, data.n, self.n_clusters, gen,
            init=self.init, oversampling_factor=self.oversampling_factor,
            max_iter=self.init_max_iter)

    def fit(self, X, y=None, sample_weight=None):
        if self.n_clusters < 1:
            raise ValueError("n_clusters must be >= 1")
        if self.batch_size < 1:
            raise ValueError("batch_size must be >= 1")
        X = check_array(X)
        dev = resolve_device(self.device)
        data = prepare_data(X, sample_weight=sample_weight, device=dev)
        if self.n_clusters > data.n:
            raise ValueError(
                f"n_clusters={self.n_clusters} must be <= "
                f"n_samples={data.n}")
        gen = check_random_state(self.random_state, device=dev)
        centers = self._init_centers(data, gen)
        bs = int(min(self.batch_size, data.n))
        n_steps = int(max(self.max_iter, 1)) * -(-data.n // bs)
        idx = torch.randint(0, data.n, (n_steps, bs), generator=gen,
                            device=dev)
        centers, v = _minibatch_steps(
            data.X, data.weights, centers,
            torch.zeros(self.n_clusters, dtype=torch.float32, device=dev),
            idx)
        self.cluster_centers_ = centers.cpu().numpy()
        self.counts_ = v.cpu().numpy()
        self.n_iter_ = n_steps
        self.n_features_in_ = data.n_features
        if self.compute_labels:
            labels = core.predict_labels(data.X, centers)
            self.labels_ = unpad_rows(labels, data.n).cpu().numpy()
            self.inertia_ = float(
                core.compute_inertia(data.X, data.weights, centers))
        return self

    def partial_fit(self, X, y=None, sample_weight=None):
        """One mini-batch update from the given rows (the whole input is
        the batch). The first call initializes the centers from it."""
        X = check_array(X)
        dev = resolve_device(self.device)
        data = prepare_data(X, sample_weight=sample_weight, device=dev)
        if not hasattr(self, "cluster_centers_"):
            if self.n_clusters > data.n:
                raise ValueError(
                    f"n_clusters={self.n_clusters} must be <= "
                    f"n_samples={data.n} in the first partial_fit batch")
            gen = check_random_state(self.random_state, device=dev)
            self.cluster_centers_ = self._init_centers(data, gen).cpu(
            ).numpy()
            self.counts_ = np.zeros((self.n_clusters,), np.float32)
            self.n_iter_ = 0
            self.n_features_in_ = data.n_features
        centers, v, _ = _minibatch_update(
            data.X, data.weights,
            torch.as_tensor(self.cluster_centers_, device=dev),
            torch.as_tensor(self.counts_, device=dev))
        self.cluster_centers_ = centers.cpu().numpy()
        self.counts_ = v.cpu().numpy()
        self.n_iter_ += 1
        return self

    def _staged(self, X):
        if not hasattr(self, "cluster_centers_"):
            raise AttributeError("Model not fitted; call fit first")
        X = check_array(X)
        dev = resolve_device(self.device)
        data = prepare_data(X, device=dev)
        return data, torch.as_tensor(self.cluster_centers_, device=dev)

    def predict(self, X):
        data, centers = self._staged(X)
        return maybe_host(unpad_rows(core.predict_labels(data.X, centers),
                                     data.n))

    def transform(self, X):
        from dask_ml_tpu_torch.ops.pairwise import euclidean_distances

        data, centers = self._staged(X)
        return maybe_host(unpad_rows(euclidean_distances(data.X, centers),
                                     data.n))

    def score(self, X, y=None):
        data, centers = self._staged(X)
        return -float(core.compute_inertia(data.X, data.weights, centers))


def __getattr__(name):
    if name == "PartialMiniBatchKMeans":
        from dask_ml_tpu_torch._partial import lazy_partial

        return lazy_partial(__name__, name, "sklearn.cluster.MiniBatchKMeans")
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Clustering estimators of the PyTorch port: ``KMeans``,
``MiniBatchKMeans``, the k-means module functions, and the Nyström
estimators ``SpectralClustering`` (with ``embed``) and ``KernelKMeans``.
The deprecated ``PartialMiniBatchKMeans`` subclasses scikit-learn's
estimator and loads on first access, so the package imports without
scikit-learn."""

from dask_ml_tpu_torch.cluster.k_means import (
    KMeans,
    compute_inertia,
    evaluate_cost,
    init_pp,
    init_random,
    init_scalable,
    k_init,
    k_means,
)
from dask_ml_tpu_torch.cluster.kernel_kmeans import KernelKMeans
from dask_ml_tpu_torch.cluster.minibatch import MiniBatchKMeans
from dask_ml_tpu_torch.cluster.spectral import SpectralClustering, embed

__all__ = ["KMeans", "KernelKMeans", "MiniBatchKMeans",
           "SpectralClustering", "PartialMiniBatchKMeans",
           "compute_inertia", "embed", "evaluate_cost", "init_pp",
           "init_random", "init_scalable", "k_init", "k_means"]


def __getattr__(name):
    if name == "PartialMiniBatchKMeans":
        from dask_ml_tpu_torch.cluster import minibatch

        return minibatch.PartialMiniBatchKMeans
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

"""Clustering estimators of the PyTorch port."""

from dask_ml_tpu_torch.cluster.k_means import KMeans

__all__ = ["KMeans"]

"""Carry a fitted model of the JAX package across to the port.

The input is the ``{name: ndarray}`` dict of learned attributes that
``dask_ml_tpu.interop.export_learned_attrs`` returns. This module takes
numpy only and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from dask_ml_tpu_torch.cluster.k_means import KMeans
from dask_ml_tpu_torch.config import resolve_device


def kmeans_from_numpy(attrs: dict, device=None) -> KMeans:
    """A fitted port :class:`KMeans` whose ``predict``, ``score`` and
    ``transform`` compute what the exported model's do. ``device`` (None:
    the configured one) is where they will run."""
    if "sketch_vals_" in attrs or "fast_transform_" in attrs:
        raise NotImplementedError(
            "sketched KMeans models predict through their sketch, which is "
            "not ported to PyTorch yet")
    centers = np.array(attrs["cluster_centers_"], dtype=np.float32)
    if centers.ndim != 2 or centers.shape[0] < 1:
        raise ValueError(
            f"cluster_centers_ must be (n_clusters, n_features); got shape "
            f"{centers.shape}")
    if not np.isfinite(centers).all():
        raise ValueError("cluster_centers_ contains NaN or infinity")
    if device is not None:
        resolve_device(device)
    est = KMeans(n_clusters=int(centers.shape[0]), init=centers,
                 device=device)
    est.cluster_centers_ = centers
    est.n_features_in_ = int(attrs.get("n_features_in_", centers.shape[1]))
    if est.n_features_in_ != centers.shape[1]:
        raise ValueError(
            f"n_features_in_={est.n_features_in_} disagrees with "
            f"cluster_centers_ of width {centers.shape[1]}")
    if "labels_" in attrs:
        est.labels_ = np.asarray(attrs["labels_"]).astype(np.int32)
    if "inertia_" in attrs:
        est.inertia_ = float(attrs["inertia_"])
    if "n_iter_" in attrs:
        est.n_iter_ = int(attrs["n_iter_"])
    return est

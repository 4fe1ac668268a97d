"""Carry a fitted model of the JAX package across to the port.

The input is the ``{name: ndarray}`` dict of learned attributes that
``dask_ml_tpu.interop.export_learned_attrs`` returns. This module takes
numpy only and imports nothing of the JAX package.
"""

from __future__ import annotations

import numpy as np

from dask_ml_tpu_torch.cluster.k_means import KMeans
from dask_ml_tpu_torch.config import resolve_device
from dask_ml_tpu_torch.ops.fast_transform import FastTransform

#: the arrays a sketched model predicts through
_SKETCH_ATTRS = ("sketch_staging_", "sketch_offset_", "sketch_vals_",
                 "sketch_centers_")


def kmeans_from_numpy(attrs: dict, device=None) -> KMeans:
    """A fitted port :class:`KMeans` whose ``predict``, ``score`` and
    ``transform`` compute what the exported model's do. ``device`` (None:
    the configured one) is where they will run.

    A sketched model (one with ``fast_transform_``) predicts through its
    sketch, as in the JAX package: its staging slice, offset, sketch
    values and reconstructed centers are carried over. Its transform
    keeps the angles but no permutation table (the JAX package derives
    those from ``jax.random``), which ``predict`` does not need."""
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
    if "fast_transform_" in attrs:
        _carry_sketch(est, attrs)
    return est


def _carry_sketch(est: KMeans, attrs: dict) -> None:
    missing = [a for a in _SKETCH_ATTRS if a not in attrs]
    if missing:
        raise ValueError(f"a sketched model needs {missing}")
    for name in _SKETCH_ATTRS + ("sketch_support_", "sketch_mean_"):
        if name in attrs:
            setattr(est, name, np.array(attrs[name], dtype=np.float32
                                        if name != "sketch_support_"
                                        else np.int64))
    k, d = est.cluster_centers_.shape
    p = est.sketch_vals_.shape[1]
    if (est.sketch_staging_.shape != (d, p)
            or est.sketch_offset_.shape != (p,)
            or est.sketch_vals_.shape != (k, p)
            or est.sketch_centers_.shape != (k, d)):
        raise ValueError(
            f"sketch arrays disagree with {k} clusters of width {d}: "
            f"staging {est.sketch_staging_.shape}, offset "
            f"{est.sketch_offset_.shape}, vals {est.sketch_vals_.shape}, "
            f"centers {est.sketch_centers_.shape}")
    ft = attrs["fast_transform_"]
    if isinstance(ft, np.ndarray) and ft.dtype == object:
        ft = ft.item()  # the export wraps the object in a 0-d array
    est.fast_transform_ = FastTransform(
        np.asarray(ft.angles, dtype=np.float32), ft.d, ft.d_pad)
    est.sketch_cols = p

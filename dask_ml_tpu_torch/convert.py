"""Carry a fitted model of the JAX package across to the port.

The input is the ``{name: ndarray}`` dict of learned attributes that
``dask_ml_tpu.interop.export_learned_attrs`` returns. This module takes
numpy only and imports nothing of the JAX package.
:func:`stream_state_from_numpy` carries a streamed solver's state across
the same way.
"""

from __future__ import annotations

import numpy as np
import torch

from dask_ml_tpu_torch.cluster.k_means import KMeans
from dask_ml_tpu_torch.config import resolve_device
from dask_ml_tpu_torch.decomposition import PCA, TruncatedSVD
from dask_ml_tpu_torch.linear_model import (LinearRegression,
                                            LogisticRegression,
                                            PoissonRegression)
from dask_ml_tpu_torch.ops.fast_transform import FastTransform

#: the port's estimator for each GLM family
_GLM_CLASSES = {"logistic": LogisticRegression, "normal": LinearRegression,
                "poisson": PoissonRegression}

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


def glm_from_numpy(attrs: dict, family: str, multiclass: str = "ovr"):
    """A fitted port GLM of ``family`` ("logistic", "normal" or "poisson")
    whose ``decision_function``, ``predict``, ``predict_proba`` and
    ``score`` compute what the exported model's do. The dict holds
    ``coef_`` ((n_features,), or (n_classes, n_features) for a multiclass
    logistic model), ``intercept_`` when the model fitted one, and
    ``classes_`` for a logistic model; ``multiclass`` is the exported
    model's constructor setting, which the dict does not carry."""
    if family not in _GLM_CLASSES:
        raise ValueError(
            f"family must be one of {sorted(_GLM_CLASSES)}, got {family!r}")
    coef = np.array(attrs["coef_"], dtype=np.float32)
    if coef.ndim not in (1, 2) or not np.isfinite(coef).all():
        raise ValueError(
            f"coef_ must be a finite 1-D or 2-D array; got shape "
            f"{coef.shape}")
    intercept = attrs.get("intercept_")
    est = _GLM_CLASSES[family](fit_intercept=intercept is not None,
                               multiclass=multiclass)
    est.coef_ = coef
    est._coef = coef
    est.n_features_in_ = int(coef.shape[-1])
    if intercept is not None:
        intercept = np.array(intercept, dtype=np.float32)
        if intercept.shape != coef.shape[:-1]:
            raise ValueError(
                f"intercept_ of shape {intercept.shape} does not fit coef_ "
                f"of shape {coef.shape}")
        est.intercept_ = intercept if intercept.ndim else intercept[()]
        est._coef = np.concatenate([coef, intercept[..., None]], axis=-1)
    if family == "logistic":
        if "classes_" not in attrs:
            raise ValueError("a logistic model needs classes_")
        est.classes_ = np.asarray(attrs["classes_"])
        k = len(est.classes_)
        if k < 2 or (coef.ndim == 2) != (k > 2) or (
                coef.ndim == 2 and coef.shape[0] != k):
            raise ValueError(
                f"classes_ of {k} labels does not fit coef_ of shape "
                f"{coef.shape}")
    elif coef.ndim != 1:
        raise ValueError(f"a {family} model has a 1-D coef_; got "
                         f"{coef.shape}")
    if "n_iter_" in attrs:
        est.n_iter_ = int(attrs["n_iter_"])
    return est


def _components(attrs: dict) -> np.ndarray:
    comps = np.array(attrs["components_"], dtype=np.float32)
    if comps.ndim != 2 or not np.isfinite(comps).all():
        raise ValueError(
            f"components_ must be a finite (n_components, n_features) "
            f"array; got shape {comps.shape}")
    return comps


def _vector(attrs: dict, name: str, size: int) -> np.ndarray:
    a = np.array(attrs[name], dtype=np.float32)
    if a.shape != (size,):
        raise ValueError(f"{name} of shape {a.shape} does not fit "
                         f"({size},)")
    return a


def pca_from_numpy(attrs: dict, whiten: bool = False) -> PCA:
    """A fitted port :class:`PCA` whose ``transform``,
    ``inverse_transform``, ``score_samples`` and ``score`` compute what the
    exported model's do. ``whiten`` is the exported model's constructor
    setting, which the dict does not carry."""
    comps = _components(attrs)
    k, d = comps.shape
    est = PCA(n_components=k, whiten=whiten)
    est.components_ = comps
    est.mean_ = _vector(attrs, "mean_", d)
    for name in ("explained_variance_", "explained_variance_ratio_",
                 "singular_values_"):
        setattr(est, name, _vector(attrs, name, k))
    est.n_components_ = k
    est.n_features_ = int(attrs.get("n_features_", d))
    if est.n_features_ != d:
        raise ValueError(
            f"n_features_={est.n_features_} disagrees with components_ of "
            f"width {d}")
    est.n_samples_ = int(attrs["n_samples_"])
    est.noise_variance_ = float(attrs["noise_variance_"])
    return est


def truncated_svd_from_numpy(attrs: dict) -> TruncatedSVD:
    """A fitted port :class:`TruncatedSVD` whose ``transform`` and
    ``inverse_transform`` compute what the exported model's do."""
    comps = _components(attrs)
    k = comps.shape[0]
    est = TruncatedSVD(n_components=k)
    est.components_ = comps
    for name in ("explained_variance_", "explained_variance_ratio_",
                 "singular_values_"):
        if name in attrs:
            setattr(est, name, _vector(attrs, name, k))
    return est


def stream_state_from_numpy(state, device=None) -> tuple:
    """A streamed carry of the JAX package as the port's tensors on
    ``device`` (None: the configured one): the ``(z, x, u)`` state of
    ``admm_streamed(..., return_state=True)``, which the port's
    ``admm_streamed(state=...)`` resumes, or a moments carry. Each leaf
    keeps its dtype and is copied (arrays fetched from JAX are
    read-only)."""
    dev = resolve_device(device)
    return tuple(torch.tensor(np.asarray(a), device=dev) for a in state)

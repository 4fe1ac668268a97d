"""Carry a fitted model of the JAX package across to the port.

The input is the ``{name: ndarray}`` dict of learned attributes that
``dask_ml_tpu.interop.export_learned_attrs`` returns. This module takes
numpy only and imports nothing of the JAX package.
:func:`stream_state_from_numpy` carries a streamed solver's state across
the same way. The Nyström estimators keep their landmark and extension
state in private attributes, which that dict leaves out:
:func:`spectral_from_numpy` and :func:`kernel_kmeans_from_numpy` take them
by their attribute names. :func:`preprocessor_from_numpy` sets a scaler's
or an encoder's fitted attributes.
"""

from __future__ import annotations

import numpy as np
import torch

from dask_ml_tpu_torch.cluster import KernelKMeans, SpectralClustering
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
    model's constructor setting, which the dict does not carry.

    A model trained by ``partial_fit`` continues its chain in the port
    where the dict also holds its streaming state: ``_pf_state``, the
    ``(beta, t)`` pair (beta (width,), or (width, K) for softmax), and
    for a logistic model ``_pf_classes``, its pinned class set; add them
    to ``export_learned_attrs``' dict, which leaves private attributes
    out. The chain's settings (``C``, ``penalty``, ``solver_kwargs``' step
    size) are constructor parameters, which the dict does not carry: set
    them on the result (``set_params``) before it continues."""
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
    if "_pf_state" in attrs:
        beta, t = attrs["_pf_state"]
        beta = np.array(beta, dtype=np.float32)
        if beta.shape != est._coef.shape[::-1]:
            raise ValueError(
                f"_pf_state's coefficients of shape {beta.shape} do not "
                f"fit coef_ of shape {coef.shape}")
        est._pf_state = (beta, float(t))
    if "_pf_classes" in attrs:
        est._pf_classes = np.asarray(attrs["_pf_classes"])
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


#: the Nyström state both estimators' predict replays
_NYSTROM_ATTRS = ("_landmarks_", "_extension_", "_n_fit_rows_")


def _carry_nystrom(est, attrs: dict, n_components_of=None) -> None:
    missing = [a for a in _NYSTROM_ATTRS + ("cluster_centers_",)
               if a not in attrs]
    if missing:
        raise ValueError(f"a Nyström model needs {missing}")
    landmarks = np.array(attrs["_landmarks_"], dtype=np.float32)
    ext = tuple(np.array(e, dtype=np.float32)
                for e in attrs["_extension_"])
    if landmarks.ndim != 2 or len(ext) != 3:
        raise ValueError(
            f"_landmarks_ must be (l, d) and _extension_ three arrays; got "
            f"shape {landmarks.shape} and {len(ext)} arrays")
    l = landmarks.shape[0]
    if ext[0].shape != (l,) or ext[1].shape != (l,) \
            or ext[2].ndim != 2 or ext[2].shape[0] != l:
        raise ValueError(
            f"the extension arrays {[e.shape for e in ext]} disagree with "
            f"{l} landmarks")
    est.n_components = l
    est._landmarks_ = landmarks
    est._extension_ = ext
    est._n_fit_rows_ = float(attrs["_n_fit_rows_"])
    est.n_features_in_ = int(landmarks.shape[1])
    if "labels_" in attrs:
        est.labels_ = np.asarray(attrs["labels_"]).astype(np.int32)


def spectral_from_numpy(attrs: dict, **params) -> SpectralClustering:
    """A fitted port :class:`SpectralClustering` whose ``predict`` labels
    rows as the exported model's does. ``attrs`` holds ``_landmarks_``,
    ``_extension_`` (``(ainv_colsum, d1_si, map_k)``), ``_n_fit_rows_``,
    the inner KMeans' ``cluster_centers_`` and optionally ``labels_`` and
    ``eigenvalues_``; ``params`` are the exported model's constructor
    settings of the kernel (``affinity``, ``gamma``, ``degree``,
    ``coef0``, ``kernel_params``), which the arrays do not carry."""
    est = SpectralClustering(**params)
    _carry_nystrom(est, attrs)
    centers = np.array(attrs["cluster_centers_"], dtype=np.float32)
    if centers.ndim != 2 or centers.shape[1] != est._extension_[2].shape[1]:
        raise ValueError(
            f"cluster_centers_ of shape {centers.shape} does not fit an "
            f"embedding of width {est._extension_[2].shape[1]}")
    est.n_clusters = int(centers.shape[0])
    est.assign_labels_ = kmeans_from_numpy(
        {"cluster_centers_": centers})
    if "eigenvalues_" in attrs:
        est.eigenvalues_ = np.array(attrs["eigenvalues_"], np.float32)
    if "labels_" in attrs:
        est.assign_labels_.labels_ = est.labels_
    return est


def kernel_kmeans_from_numpy(attrs: dict, **params) -> KernelKMeans:
    """A fitted port :class:`KernelKMeans` whose ``predict`` labels rows as
    the exported model's does. ``attrs`` holds ``_landmarks_``,
    ``_extension_`` (``(ainv_colsum, d1_si, map_full)``), ``_n_fit_rows_``,
    ``cluster_centers_`` (feature space) and optionally ``labels_``,
    ``inertia_`` and ``n_iter_``; ``params`` the kernel's constructor
    settings."""
    est = KernelKMeans(**params)
    _carry_nystrom(est, attrs)
    km = kmeans_from_numpy({k: attrs[k] for k in
                            ("cluster_centers_", "labels_", "inertia_",
                             "n_iter_") if k in attrs})
    if km.cluster_centers_.shape[1] != est._extension_[2].shape[1]:
        raise ValueError(
            f"cluster_centers_ of shape {km.cluster_centers_.shape} does "
            f"not fit features of width {est._extension_[2].shape[1]}")
    est.n_clusters = km.n_clusters
    est.assign_kmeans_ = km
    est.cluster_centers_ = km.cluster_centers_
    for name in ("inertia_", "n_iter_"):
        if hasattr(km, name):
            setattr(est, name, getattr(km, name))
    return est


def preprocessor_from_numpy(name, attrs: dict, **params):
    """A fitted port scaler or encoder: the class ``name`` of
    :mod:`dask_ml_tpu_torch.preprocessing` (or the class itself) made with
    ``params`` (the exported model's constructor settings) and given each
    attribute of ``attrs`` as it is (numpy arrays, lists of category
    arrays, dicts of dtypes). A ``OneHotEncoder`` rebuilds its lookup
    tables from ``categories_``."""
    from dask_ml_tpu_torch import preprocessing

    cls = getattr(preprocessing, name) if isinstance(name, str) else name
    est = cls(**params)
    for key, value in attrs.items():
        setattr(est, key, value)
    if isinstance(est, preprocessing.OneHotEncoder):
        est.categories_ = [np.asarray(c) for c in est.categories_]
        est.n_features_in_ = len(est.categories_)
        est._index_categories()
    return est

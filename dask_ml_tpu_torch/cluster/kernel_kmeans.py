"""Nyström-approximate kernel k-means of the PyTorch port (counterpart of
``dask_ml_tpu/cluster/kernel_kmeans.py``).

Euclidean Lloyd can only carve convex cells; kernel k-means runs the same
objective on a kernel's inner products. Here l landmark rows give the
strip ``C = K(X, X_l)`` (n, l) and the degree-normalized Nyström
approximant ``K̂ = D^-½ C A⁺ Cᵀ D^-½ = Φ Φᵀ`` through explicit feature
rows ``Φ = D^-½ C D_l^-½ · U S^-½`` (n, l); Euclidean k-means on Φ is
kernel k-means on K̂, so the inner :class:`~dask_ml_tpu_torch.cluster.
KMeans` (K1 in its loop, K3/K4 in its k-means‖ init, K2 for labels) does
the clustering. The feature map is spectral clustering's
(:func:`~dask_ml_tpu_torch.cluster.spectral._nystrom_map`) without row
normalization and with the full l-column whitening, whose small
eigenvalues are thresholded (``1/√S`` only where ``S > S₀·1e-6``) rather
than inverted. ``predict`` replays the map on new rows and assigns them
through K2.

Over a mesh of ranks the fit runs as spectral clustering's does
(:mod:`~dask_ml_tpu_torch.cluster.spectral`): replicated landmarks, each
rank's strip of its own rows, the strip's column sum through ``hpsum``
under the ledger op ``kernel.gram.colsum`` (the same logical bytes on a
flat and on a hierarchical mesh, as the JAX package records them), the
inner KMeans on each rank's block of Φ, and ``predict`` through K2 on each
block, gathered.
"""

from __future__ import annotations

import numpy as np
import torch

from dask_ml_tpu_torch.base import BaseEstimator
from dask_ml_tpu_torch.cluster.k_means import KMeans
from dask_ml_tpu_torch.cluster.spectral import (_check_affinity, _degrees,
                                                _extension, _fit_scale,
                                                _gathered, _kernel, _Rows,
                                                _nystrom_map,
                                                _staged_over_ranks)
from dask_ml_tpu_torch.parallel import telemetry
from dask_ml_tpu_torch.utils.validation import (check_array,
                                                check_random_state_np)


def _gram_colsum(C, rows=None):
    """The strip's column degrees ``Σ_rows C``: the fit's one sample-axis
    collective, over a mesh an ``hpsum`` under ``kernel.gram.colsum``
    (``rows``: the :class:`~dask_ml_tpu_torch.cluster.spectral._Rows` of
    the fit)."""
    if rows is None:
        return C.sum(dim=0)
    return rows.colsum(C, "kernel.gram.colsum")


def _feature_core(A, C, colsum, keep_idx, n_true: float, rows=None):
    """Φ (n, l) (over a mesh, this rank's rows) and the extension factors
    ``(ainv_colsum, d1_si, map_full)`` that :func:`predict` replays: the
    unified degree normalization, the small SVD, the thresholded
    full-width whitening."""
    ainv_colsum, d1_si, A2 = _degrees(A, C, colsum, keep_idx, rows)
    U_A, S_A, _ = torch.linalg.svd(A2)
    inv_sqrt = torch.where(S_A > S_A[0] * 1e-6, 1.0 / torch.sqrt(S_A),
                           torch.zeros_like(S_A))
    map_full = U_A * inv_sqrt[None, :]
    scale = _fit_scale(int(keep_idx.shape[0]), n_true, C.device)
    Phi = _nystrom_map(C, ainv_colsum, d1_si, map_full, scale,
                       row_normalize=False)
    return Phi, (ainv_colsum, d1_si, map_full)


class KernelKMeans(BaseEstimator):
    """Landmark (Nyström) kernel k-means. ``n_components`` is the landmark
    count l; ``affinity`` (a kernel name: callables are refused),
    ``gamma``, ``degree``, ``coef0`` and ``kernel_params`` the kernel;
    ``kmeans_params`` goes to the inner :class:`KMeans`, which runs from
    ``n_init`` seeds on the features computed once, keeping the lowest
    inertia.

    Attributes: ``labels_``, ``cluster_centers_`` (k, l: centers in
    feature space), ``inertia_`` (feature-space SSE), ``n_iter_``,
    ``assign_kmeans_``, and the landmark and extension state ``predict``
    replays."""

    def __init__(self, n_clusters=8, n_components=100, affinity="rbf",
                 gamma=1.0, degree=3, coef0=1, kernel_params=None,
                 n_init=3, random_state=None, kmeans_params=None):
        self.n_clusters = n_clusters
        self.n_components = n_components
        self.affinity = affinity
        self.gamma = gamma
        self.degree = degree
        self.coef0 = coef0
        self.kernel_params = kernel_params
        self.n_init = n_init
        self.random_state = random_state
        self.kmeans_params = kmeans_params

    def _kernel_params(self) -> dict:
        params = dict(self.kernel_params or {})
        params["gamma"] = self.gamma
        params["degree"] = self.degree
        params["coef0"] = self.coef0
        return params

    def fit(self, X, y=None):
        if callable(self.affinity):
            raise ValueError(
                "KernelKMeans requires a string kernel name; callable "
                "affinities are supported by SpectralClustering")
        _check_affinity(self.affinity)
        X = check_array(X)
        n = int(X.shape[0])
        l = int(self.n_components)
        if n <= l:
            raise ValueError(
                "'n_components' must be smaller than the number of "
                f"samples. Got {l} components and {n} samples")
        rng = check_random_state_np(self.random_state)
        rows = _Rows(X)
        over = None if rows.mesh is None else rows
        keep = rng.choice(np.arange(n), l, replace=False)
        keep.sort()
        keep_t = torch.as_tensor(keep, device=rows.X.device)
        with telemetry.span("kernel-kmeans-nystrom", landmarks=l,
                            k=int(self.n_clusters)):
            Xk, A, C = rows.blocks(X, keep, self.affinity,
                                   self._kernel_params(), keep_t)
            Phi, ext = _feature_core(A, C, _gram_colsum(C, over), keep_t,
                                     float(n), over)
            del A, C
        staged = None if over is None else rows.staged(Phi)
        km = None
        for _ in range(max(1, int(self.n_init))):
            cand = KMeans(n_clusters=self.n_clusters,
                          random_state=rng.randint(2**31 - 1))
            if self.kmeans_params:
                cand.set_params(**self.kmeans_params)
            if staged is None:
                cand.fit(Phi)
            else:
                cand._fit_staged(staged)
            if km is None or cand.inertia_ < km.inertia_:
                km = cand
        self._landmarks_ = Xk.cpu().numpy()
        self._extension_ = tuple(e.cpu().numpy() for e in ext)
        self._n_fit_rows_ = float(n)
        self.assign_kmeans_ = km
        self.labels_ = np.asarray(km.labels_)
        self.cluster_centers_ = np.asarray(km.cluster_centers_)
        self.inertia_ = float(km.inertia_)
        self.n_iter_ = int(km.n_iter_)
        self.n_features_in_ = int(X.shape[1])
        return self

    def fit_predict(self, X, y=None):
        self.fit(X)
        return self.labels_

    def _extend_rows(self, Xs):
        """The fit's feature rows of staged rows: the strip against the
        landmarks through the fit's map (training rows re-extend to their
        fit features)."""
        dev = Xs.device
        C = _kernel(Xs.to(torch.float32),
                    torch.as_tensor(self._landmarks_, device=dev),
                    self.affinity, self._kernel_params())
        return _nystrom_map(C, *_extension(self, dev), _fit_scale(
            self.n_components, self._n_fit_rows_, dev),
            row_normalize=False).contiguous()

    def _assign_staged(self, Xs):
        """Labels (a device tensor, int32) of staged rows: their feature
        rows, then K2 against the fitted centers."""
        from dask_ml_tpu_torch.ops.fused_distance import fused_argmin_min

        centers = torch.as_tensor(self.cluster_centers_, dtype=torch.float32,
                                  device=Xs.device)
        return fused_argmin_min(self._extend_rows(Xs), centers)[0]

    def predict(self, X):
        """Labels of new rows (int32): the landmark strip, the fit's
        feature map (training rows re-extend to their fit features), the
        nearest center through K2. X is staged in the precision policy's
        storage dtype."""
        if not hasattr(self, "cluster_centers_"):
            raise AttributeError("Model not fitted; call fit first")
        data = _staged_over_ranks(X)
        labels = _gathered(self._assign_staged(data.X), data)
        return labels.cpu().numpy().astype(np.int32)


__all__ = ["KernelKMeans"]

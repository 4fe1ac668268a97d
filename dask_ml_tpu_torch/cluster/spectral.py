"""Nyström-approximate spectral clustering of the PyTorch port (counterpart
of ``dask_ml_tpu/cluster/spectral.py``).

Sample ``n_components`` landmark rows, compute the kernel blocks
``A = K(X_l, X_l)`` (l, l) and ``C = K(X, X_l)`` (n, l) — the strip covers
every row, so the (n, n) affinity never exists and the embedding comes out
in the original row order — normalize by the approximate degrees, take the
SVD of the small normalized ``A`` and map every row through the Nyström
extension (Fowlkes et al. 2004, Eq. 16), then cluster the row-normalized
embedding with the port's :class:`~dask_ml_tpu_torch.cluster.KMeans` (K1 in
its Lloyd loop, K3/K4 in its k-means‖ init, K2 for its labels). The
strip and the small eigensolve are cuBLAS / cuSOLVER calls; no kernel of
the repo runs there.

``predict`` maps new rows through the same extension
(:func:`_nystrom_map`, so training rows re-extend to their fit
embedding) and assigns them with the fused argmin kernel (K2).

**Over a mesh of ranks** (:func:`~dask_ml_tpu_torch.parallel.mesh.
collective_mesh` of more than one data shard; every rank is handed the
same X) the landmarks are replicated (every rank takes the same rows of
its X), each rank computes the (m, l) strip of its own block of rows
(padding rows zeroed), the strip's column sum is an ``hpsum`` (op
``spectral.colsum``; kernel k-means ``kernel.gram.colsum``), and the
landmarks' degrees come from the ranks that hold them (the others add
zeros: op ``nystrom.landmarks``, exact). The small eigensolve is the same
on every rank. The inner :class:`KMeans` fits the rank's block of the
embedding over the mesh (K1–K4 on each block), and ``predict`` labels
each block through K2 and gathers the labels. :func:`embed` returns the
rank's block of ``Bt``. The column sums add in another order than on one
device, so the embedding agrees with the single-device one to f32
rounding, not bit for bit.

Two numerical choices follow the JAX package rather than PyTorch's
defaults: the pseudo-inverse of ``A`` cuts singular values at
``10·max(m, n)·eps·s_max`` (jax's ``pinv``; ``torch.linalg.pinv``'s default
cut is ten times smaller, and an rbf block's trailing spectrum sits near
it), and the landmarks and the inner KMeans' seed come from one numpy
``RandomState``, so both packages draw the same landmarks. The signs of
the SVD's columns are LAPACK's / cuSOLVER's, not XLA's: the embedding's
columns may flip against the JAX package's, its distances do not.
"""

from __future__ import annotations

import logging
from timeit import default_timer as tic

import numpy as np
import torch

from dask_ml_tpu_torch.base import BaseEstimator
from dask_ml_tpu_torch.cluster.k_means import KMeans
from dask_ml_tpu_torch.config import resolve_device
from dask_ml_tpu_torch.ops.pairwise import (PAIRWISE_KERNEL_FUNCTIONS,
                                            pairwise_kernels)
from dask_ml_tpu_torch.parallel import mesh as mesh_lib
from dask_ml_tpu_torch.parallel import telemetry
from dask_ml_tpu_torch.parallel.hierarchy import gather_blocks, hpsum
from dask_ml_tpu_torch.parallel.sharding import (DeviceData, prepare_data,
                                                 shard_rows)
from dask_ml_tpu_torch.utils.validation import (check_array,
                                                check_random_state_np)

logger = logging.getLogger(__name__)


def _check_affinity(metric):
    if isinstance(metric, str) and metric not in PAIRWISE_KERNEL_FUNCTIONS:
        raise ValueError(
            f"Unknown affinity metric name '{metric}'. Expected one of "
            f"{sorted(PAIRWISE_KERNEL_FUNCTIONS)}")


def _stage_f32(X):
    """A validated ``X`` (host array or tensor) as a contiguous f32 tensor
    on the configured device; a tensor already there is not copied."""
    return torch.as_tensor(X).to(device=resolve_device(),
                                 dtype=torch.float32).contiguous()


def _kernel(Xa, Xb, metric, params: dict):
    """``K(Xa, Xb)`` (f32, on ``Xa``'s device) for a kernel name or a
    callable taking ``(Xa, Xb, **params)``."""
    if callable(metric):
        return torch.as_tensor(metric(Xa, Xb, **params)).to(
            device=Xa.device, dtype=torch.float32)
    return pairwise_kernels(Xa, Xb, metric=metric, **params)


def _kernel_blocks(Xs, keep_idx, metric, params: dict):
    """The landmark rows ``X_l``, their block ``A = K(X_l, X_l)`` (l, l)
    and the strip ``C = K(X, X_l)`` (n, l)."""
    Xk = Xs[keep_idx]
    return Xk, _kernel(Xk, Xk, metric, params), _kernel(Xs, Xk, metric,
                                                          params)


class _Rows:
    """Where a Nyström fit's rows live: ``X`` the staged f32 rows (over
    a sharded mesh this rank's padded block), ``mesh`` that mesh (None on
    one device or a world of one rank), ``lo`` the block's first row,
    ``n`` the true row count."""

    def __init__(self, X):
        self.n = int(X.shape[0])
        mesh = mesh_lib.collective_mesh()
        if not mesh_lib.is_sharded(mesh):
            self.X, self.mesh, self.lo = _stage_f32(X), None, 0
            return
        self.X, _ = shard_rows(X, mesh, torch.float32)
        self.mesh = mesh
        self.lo = mesh_lib.data_sharding(mesh).rows(
            int(self.X.shape[0]) * mesh_lib.n_data_shards(mesh)).start
        self.valid = (torch.arange(self.X.shape[0], device=self.X.device)
                      + self.lo) < self.n

    def blocks(self, X, keep, metric, params: dict, keep_t):
        """``(X_l, A, C)``: the landmarks (every rank the same rows of
        its X), their block and this rank's strip, padding rows 0."""
        if self.mesh is None:
            return _kernel_blocks(self.X, keep_t, metric, params)
        sel = (X[torch.as_tensor(keep, device=X.device)]
               if isinstance(X, torch.Tensor) else X[keep])
        Xk = _stage_f32(sel)
        C = _kernel(self.X, Xk, metric, params)
        C = torch.where(self.valid[:, None], C, torch.zeros_like(C))
        return Xk, _kernel(Xk, Xk, metric, params), C

    def colsum(self, C, op: str):
        """``Σ_rows C`` over every rank's rows (``hpsum`` under ``op``)."""
        total = C.sum(dim=0)
        return total if self.mesh is None else hpsum(total, self.mesh, op=op)

    def landmarks(self, v, keep_idx):
        """``v[keep_idx]`` of a per-row vector: the rank that holds a
        landmark fills it in, the others add zeros (op
        ``nystrom.landmarks``)."""
        if self.mesh is None:
            return v[keep_idx]
        from dask_ml_tpu_torch.models.kmeans import _rows_by_owner

        return _rows_by_owner(v[:, None], keep_idx, self.lo, self.mesh,
                              "nystrom.landmarks")[:, 0]

    def staged(self, V):
        """The rank's block of an embedding as the ``DeviceData`` the
        inner KMeans fits over the mesh, in the staging dtype."""
        from dask_ml_tpu_torch.parallel import precision

        dtype = precision.staging_wire_dtype() or torch.float32
        shards = mesh_lib.n_data_shards(self.mesh)
        return DeviceData(
            X=V.to(dtype).contiguous(), weights=self.valid.to(torch.float32),
            n=self.n, n_features=int(V.shape[1]), mesh=self.mesh,
            n_padded=int(V.shape[0]) * shards, row_offset=self.lo)

    def whole(self, V):
        """Every rank's rows of a per-row result, in row order."""
        if self.mesh is None:
            return V
        return gather_blocks(V, self.mesh, op="nystrom.gather")[:self.n]


def _pinv(A):
    """The pseudo-inverse with jax's cutoff: singular values at or below
    ``10·max(m, n)·eps·s_max`` are dropped."""
    rtol = 10.0 * max(A.shape[-2:]) * float(torch.finfo(A.dtype).eps)
    return torch.linalg.pinv(A, rtol=rtol)


def _nystrom_map(C, ainv_colsum, d1_si, map_k, scale, *,
                 row_normalize: bool = True):
    """Map a kernel strip ``C = K(rows, landmarks)`` through fitted Nyström
    factors: approximate row degrees, the unified normalization, the
    eigenmap, and (spectral clustering) row normalization. Kernel k-means
    takes it without row normalization and with the full whitening map:
    its feature rows keep their kernel geometry."""
    d_row = C @ ainv_colsum
    d_si = 1.0 / torch.sqrt(torch.clamp(d_row, min=1e-12))
    C2 = d_si[:, None] * C * d1_si[None, :]
    V = scale * (C2 @ map_k)
    if not row_normalize:
        return V
    return V / torch.clamp(torch.linalg.norm(V, dim=1, keepdim=True),
                           min=1e-12)


def _degrees(A, C, colsum, keep_idx, rows=None):
    """The unified degree normalization from the strip's column sums
    ``colsum = Σ_rows C`` (the keep rows are A's rows, so one formula
    covers every row): the degree functional ``A⁺ colsum`` and the
    landmarks' ``d^-½`` (``rows``: a :class:`_Rows` over a mesh, whose
    ranks hold the landmark rows). Returns ``(ainv_colsum, d1_si, A2 =
    D_l^-½ A D_l^-½)``."""
    ainv_colsum = _pinv(A) @ colsum
    d_all = C @ ainv_colsum
    d_si = 1.0 / torch.sqrt(torch.clamp(d_all, min=1e-12))
    d1_si = d_si[keep_idx] if rows is None else rows.landmarks(d_si,
                                                               keep_idx)
    return ainv_colsum, d1_si, d1_si[:, None] * A * d1_si[None, :]


def _fit_scale(l_count: int, n_true: float, device):
    """``sqrt(l / n)`` in f32, as the fit computes it; ``predict`` takes
    the same bits, so that training rows re-extend to their fit embedding
    exactly (the JAX package's predict forms it in float64 first)."""
    return torch.sqrt(torch.tensor(float(l_count), dtype=torch.float32,
                                   device=device)
                      / torch.tensor(n_true, dtype=torch.float32,
                                     device=device))


def _nystrom_core(A, C, keep_idx, n_true: float, k: int, rows=None):
    """The Nyström math after the kernel blocks: degree normalization, the
    small SVD, Eq. 16 and row normalization. Returns the (n, k) embedding
    (over a mesh, of this rank's rows), the singular values and the
    extension factors ``(ainv_colsum, d1_si, map_k)`` that
    :func:`_nystrom_map` replays on new rows."""
    colsum = (C.sum(dim=0) if rows is None
              else rows.colsum(C, "spectral.colsum"))
    ainv_colsum, d1_si, A2 = _degrees(A, C, colsum, keep_idx, rows)
    U_A, S_A, _ = torch.linalg.svd(A2)
    map_k = U_A[:, :k] * (1.0 / torch.sqrt(S_A[:k]))[None, :]
    scale = _fit_scale(int(keep_idx.shape[0]), n_true, C.device)
    V2 = _nystrom_map(C, ainv_colsum, d1_si, map_k, scale)
    return V2, S_A, (ainv_colsum, d1_si, map_k)


def _extension(est, device):
    return tuple(torch.as_tensor(e).to(device) for e in est._extension_)


class SpectralClustering(BaseEstimator):
    """Approximate spectral clustering by the Nyström method
    (scikit-learn's constructor, with ``n_components`` the landmark count
    and ``kmeans_params`` forwarded to the clustering of the embedding).

    ``assign_labels`` is ``"kmeans"`` (the port's KMeans: the embedding
    stays on the device), ``"sklearn-kmeans"`` (scikit-learn, imported on
    use, fitted on a host copy of the embedding) or an estimator.
    ``affinity`` is a kernel name or a callable taking ``(X, Y, **params)``
    on tensors (``params`` holds ``gamma``, ``degree``, ``coef0`` and
    ``kernel_params``) and returning an array-like.

    Attributes: ``labels_`` (int32 for the port's KMeans),
    ``eigenvalues_`` (the top ``n_clusters`` singular values of the
    normalized landmark block), ``assign_labels_`` (the fitted clusterer),
    ``fit_phase_seconds_`` (``{"nystrom": s, "kmeans": s}``) and the
    landmark and extension state ``predict`` replays.
    """

    def __init__(self, n_clusters=8, eigen_solver=None, random_state=None,
                 n_init=10, gamma=1.0, affinity="rbf", n_neighbors=10,
                 eigen_tol=0.0, assign_labels="kmeans", degree=3, coef0=1,
                 kernel_params=None, n_jobs=1, n_components=100,
                 persist_embedding=False, kmeans_params=None):
        self.n_clusters = n_clusters
        self.eigen_solver = eigen_solver
        self.random_state = random_state
        self.n_init = n_init
        self.gamma = gamma
        self.affinity = affinity
        self.n_neighbors = n_neighbors
        self.eigen_tol = eigen_tol
        self.assign_labels = assign_labels
        self.degree = degree
        self.coef0 = coef0
        self.kernel_params = kernel_params
        self.n_jobs = n_jobs
        self.n_components = n_components
        self.persist_embedding = persist_embedding
        self.kmeans_params = kmeans_params

    def _make_km(self, rng):
        if isinstance(self.assign_labels, str):
            if self.assign_labels == "kmeans":
                km = KMeans(n_clusters=self.n_clusters,
                            random_state=rng.randint(2**31 - 1))
            elif self.assign_labels == "sklearn-kmeans":
                import sklearn.cluster

                km = sklearn.cluster.KMeans(n_clusters=self.n_clusters,
                                            random_state=rng)
            else:
                raise ValueError(
                    f"Unknown 'assign_labels' {self.assign_labels!r}")
        elif hasattr(self.assign_labels, "fit") \
                and hasattr(self.assign_labels, "set_params"):
            km = self.assign_labels
        else:
            raise TypeError(
                f"Invalid type {type(self.assign_labels)} for "
                "'assign_labels'")
        if self.kmeans_params:
            km.set_params(**self.kmeans_params)
        return km

    def _kernel_params(self) -> dict:
        params = dict(self.kernel_params or {})
        params["gamma"] = self.gamma
        params["degree"] = self.degree
        params["coef0"] = self.coef0
        return params

    def fit(self, X, y=None):
        t0 = tic()
        X = check_array(X)
        n = int(X.shape[0])
        l = int(self.n_components)
        k = int(self.n_clusters)
        if n <= l:
            raise ValueError(
                "'n_components' must be smaller than the number of samples."
                f" Got {l} components and {n} samples")
        _check_affinity(self.affinity)
        rng = check_random_state_np(self.random_state)
        km = self._make_km(rng)
        params = self._kernel_params()
        rows = _Rows(X)
        keep = rng.choice(np.arange(n), l, replace=False)
        keep.sort()
        keep_t = torch.as_tensor(keep, device=rows.X.device)
        with telemetry.span("spectral-nystrom", landmarks=l, k=k):
            Xk, A, C = rows.blocks(X, keep, self.affinity, params, keep_t)
            U2, S_A, ext = _nystrom_core(
                A, C, keep_t, float(n), k,
                None if rows.mesh is None else rows)
            del A, C
            self._landmarks_ = Xk.cpu().numpy()
            self._extension_ = tuple(e.cpu().numpy() for e in ext)
            self._n_fit_rows_ = float(n)
        t_nys = tic()
        logger.info("k-means for assign_labels [starting]")
        if isinstance(km, KMeans) and rows.mesh is not None:
            km._fit_staged(rows.staged(U2))  # each rank its block
        elif isinstance(km, KMeans):
            km.fit(U2)  # the embedding stays on the device
        else:
            km.fit(rows.whole(U2).cpu().numpy())
        logger.info("k-means for assign_labels [finished]")
        self.assign_labels_ = km
        self.labels_ = np.asarray(km.labels_)
        self.eigenvalues_ = S_A[:k].cpu().numpy()
        self.n_features_in_ = int(X.shape[1])
        self.fit_phase_seconds_ = {"nystrom": t_nys - t0,
                                   "kmeans": tic() - t_nys}
        return self

    def fit_predict(self, X, y=None):
        self.fit(X)
        return self.labels_

    def _extend_rows(self, Xs):
        """The fit's embedding of staged rows: the kernel strip against
        the landmarks through the fit's extension (training rows
        re-extend to their fit embedding)."""
        dev = Xs.device
        C = _kernel(Xs.to(torch.float32),
                    torch.as_tensor(self._landmarks_, device=dev),
                    self.affinity, self._kernel_params())
        return _nystrom_map(C, *_extension(self, dev), _fit_scale(
            self.n_components, self._n_fit_rows_, dev)).contiguous()

    def _assign(self, V):
        """K2 (``fused_argmin_min``): V's nearest fitted centers."""
        from dask_ml_tpu_torch.ops.fused_distance import fused_argmin_min

        centers = torch.as_tensor(self.assign_labels_.cluster_centers_,
                                  dtype=torch.float32, device=V.device)
        return fused_argmin_min(V, centers)[0]

    def _assign_staged(self, Xs):
        """Nearest-center labels (a device tensor, int32) of staged rows:
        the strip, the extension, K2. The predict path of a string
        affinity with the port's KMeans."""
        if callable(self.affinity) or not isinstance(self.assign_labels_,
                                                     KMeans):
            raise ValueError(
                "staged assignment requires a string-kernel affinity and "
                "the native KMeans assigner")
        return self._assign(self._extend_rows(Xs))

    def predict(self, X):
        """Labels of new rows: the kernel strip against the fitted
        landmarks, the extension the fit used, then the nearest fitted
        center through K2 (a foreign assigner predicts on a host copy of
        the embedding). X is staged in the precision policy's storage
        dtype."""
        if not hasattr(self, "assign_labels_"):
            raise AttributeError("Model not fitted; call fit first")
        data = _staged_over_ranks(X)
        V = self._extend_rows(data.X)
        if isinstance(self.assign_labels_, KMeans):
            labels = _gathered(self._assign(V), data)
            return labels.cpu().numpy().astype(np.int32)
        return np.asarray(self.assign_labels_.predict(
            _gathered(V, data).cpu().numpy()))


def embed(X_keep, X_rest, n_components, metric, kernel_params):
    """The kernel blocks of the Nyström embedding: ``A = K(X_keep,
    X_keep)`` (l, l) and ``Bt = K(X_rest, X_keep)`` (m, l), the transpose of
    the reference's ``B``, both on the configured device. Callable metrics
    receive ``(X, Y, **kernel_params)``. Over a mesh of more than one data
    shard ``Bt`` is this rank's block of ``X_rest``'s padded rows, the
    padding rows zeroed (the JAX package's sharded ``Bt``)."""
    _check_affinity(metric)
    if n_components != len(X_keep):
        raise ValueError(
            f"n_components={n_components} must equal the number of sampled "
            f"rows len(X_keep)={len(X_keep)}")
    params = dict(kernel_params or {})
    Xk = _stage_f32(check_array(X_keep))
    rows = _Rows(check_array(X_rest))
    Bt = _kernel(rows.X, Xk, metric, params)
    if rows.mesh is not None:
        Bt = torch.where(rows.valid[:, None], Bt, torch.zeros_like(Bt))
    return _kernel(Xk, Xk, metric, params), Bt


def _staged_over_ranks(X):
    """``X`` validated and staged for prediction: over the collective
    mesh this rank's block (in the policy's storage dtype)."""
    return prepare_data(check_array(X), mesh=mesh_lib.collective_mesh())


def _gathered(out, data):
    """A per-row result of staged rows, every block's gathered in row
    order over a sharded mesh (op ``nystrom.gather``)."""
    if not mesh_lib.is_sharded(data.mesh):
        return out
    return gather_blocks(out, data.mesh, op="nystrom.gather")[:data.n]


__all__ = ["SpectralClustering", "embed"]

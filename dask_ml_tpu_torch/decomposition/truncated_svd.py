"""Truncated SVD (LSA) without centering, in the PyTorch port (counterpart
of ``dask_ml_tpu/decomposition/truncated_svd.py``).

Inside a ``torch.distributed`` world the fit runs over
:func:`~dask_ml_tpu_torch.parallel.mesh.collective_mesh`, as
:class:`~dask_ml_tpu_torch.decomposition.PCA`'s does: each rank factors its
block of the rows, the variances are sums over the ranks (op
``tsvd.moments``), and ``fit_transform`` gathers the rows of its output
from every rank (op ``tsvd.gather``)."""

from __future__ import annotations

import torch

from dask_ml_tpu_torch.base import BaseEstimator, TransformerMixin
from dask_ml_tpu_torch.config import maybe_host
from dask_ml_tpu_torch.decomposition.pca import shared_generator
from dask_ml_tpu_torch.ops import linalg
from dask_ml_tpu_torch.parallel import hierarchy as hier
from dask_ml_tpu_torch.parallel import mesh as mesh_lib
from dask_ml_tpu_torch.parallel import precision
from dask_ml_tpu_torch.parallel.sharding import prepare_data
from dask_ml_tpu_torch.utils.validation import check_array


def _mesh_variances(T, X, w, n: int, mesh):
    """The column variances (ddof 0) of the valid rows of the rank blocks
    ``T`` and ``X`` in two passes, each one ``tsvd.moments`` sum over
    every rank: the means, then the centered squares. Returns ``(var of
    T's columns, Σ of X's)``."""
    keep = (w > 0).to(T.dtype)[:, None]
    k = int(T.shape[1])
    means = hier.hpsum(torch.cat([(T * keep).sum(0), (X * keep).sum(0)]),
                       mesh, op="tsvd.moments") / n
    sq = hier.hpsum(torch.cat([((T - means[:k]) ** 2 * keep).sum(0),
                               ((X - means[k:]) ** 2 * keep).sum(0)]),
                    mesh, op="tsvd.moments") / n
    return sq[:k], float(sq[k:].sum())


class TruncatedSVD(BaseEstimator, TransformerMixin):
    """Dimensionality reduction by truncated SVD, without centering.

    ``algorithm``: ``"tsqr"`` (the exact tsqr SVD, then truncated) or
    ``"randomized"`` (the range finder with ``n_iter`` power iterations,
    its rank rounded up to a multiple of 32 as the JAX package buckets it;
    its test matrix comes from a ``torch.Generator`` seeded by
    ``random_state``)."""

    def __init__(self, n_components=2, algorithm="tsqr", n_iter=5,
                 random_state=None, tol=0.0):
        self.algorithm = algorithm
        self.n_components = n_components
        self.n_iter = n_iter
        self.random_state = random_state
        self.tol = tol

    def _check_array(self, X):
        X = check_array(X)
        if self.n_components >= X.shape[1]:
            raise ValueError(
                "n_components must be < n_features; "
                f"got {self.n_components} >= {X.shape[1]}")
        if self.n_components > X.shape[0]:
            raise ValueError(
                "n_components must be <= n_samples; "
                f"got {self.n_components} > {X.shape[0]}")
        return X

    def fit(self, X, y=None):
        self._fit(X)
        return self

    def fit_transform(self, X, y=None):
        X_transformed, n, mesh = self._fit(X)
        if mesh is not None:
            # every rank's block of rows, in order: the whole output
            X_transformed = hier.gather_blocks(
                X_transformed, mesh, op="tsvd.gather")[:n]
        return maybe_host(X_transformed)

    def _fit(self, X):
        """Fit; returns (this rank's rows of ``U·S``, the sample count,
        the mesh or None)."""
        X = self._check_array(X)
        if self.algorithm not in {"tsqr", "randomized"}:
            raise ValueError(
                f"algorithm must be 'tsqr' or 'randomized', "
                f"got {self.algorithm!r}")
        k = int(self.n_components)
        mesh = mesh_lib.collective_mesh()
        data = prepare_data(X, mesh=mesh)
        # a bf16 X (precision="bf16"): the exact path factors it widened
        # to f32, the randomized one sketches it on the policy's dtype
        Xf = data.X.to(torch.float32)
        if self.algorithm == "tsqr":
            u, s, v = linalg.tsvd(Xf, weights=data.weights, mesh=mesh)
        else:
            k_fit = min(-(-k // 32) * 32, min(int(X.shape[0]),
                                              int(X.shape[1])))
            u, s, v = linalg.svd_compressed(
                data.X, k_fit, n_power_iter=int(self.n_iter),
                generator=shared_generator(self.random_state, mesh,
                                           data.X.device),
                weights=data.weights, mesh=mesh)
        u, v = linalg.svd_flip(u[:, :k], v[:k])
        s = s[:k]
        X_transformed = u * s
        if mesh is None:
            # variance bookkeeping over the rows (ddof = 0)
            explained_var = torch.var(X_transformed, dim=0, correction=0)
            full_var = float(torch.var(Xf, dim=0, correction=0).sum())
        else:
            explained_var, full_var = _mesh_variances(
                X_transformed, Xf, data.weights, data.n, mesh)
        self.components_ = v.cpu().numpy()
        self.explained_variance_ = explained_var.cpu().numpy()
        self.explained_variance_ratio_ = self.explained_variance_ / full_var
        self.singular_values_ = s.cpu().numpy()
        return X_transformed, data.n, mesh

    def _project(self, X, comps):
        Xs = prepare_data(check_array(X)).X
        return maybe_host(precision.pmatmul(
            Xs, torch.as_tensor(comps, device=Xs.device)))

    def transform(self, X, y=None):
        return self._project(X, self.components_.T)

    def inverse_transform(self, X):
        return self._project(X, self.components_)

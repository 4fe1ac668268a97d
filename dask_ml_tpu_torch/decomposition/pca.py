"""PCA of the PyTorch port (counterpart of
``dask_ml_tpu/decomposition/pca.py``).

The same solver policy, validation errors, explained-variance and
Probabilistic-PCA noise-variance bookkeeping, sign convention, whitening
and scoring as the JAX package. The fit runs on the configured device:
the weighted mean, centering with rows of weight 0 zeroed, the
factorization (:func:`~dask_ml_tpu_torch.ops.linalg.tsvd` for
``"full"``/``"tsqr"``, :func:`~dask_ml_tpu_torch.ops.linalg.svd_compressed`
for ``"randomized"``), the sign flip and the total variance; only the
small results come to the host.

The randomized test matrix is drawn from a ``torch.Generator`` seeded by
``random_state``, so it differs from the JAX package's ``jax.random``
draw: randomized fits agree with the JAX package in quality, not in bits.
"""

from __future__ import annotations

import numpy as np
import torch

from dask_ml_tpu_torch.base import BaseEstimator, TransformerMixin
from dask_ml_tpu_torch.config import get_config, maybe_host
from dask_ml_tpu_torch.ops import linalg
from dask_ml_tpu_torch.parallel import precision, telemetry
from dask_ml_tpu_torch.parallel.sharding import prepare_data
from dask_ml_tpu_torch.utils.validation import check_array, check_random_state


def _on(a, like):
    """A fitted host array as a float32 tensor on ``like``'s device."""
    return torch.as_tensor(np.asarray(a, dtype=np.float32),
                           device=like.device)


def transform_program(Xs, mean, components, ev, *, whiten: bool):
    """The transform of staged rows: ``(Xs − mean) @ componentsᵀ``, divided
    by ``√ev`` when whitening. ``PCA.transform`` and the serving tier's
    runner both call it, so a served batch computes what a direct call
    does."""
    out = (Xs - mean) @ components.T
    if whiten:
        out = out / torch.sqrt(ev)
    return out


def _fit_program(X, w, n, *, k, n_power_iter, randomized, generator,
                 sketch_dtype=None):
    """The device part of a fit: mean, centering and masking, the
    factorization, the sign flip, and (randomized only: the exact path's
    total variance is Σ S² / (n − 1)) the total variance. A bf16 X is
    centered into f32 (the mean is f32); ``sketch_dtype`` is the operand
    dtype of the randomized range finder (None: Xc's)."""
    mean = (w[:, None] * X).sum(0) / torch.clamp(w.sum(), min=1.0)
    Xc = (X - mean) * (w > 0)[:, None].to(mean.dtype)
    if randomized:
        U, S, Vt = linalg.svd_compressed(
            Xc, k, n_power_iter=n_power_iter, generator=generator,
            n_oversamples=10, compute_dtype=sketch_dtype)
        total_var = (Xc * Xc).sum() / (n - 1.0)
    else:
        U, S, Vt = linalg.tsvd(Xc)
        total_var = None
    U, Vt = linalg.svd_flip(U, Vt)
    return mean, U, S, Vt, total_var


class PCA(BaseEstimator, TransformerMixin):
    """Principal component analysis (the JAX package's surface).

    ``svd_solver``: ``"auto"`` | ``"full"`` | ``"tsqr"`` | ``"randomized"``
    — ``"full"`` and ``"tsqr"`` both run the exact tsqr SVD;
    ``"randomized"`` the range finder with ``iterated_power`` power
    iterations, its rank rounded up to a multiple of 32 (as the JAX package
    buckets it; the surplus components are dropped and only sharpen the
    kept ones)."""

    def __init__(self, n_components=None, copy=True, whiten=False,
                 svd_solver="auto", tol=0.0, iterated_power=0,
                 random_state=None):
        self.n_components = n_components
        self.copy = copy
        self.whiten = whiten
        self.svd_solver = svd_solver
        self.tol = tol
        self.iterated_power = iterated_power
        self.random_state = random_state

    # -- fitting -----------------------------------------------------------

    def _resolve_solver(self, n_samples, n_features, n_components):
        solver = self.svd_solver
        if solver == "auto":
            if max(n_samples, n_features) <= 500:
                solver = "full"
            elif 1 <= n_components < 0.8 * min(n_samples, n_features):
                solver = "randomized"
            else:
                solver = "full"
        return solver

    def _fit(self, X):
        solvers = {"full", "auto", "tsqr", "randomized"}
        if self.svd_solver not in solvers:
            raise ValueError(
                f"Invalid solver '{self.svd_solver}'. Must be one of "
                f"{solvers}")
        X = check_array(X)
        n_samples, n_features = int(X.shape[0]), int(X.shape[1])
        if self.n_components is None:
            n_components = min(n_samples, n_features)
        elif 0 < self.n_components < 1:
            raise NotImplementedError(
                "Fractional 'n_components' is not currently supported")
        else:
            n_components = int(self.n_components)
        solver = self._resolve_solver(n_samples, n_features, n_components)
        lower_limit = 1 if solver == "randomized" else 0
        if not (min(n_samples, n_features) >= n_components >= lower_limit):
            raise ValueError(
                f"n_components={n_components} must be between {lower_limit} "
                f"and min(n_samples, n_features)="
                f"{min(n_samples, n_features)} with svd_solver='{solver}'")

        data = prepare_data(X)
        randomized = solver == "randomized"
        k_fit = n_components
        if randomized:
            k_fit = min(-(-n_components // 32) * 32,
                        min(n_samples, n_features))
        gen = check_random_state(self.random_state, device=data.X.device)
        # the precision policy's sketch dtype (bf16 under "bf16")
        sketch_dtype = (precision.resolve().compute_for("sketch")
                        if randomized else None)
        with telemetry.span("pca-fit-program", solver=solver,
                            k=n_components):
            mean, U, S, Vt, tv = _fit_program(
                data.X, data.weights, float(n_samples), k=k_fit,
                n_power_iter=int(self.iterated_power), randomized=randomized,
                generator=gen, sketch_dtype=sketch_dtype)

        S_t = S[:min(n_samples, n_features)].cpu().numpy()
        explained_variance = (S_t ** 2) / (n_samples - 1)
        if randomized:
            total_var = float(tv)
        else:
            total_var = explained_variance.sum()
        explained_variance_ratio = explained_variance / total_var
        # Probabilistic-PCA noise variance
        if n_components < min(n_features, n_samples):
            if randomized:
                # the bucketed sketch's surplus values belong to the tail
                noise_variance = (
                    (total_var - explained_variance[:n_components].sum())
                    / (min(n_features, n_samples) - n_components))
            else:
                noise_variance = explained_variance[n_components:].mean()
        else:
            noise_variance = 0.0

        self.n_samples_ = n_samples
        self.n_features_ = n_features
        self.n_components_ = n_components
        self.mean_ = mean.cpu().numpy()
        self.components_ = Vt[:n_components].cpu().numpy()
        self.explained_variance_ = explained_variance[:n_components]
        self.explained_variance_ratio_ = \
            explained_variance_ratio[:n_components]
        self.singular_values_ = S_t[:n_components]
        self.noise_variance_ = float(noise_variance)
        return U, S

    def fit(self, X, y=None):
        self._fit(X)
        return self

    def fit_transform(self, X, y=None):
        """U·S (U·√(n−1) when whitening), without a second data pass."""
        U, S = self._fit(X)
        k = self.n_components_
        Uk = U[:, :k]
        if self.whiten:
            # a whitened output can be non-finite where a variance is 0:
            # the next stage scans it
            return maybe_host(Uk * float(np.sqrt(self.n_samples_ - 1)),
                              trusted=False)
        return maybe_host(Uk * S[:k])

    # -- inference ---------------------------------------------------------

    def _staged(self, X):
        X = check_array(X)
        if X.shape[1] != self.n_features_:
            raise ValueError(
                f"X has {X.shape[1]} features; the model was fitted with "
                f"{self.n_features_}")
        return prepare_data(X).X

    def transform(self, X):
        Xs = self._staged(X)
        out = transform_program(
            Xs, _on(self.mean_, Xs), _on(self.components_, Xs),
            _on(self.explained_variance_, Xs), whiten=bool(self.whiten))
        return maybe_host(out, trusted=not self.whiten)

    def inverse_transform(self, X):
        Xs = prepare_data(check_array(X)).X
        comps = _on(self.components_, Xs)
        if self.whiten:
            comps = torch.sqrt(_on(self.explained_variance_, Xs))[:, None] \
                * comps
        return maybe_host(precision.pmatmul(Xs, comps) + _on(self.mean_, Xs))

    # -- Probabilistic-PCA scoring ------------------------------------------

    def _scaled_components(self):
        """Components rescaled when whitening, as scikit-learn's _BasePCA
        does for the covariance and precision model."""
        comps = self.components_.astype(np.float64)
        if self.whiten:
            comps = comps * np.sqrt(
                self.explained_variance_.astype(np.float64))[:, None]
        return comps

    def get_covariance(self):
        """Model covariance ``Vᵀ·diag(λ − σ²)·V + σ²·I``."""
        comps = self._scaled_components()
        exp_var_diff = np.maximum(
            self.explained_variance_ - self.noise_variance_, 0.0)
        cov = (comps.T * exp_var_diff) @ comps
        cov += self.noise_variance_ * np.eye(self.n_features_,
                                             dtype=cov.dtype)
        return cov

    def get_precision(self):
        """Inverse model covariance, by Woodbury on the small k × k
        system."""
        n_features = self.n_features_
        if self.n_components_ == 0:
            return np.eye(n_features) / self.noise_variance_
        comps = self._scaled_components()
        exp_var = self.explained_variance_.astype(np.float64)
        if self.noise_variance_ == 0.0:
            return np.linalg.inv(self.get_covariance().astype(np.float64))
        exp_var_diff = np.maximum(exp_var - self.noise_variance_, 0.0)
        small = (comps @ comps.T) / self.noise_variance_
        small[np.diag_indices(len(small))] += 1.0 / np.maximum(
            exp_var_diff, 1e-300)
        out = -(comps.T @ np.linalg.inv(small) @ comps)
        out /= self.noise_variance_ ** 2
        out[np.diag_indices(n_features)] += 1.0 / self.noise_variance_
        return out

    def score_samples(self, X):
        """Per-sample PPCA log-likelihood; the quadratic form runs on the
        device."""
        Xs = self._staged(X)
        prec = self.get_precision()
        Xr = Xs - _on(self.mean_, Xs)
        ll = -0.5 * (Xr * (Xr @ _on(prec, Xs))).sum(dim=1)
        _, logdet = np.linalg.slogdet(prec)
        ll = ll - float(0.5 * (self.n_features_ * np.log(2.0 * np.pi)
                               - logdet))
        return maybe_host(ll)

    def score(self, X, y=None):
        ll = self.score_samples(X)
        if get_config()["device_outputs"]:
            ll = ll.cpu().numpy()
        return float(np.mean(ll))

"""Pairwise distances and kernels of the PyTorch port (counterpart of
``dask_ml_tpu/ops/pairwise.py``).

``X`` is the large operand and ``Y`` the small one, as in the reference
(``Y`` is a set of centers or landmarks). Distances are the
``|x|² + |y|² − 2·X@Yᵀ`` expression clamped at 0 against cancellation;
the kernels are ``torch.matmul`` with an elementwise epilogue. The one
reduction, :func:`pairwise_distances_argmin_min`, goes through the fused
distance family, which on the card is the hand-written argmin/min kernel
(``_kernels/csrc/fused_distance.cu``): the ``(n, m)`` matrix is never
formed there.

Inputs may be numpy arrays or tensors; numpy inputs are staged onto the
configured device. Results are tensors on the operands' device.
"""

from __future__ import annotations

import numpy as np
import torch

from dask_ml_tpu_torch.config import resolve_device
from dask_ml_tpu_torch.ops.fused_distance import _dot_t, _row_sumsq


def _as_float_tensor(A, device=None):
    if isinstance(A, torch.Tensor):
        t = A
    else:
        t = torch.as_tensor(np.asarray(A), device=resolve_device(device))
    return t if t.is_floating_point() else t.to(torch.float32)


def check_pairwise_arrays(X, Y, precomputed: bool = False):
    """Validate and align a pair of operands: ``(X, Y)`` as float tensors
    (integer input becomes float32) with ``Y = X`` when None; raises on a
    feature-dimension mismatch (or, for ``precomputed=True``, when
    ``X.shape[1] != Y.shape[0]``)."""
    X = _as_float_tensor(X)
    if X.ndim != 2:
        raise ValueError(
            f"Expected a 2-D array for X, got {X.ndim}-D shape "
            f"{tuple(X.shape)}")
    if Y is None:
        Y = X
    else:
        Y = _as_float_tensor(Y, device=X.device)
        if Y.ndim != 2:
            raise ValueError(
                f"Expected a 2-D array for Y, got {Y.ndim}-D shape "
                f"{tuple(Y.shape)}")
    if precomputed:
        if X.shape[1] != Y.shape[0]:
            raise ValueError(
                "Precomputed metric requires shape (n_queries, n_indexed). "
                f"Got ({X.shape[0]}, {X.shape[1]}) for {Y.shape[0]} "
                "indexed.")
    elif X.shape[1] != Y.shape[1]:
        raise ValueError(
            "Incompatible dimension for X and Y matrices: "
            f"X.shape[1] == {X.shape[1]} while Y.shape[1] == {Y.shape[1]}")
    return X, Y


def _pair(X, Y):
    """X and Y as float tensors of one dtype (a bf16 X against f32 centers
    is promoted to f32, as ``jnp`` promotes the pair)."""
    X = _as_float_tensor(X)
    if Y is None:
        return X, X
    Y = _as_float_tensor(Y, device=X.device)
    dt = torch.promote_types(X.dtype, Y.dtype)
    return X.to(dt), Y.to(dt)


def _sqrt(d2):
    """``sqrt`` rounded correctly, as IEEE and the JAX package round it: on
    the card ``torch.sqrt`` is; on some CPU builds of PyTorch it is off by
    an ulp for about a sixth of f32 inputs, so a CPU tensor takes it in
    float64 (whose rounding to f32 is the correctly rounded f32 root)."""
    if d2.device.type == "cuda":
        return torch.sqrt(d2)
    return torch.sqrt(d2.to(torch.float64)).to(d2.dtype)


def _dot(X, Y):
    """``X @ Y.T``; an f32 pair through the fused family's
    :func:`~dask_ml_tpu_torch.ops.fused_distance._dot_t`, so on the CPU a
    row's products do not depend on the rows around it."""
    if X.dtype == torch.float32:
        return _dot_t(X, Y)
    return X @ Y.T


def _sumsq(X):
    """Per-row Σx², an f32 X summed as :func:`_dot` sums."""
    if X.dtype == torch.float32:
        return _row_sumsq(X)
    return (X * X).sum(dim=1)


def sq_euclidean(X, Y):
    """Squared Euclidean distance matrix, clamped at 0."""
    X, Y = _pair(X, Y)
    x2 = _sumsq(X)[:, None]
    y2 = _sumsq(Y)[None, :]
    return torch.clamp(x2 + y2 - 2.0 * _dot(X, Y), min=0.0)


def euclidean_distances(X, Y=None):
    """Euclidean distance matrix between the rows of X and Y. With
    ``Y=None`` (X against itself) the diagonal is exactly zero, as
    scikit-learn makes it: the ``|x|² + |y|² − 2x·y`` form leaves f32
    cancellation error there."""
    if Y is None:
        d2 = sq_euclidean(X, X)
        d2.fill_diagonal_(0.0)
        return _sqrt(d2)
    return _sqrt(sq_euclidean(X, Y))


def pairwise_distances_argmin_min(X, Y, *, kernel: str = "auto",
                                  mesh=None):
    """For each row of X, the index (int32) of and the distance to the
    nearest row of Y; ties go to the lowest index. Through
    :func:`~dask_ml_tpu_torch.ops.fused_distance.fused_argmin_min`, the
    fused argmin/min kernel on the card (``kernel`` and ``mesh`` as
    there), then a ``sqrt`` of the min squared distance."""
    from dask_ml_tpu_torch.ops.fused_distance import fused_argmin_min

    X, Y = _pair(X, Y)
    argmin, mind = fused_argmin_min(X.to(torch.float32).contiguous(),
                                    Y.to(torch.float32).contiguous(),
                                    kernel=kernel, mesh=mesh)
    return argmin, _sqrt(mind)


def _gamma(X, gamma):
    return 1.0 / X.shape[1] if gamma is None else gamma


def linear_kernel(X, Y=None):
    X, Y = _pair(X, Y)
    return _dot(X, Y)


def rbf_kernel(X, Y=None, gamma=None):
    X, Y = _pair(X, Y)
    return torch.exp(-_gamma(X, gamma) * sq_euclidean(X, Y))


def polynomial_kernel(X, Y=None, degree=3, gamma=None, coef0=1.0):
    X, Y = _pair(X, Y)
    return (_gamma(X, gamma) * _dot(X, Y) + coef0) ** degree


def sigmoid_kernel(X, Y=None, gamma=None, coef0=1.0):
    X, Y = _pair(X, Y)
    return torch.tanh(_gamma(X, gamma) * _dot(X, Y) + coef0)


PAIRWISE_KERNEL_FUNCTIONS = {
    "linear": linear_kernel,
    "rbf": rbf_kernel,
    "polynomial": polynomial_kernel,
    "poly": polynomial_kernel,
    "sigmoid": sigmoid_kernel,
}

_KERNEL_PARAMS = {
    "linear": set(),
    "rbf": {"gamma"},
    "polynomial": {"degree", "gamma", "coef0"},
    "poly": {"degree", "gamma", "coef0"},
    "sigmoid": {"gamma", "coef0"},
}


def pairwise_kernels(X, Y=None, metric: str = "linear", **kwds):
    """Kernel registry dispatch; ``metric`` may also be a callable taking
    (X, Y). Keyword arguments the kernel does not take are dropped."""
    if callable(metric):
        return metric(X, X if Y is None else Y, **kwds)
    if metric not in PAIRWISE_KERNEL_FUNCTIONS:
        raise ValueError(
            f"Unknown kernel {metric!r}; valid: "
            f"{sorted(set(PAIRWISE_KERNEL_FUNCTIONS))}")
    kwds = {k: v for k, v in kwds.items() if k in _KERNEL_PARAMS[metric]}
    return PAIRWISE_KERNEL_FUNCTIONS[metric](X, Y, **kwds)


def pairwise_distances(X, Y=None, metric: str = "euclidean", **kwds):
    """Distance registry: "euclidean", "sqeuclidean" or a callable taking
    (X, Y)."""
    if callable(metric):
        return metric(X, X if Y is None else Y, **kwds)
    if metric == "euclidean":
        return euclidean_distances(X, Y)
    if metric == "sqeuclidean":
        return sq_euclidean(X, X if Y is None else Y)
    raise ValueError(f"Unknown distance metric {metric!r}")

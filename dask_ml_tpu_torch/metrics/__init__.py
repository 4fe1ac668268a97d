"""Metrics of the PyTorch port (counterpart of ``dask_ml_tpu/metrics``):
the pairwise distances and kernels of :mod:`dask_ml_tpu_torch.ops.pairwise`
(tensors, on the device), and the scores the estimators' ``score`` and the
scorers need, in numpy: the card's machine has no scikit-learn, and a
score reads host predictions anyway."""

from dask_ml_tpu_torch.ops.pairwise import (
    check_pairwise_arrays,
    euclidean_distances,
    linear_kernel,
    pairwise_distances,
    pairwise_distances_argmin_min,
    pairwise_kernels,
    polynomial_kernel,
    rbf_kernel,
    sigmoid_kernel,
)
from dask_ml_tpu_torch.metrics.classification import accuracy_score, log_loss
from dask_ml_tpu_torch.metrics.regression import (
    mean_absolute_error,
    mean_squared_error,
    r2_score,
)
from dask_ml_tpu_torch.metrics.scorer import (
    SCORERS,
    check_scoring,
    get_scorer,
    make_scorer,
)

__all__ = ["check_pairwise_arrays", "euclidean_distances", "linear_kernel",
           "pairwise_distances", "pairwise_distances_argmin_min",
           "pairwise_kernels", "polynomial_kernel", "rbf_kernel",
           "sigmoid_kernel",
           "accuracy_score", "log_loss", "mean_absolute_error",
           "mean_squared_error", "r2_score", "SCORERS", "check_scoring",
           "get_scorer", "make_scorer"]

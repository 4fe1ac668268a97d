"""Metrics of the PyTorch port (the part of ``dask_ml_tpu/metrics`` the GLM
facades' ``score`` needs), in numpy: the card's machine has no
scikit-learn, and a score reads host predictions anyway."""

from dask_ml_tpu_torch.metrics.classification import accuracy_score
from dask_ml_tpu_torch.metrics.regression import (
    mean_absolute_error,
    mean_squared_error,
    r2_score,
)

__all__ = ["accuracy_score", "mean_absolute_error", "mean_squared_error",
           "r2_score"]

"""Metrics of the PyTorch port (the part of ``dask_ml_tpu/metrics`` the GLM
facades' ``score`` and the scorers need), in numpy: the card's machine has
no scikit-learn, and a score reads host predictions anyway."""

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

__all__ = ["accuracy_score", "log_loss", "mean_absolute_error",
           "mean_squared_error", "r2_score", "SCORERS", "check_scoring",
           "get_scorer", "make_scorer"]

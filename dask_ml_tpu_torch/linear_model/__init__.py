"""Generalized linear models of the PyTorch port."""

from dask_ml_tpu_torch.linear_model.glm import (
    LinearRegression,
    LogisticRegression,
    PoissonRegression,
)

__all__ = ["LinearRegression", "LogisticRegression", "PoissonRegression"]

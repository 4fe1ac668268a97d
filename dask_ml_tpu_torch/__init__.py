"""PyTorch/CUDA port of dask_ml_tpu.

A second package beside ``dask_ml_tpu`` (the JAX reference, which it never
imports). The same estimators and numerical contracts, in PyTorch idiom,
with every TPU kernel on a ported path rewritten as a hand-written CUDA
kernel for Hopper (``_kernels/csrc``). Entry points run on the card unless
the caller asks for the CPU (``config_context(device="cpu")``).

Public subpackages so far:

- :mod:`dask_ml_tpu_torch.cluster` — KMeans (full, bounded, sketched)
- :mod:`dask_ml_tpu_torch.linear_model` — LogisticRegression,
  LinearRegression, PoissonRegression over gradient descent, Newton,
  L-BFGS and proximal gradient, on dense or sparse (blocked-ELL) input
- :mod:`dask_ml_tpu_torch.metrics` — accuracy, MSE, MAE, R²
- :mod:`dask_ml_tpu_torch.datasets` — the sparse classification generator
- :mod:`dask_ml_tpu_torch.convert` — fitted JAX models into port estimators
"""

from dask_ml_tpu_torch.config import config_context, get_config, set_config

__all__ = ["config_context", "get_config", "set_config"]
__version__ = "0.1.0"

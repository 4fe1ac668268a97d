"""PyTorch/CUDA port of dask_ml_tpu.

A second package beside ``dask_ml_tpu`` (the JAX reference, which it never
imports). The same estimators and numerical contracts, in PyTorch idiom,
with every TPU kernel on a ported path rewritten as a hand-written CUDA
kernel for Hopper (``_kernels/csrc``). Entry points run on the card unless
the caller asks for the CPU (``config_context(device="cpu")``).

Public subpackages so far:

- :mod:`dask_ml_tpu_torch.cluster` — KMeans (full, bounded, sketched)
- :mod:`dask_ml_tpu_torch.linear_model` — LogisticRegression (binary,
  OVR and multinomial), LinearRegression, PoissonRegression over ADMM,
  gradient descent, Newton, L-BFGS and proximal gradient, on dense or
  sparse (blocked-ELL) input
- :mod:`dask_ml_tpu_torch.decomposition` — PCA and TruncatedSVD over the
  tsqr and randomized SVDs of :mod:`dask_ml_tpu_torch.ops.linalg`
- :mod:`dask_ml_tpu_torch.wrappers` — ``ParallelPostFit``, ``Incremental``
  and the functional ``fit`` / ``incremental_scan`` (streaming
  ``partial_fit``); the deprecated ``Partial*`` estimators (host,
  scikit-learn) in ``linear_model``, ``naive_bayes`` and
  ``neural_network``
- :mod:`dask_ml_tpu_torch.metrics` — the pairwise distances and kernels
  (``pairwise_distances_argmin_min`` on the fused argmin kernel),
  accuracy, log loss, MSE, MAE, R² and the scorers
- :mod:`dask_ml_tpu_torch.model_selection` — ``GridSearchCV`` and
  ``RandomizedSearchCV`` (shared pipeline prefixes, batched candidates),
  the CV splitters and ``train_test_split``
- :mod:`dask_ml_tpu_torch.preprocessing` — ``StandardScaler``
- :mod:`dask_ml_tpu_torch.pipeline` — ``Pipeline``, ``FeatureUnion``,
  ``make_pipeline``
- :mod:`dask_ml_tpu_torch.datasets` — the sparse classification generator
- :mod:`dask_ml_tpu_torch.convert` — fitted JAX models into port estimators
  (KMeans, the GLMs, PCA, TruncatedSVD)
"""

from dask_ml_tpu_torch.config import config_context, get_config, set_config

__all__ = ["config_context", "get_config", "set_config"]
__version__ = "0.1.0"

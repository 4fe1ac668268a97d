"""PyTorch/CUDA port of dask_ml_tpu.

A second package beside ``dask_ml_tpu`` (the JAX reference, which it never
imports). The same estimators and numerical contracts, in PyTorch idiom,
with every TPU kernel on a ported path rewritten as a hand-written CUDA
kernel for Hopper (``_kernels/csrc``). Entry points run on the card unless
the caller asks for the CPU (``config_context(device="cpu")``).

Public subpackages:

- :mod:`dask_ml_tpu_torch.cluster` — KMeans (full, bounded, sketched),
  MiniBatchKMeans, the k-means module functions, SpectralClustering and
  KernelKMeans
- :mod:`dask_ml_tpu_torch.linear_model` — LogisticRegression (binary,
  OVR and multinomial), LinearRegression, PoissonRegression over ADMM,
  gradient descent, Newton, L-BFGS and proximal gradient, on dense or
  sparse (blocked-ELL) input
- :mod:`dask_ml_tpu_torch.decomposition` — PCA and TruncatedSVD over the
  tsqr and randomized SVDs of :mod:`dask_ml_tpu_torch.ops.linalg`,
  streamed as well
- :mod:`dask_ml_tpu_torch.naive_bayes` — GaussianNB and ``logsumexp``
- :mod:`dask_ml_tpu_torch.wrappers` — ``ParallelPostFit`` (with
  ``serving=``), ``Incremental`` and the functional ``fit`` /
  ``incremental_scan``; the deprecated ``Partial*`` estimators (host,
  scikit-learn) in ``linear_model``, ``naive_bayes`` and
  ``neural_network``
- :mod:`dask_ml_tpu_torch.metrics` — the pairwise distances and kernels
  (``pairwise_distances_argmin_min`` on the fused argmin kernel),
  the classification and regression metrics and the scorers
- :mod:`dask_ml_tpu_torch.model_selection` — ``GridSearchCV`` and
  ``RandomizedSearchCV`` (shared pipeline prefixes, batched candidates),
  ``SuccessiveHalvingSearchCV`` and ``HyperbandSearchCV``, the CV
  splitters and ``train_test_split``
- :mod:`dask_ml_tpu_torch.preprocessing` — the scalers (dense and
  sparse), ``QuantileTransformer``, the encoders and ``LabelEncoder``
- :mod:`dask_ml_tpu_torch.pipeline` — ``Pipeline``, ``FeatureUnion``,
  ``make_pipeline``
- :mod:`dask_ml_tpu_torch.datasets` — the dense and sparse generators
- :mod:`dask_ml_tpu_torch.checkpoint` — the JAX package's checkpoint
  frames, readable by either package
- :mod:`dask_ml_tpu_torch.interop` (and the ``joblib`` / ``xgboost`` /
  ``tensorflow`` shims) — staged data and fitted state as host arrays
- :mod:`dask_ml_tpu_torch.convert` — fitted JAX models into port
  estimators

Internal layers:

- :mod:`dask_ml_tpu_torch.parallel` — staging, streaming and faults, the
  precision policy, telemetry, and the serving tiers: the in-process
  ``ServingLoop`` / ``ServingFleet``, the typed wire (``FleetServer`` /
  ``FleetClient``, TCP and shared-memory rings), the process fleet
  (``ProcessFleet``) on one box or across a roster of machines with
  chunk-addressed snapshots and the SLO ``Autoscaler``
- :mod:`dask_ml_tpu_torch.ops` — the fused distance and sparse kernels'
  wrappers, pairwise ops and linear algebra
- :mod:`dask_ml_tpu_torch.models` — the functional model cores

``dask_ml_tpu_torch._entry.entry()`` returns the flagship forward step
(the KMeans assignment) with example tensors.
"""

from dask_ml_tpu_torch.config import config_context, get_config, set_config

__all__ = [
    "checkpoint",
    "config",
    "config_context",
    "get_config",
    "set_config",
    "cluster",
    "decomposition",
    "linear_model",
    "metrics",
    "model_selection",
    "naive_bayes",
    "preprocessing",
    "wrappers",
    "datasets",
    "parallel",
    "ops",
    "utils",
]
__version__ = "0.1.0"

"""The port's entry point: the flagship forward step with example inputs
(the counterpart of ``__graft_entry__.entry``).

``entry()`` returns ``(fn, args)``: the KMeans assignment step
(``models.kmeans.predict_labels``: K2, the fused distance kernel with its
argmin epilogue, on the card) and example tensors for it, made from a
seed on the configured device (the card unless the caller asks for the
CPU). ``fn(*args)`` gives the (1024,) int32 labels.
"""

from __future__ import annotations

import numpy as np

__all__ = ["entry"]


def entry(device=None):
    """The KMeans assignment step and its example inputs (1,024 rows of
    32 features, 8 centers), on ``device`` (default: the configured
    device)."""
    import torch

    from dask_ml_tpu_torch.config import resolve_device
    from dask_ml_tpu_torch.models.kmeans import predict_labels

    dev = resolve_device(device)
    X = torch.as_tensor(np.random.RandomState(0).randn(1024, 32)
                        .astype(np.float32), device=dev)
    centers = torch.as_tensor(np.random.RandomState(1).randn(8, 32)
                              .astype(np.float32), device=dev)
    return predict_labels, (X, centers)

"""Single-device staging (counterpart of ``dask_ml_tpu/parallel/sharding.py``).

The JAX package pads the sample axis to a mesh multiple and a shape bucket
so that XLA compiles one program per bucket. Eager PyTorch on one card has
nothing to recompile and no mesh to divide by, so staging here is one
host→device copy with no padding: ``n_padded == n``. The weight vector
keeps the reference's contract all the same — a row that carries weight 0
contributes nothing to sums, counts or inertia.

Sparse input stages as a :class:`~dask_ml_tpu_torch.ops.sparse.SparseRows`
container: one copy of ``values`` (f32) and one of ``cols`` (int32),
contiguous, with neither row nor slot padding.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from dask_ml_tpu_torch.config import get_config, resolve_device
from dask_ml_tpu_torch.ops.sparse import SparseRows, ell_from_csr


@dataclasses.dataclass
class DeviceData:
    """A dataset staged onto the configured device."""

    X: object  # (n, d) float32 tensor, contiguous, or a SparseRows
    weights: torch.Tensor  # (n,) float32
    n: int  # true number of rows
    n_features: int
    y: torch.Tensor = None  # (n,) float32 targets, when given


def is_sparse_input(x) -> bool:
    """True for inputs that stage through the sparse path: a scipy sparse
    matrix or a :class:`SparseRows` container (host or device)."""
    if isinstance(x, SparseRows):
        return True
    import scipy.sparse

    return scipy.sparse.issparse(x)


def _stage_sparse(X, dev) -> SparseRows:
    A = X if isinstance(X, SparseRows) else ell_from_csr(X)
    values = torch.as_tensor(A.values).to(device=dev, dtype=torch.float32)
    cols = torch.as_tensor(A.cols).to(device=dev, dtype=torch.int32)
    return SparseRows(values.contiguous(), cols.contiguous(), A.d)


def _stage_vector(a, n: int, dev, what: str) -> torch.Tensor:
    t = (a if isinstance(a, torch.Tensor)
         else torch.as_tensor(np.asarray(a, dtype=np.float32)))
    if tuple(t.shape) != (n,):
        raise ValueError(f"{what} shape {tuple(t.shape)} != ({n},)")
    return t.to(device=dev, dtype=torch.float32).contiguous()


def prepare_data(X, sample_weight=None, device=None, y=None) -> DeviceData:
    """Stage a validated ``X`` (numpy, tensor, scipy CSR or
    :class:`SparseRows`, float32), its ``sample_weight`` (default 1 per
    row) and its targets ``y`` onto ``device`` (default: the configured
    one) as contiguous float32 tensors."""
    dev = resolve_device(device)
    if is_sparse_input(X):
        Xt = _stage_sparse(X, dev)
    else:
        dtype = get_config()["dtype"] or torch.float32
        Xt = torch.as_tensor(X).to(device=dev, dtype=dtype).contiguous()
    n, d = int(Xt.shape[0]), int(Xt.shape[1])
    if sample_weight is None:
        w = torch.ones(n, dtype=torch.float32, device=dev)
    else:
        w = _stage_vector(sample_weight, n, dev, "sample_weight")
    yt = None if y is None else _stage_vector(y, n, dev, "y")
    return DeviceData(X=Xt, weights=w, n=n, n_features=d, y=yt)


def unpad_rows(x, n_valid: int):
    """Drop padding rows from a per-row result (labels, transforms) or a
    container (both leaves)."""
    return x[:n_valid]

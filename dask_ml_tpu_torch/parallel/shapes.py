"""Shape buckets of the PyTorch port (the part of
``dask_ml_tpu/parallel/shapes.py`` that the sparse container and the
streamed blocks need).

Eager PyTorch compiles nothing per shape, so the port pads no rows for
compiles. It keeps the ELL slot width: :func:`bucket_nnz` gives
``ell_from_csr`` the same default width as the JAX package, so a
container built from the same CSR matches it slot for slot. And
:func:`pad_tail` pads a streamed source's short last block to the common
block shape, as the JAX package does, so both packages see the same
blocks.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np


def bucket_nnz(k: int, min_slots: int = 1) -> int:
    """Padded per-row nonzero budget for an ELL width of ``k`` true slots:
    the next power of two (at most 2x slot waste), floored at
    ``min_slots``. A padded slot carries ``value=0`` at ``col=0`` and adds
    exactly 0.0 to every contraction."""
    k = int(k)
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    target = max(k, 1)
    return max(1 << (target - 1).bit_length(), max(int(min_slots), 1))


def pad_tail(arrays: Sequence, rows: int) -> tuple:
    """Zero-pad every array of a host block tuple along axis 0 up to
    ``rows``; a :class:`~dask_ml_tpu_torch.ops.sparse.SparseRows` element
    pads both of its leaves (padded rows hold value 0 at column 0).

    Zero is the right fill only under the weight contract: the consuming
    solvers carry a per-row weight array in the block ((X, w) for the
    moments, (X, y, w) for the GLMs), and a padded weight row is weight 0,
    inert in every weighted reduction."""
    from dask_ml_tpu_torch.ops.sparse import SparseRows

    def pad_one(a):
        a = np.asarray(a)
        if a.shape[0] > rows:
            raise ValueError(
                f"block has {a.shape[0]} rows, more than the target {rows}")
        if a.shape[0] < rows:
            pad = np.zeros((rows - a.shape[0],) + a.shape[1:], a.dtype)
            a = np.concatenate([a, pad], axis=0)
        return a

    return tuple(SparseRows(pad_one(a.values), pad_one(a.cols), a.d)
                 if isinstance(a, SparseRows) else pad_one(a)
                 for a in arrays)

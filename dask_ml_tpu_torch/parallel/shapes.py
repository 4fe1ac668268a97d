"""Shape buckets of the PyTorch port (the part of
``dask_ml_tpu/parallel/shapes.py`` that the sparse container needs).

Eager PyTorch compiles nothing per shape, so the port pads no rows. The
one bucket it keeps is the ELL slot width: :func:`bucket_nnz` gives
``ell_from_csr`` the same default width as the JAX package, so a
container built from the same CSR matches it slot for slot.
"""

from __future__ import annotations


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

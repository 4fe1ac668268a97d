"""Synthetic datasets of the PyTorch port (counterpart of the sparse part of
``dask_ml_tpu/datasets.py``), in numpy.

:func:`make_sparse_classification` is the JAX package's generator, copied:
each row draws its content from a counter-seeded chunk
(``np.random.default_rng([seed, 1, chunk_id])``), so the port rebuilds
bit for bit the rows the JAX package makes from the same seed, whatever
the blocking.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from dask_ml_tpu_torch.ops.sparse import SparseRows


class SparseClassificationBlocks:
    """Block-wise view of a :func:`make_sparse_classification` problem:
    ``blocks(b)`` makes only block ``b`` as host ``(SparseRows, y, w)``;
    :meth:`materialize` writes every row into arrays allocated once.

    Row ``i`` comes from the fixed-size seeding chunk that holds it, so it
    is the same whatever the blocking, in any process."""

    #: rows per seeding chunk — the blocking-independent generation unit
    CHUNK = 4096

    def __init__(self, n_samples, n_features, k, coef, seed, n_blocks):
        self.n_samples = int(n_samples)
        self.n_features = int(n_features)
        self.k = int(k)
        self.coef = coef
        self.seed = int(seed)
        self.n_blocks = int(n_blocks)
        self.block_rows = -(-self.n_samples // self.n_blocks)

    def _chunk(self, cid: int):
        """One seeding chunk: (cols, vals, y) for rows
        ``[cid*CHUNK, min((cid+1)*CHUNK, n))``."""
        rows = min(self.CHUNK, self.n_samples - cid * self.CHUNK)
        rng = np.random.default_rng([self.seed, 1, int(cid)])
        cols = rng.integers(0, self.n_features, size=(rows, self.k),
                            dtype=np.int32)
        vals = rng.standard_normal((rows, self.k), dtype=np.float32)
        eta = (vals * self.coef[cols]).sum(axis=1)
        y = (rng.random(rows) < 1.0 / (1.0 + np.exp(-eta))).astype(
            np.float32)
        return cols, vals, y

    def _fill(self, start: int, stop: int, vals, cols, y) -> None:
        """Write rows ``[start, stop)`` into the given arrays (row 0 of
        each array is row ``start``)."""
        for cid in range(start // self.CHUNK, -(-stop // self.CHUNK)):
            c0 = cid * self.CHUNK
            c, v, t = self._chunk(cid)
            lo, hi = max(start - c0, 0), min(stop - c0, c.shape[0])
            at = c0 + lo - start
            cols[at:at + hi - lo] = c[lo:hi]
            vals[at:at + hi - lo] = v[lo:hi]
            y[at:at + hi - lo] = t[lo:hi]

    def _rows(self, start: int, stop: int):
        n = stop - start
        vals = np.empty((n, self.k), np.float32)
        cols = np.empty((n, self.k), np.int32)
        y = np.empty(n, np.float32)
        self._fill(start, stop, vals, cols, y)
        return (SparseRows(vals, cols, self.n_features), y,
                np.ones(n, np.float32))

    def __call__(self, b: int):
        if not 0 <= b < self.n_blocks:
            raise IndexError(f"block {b} out of range [0, {self.n_blocks})")
        start = b * self.block_rows
        return self._rows(start, min(start + self.block_rows,
                                     self.n_samples))

    def materialize(self):
        """Every row as ``(SparseRows, y, w)`` in arrays allocated once:
        the host holds one copy of the container (8 GB for the 1e7 × 1e5,
        100-nonzero flagship) and no list of chunks to concatenate."""
        return self._rows(0, self.n_samples)


def make_sparse_classification(
    n_samples: int = 100,
    n_features: int = 1000,
    density: float = 0.01,
    n_informative: Optional[int] = None,
    random_state: int = 0,
    n_blocks: Optional[int] = None,
    return_coef: bool = False,
):
    """Binary classification with a sparse design: each row holds exactly
    ``k = round(density * n_features)`` nonzeros (uniform column draws,
    N(0,1) values, duplicates legal and summing), labels from a logistic
    link over a coefficient vector with ``n_informative`` (default d/10)
    nonzero entries.

    Returns ``(X, y)`` with ``X`` a host :class:`SparseRows`, or with
    ``n_blocks=`` a :class:`SparseClassificationBlocks` loader that makes
    blocks on demand. ``random_state`` must be an integer seed."""
    if not isinstance(random_state, (int, np.integer)):
        raise TypeError(
            "make_sparse_classification requires an INTEGER random_state: "
            "blocks regenerate from counter-based seeds so any process "
            "can rebuild any block bit-identically")
    seed = int(random_state)
    d = int(n_features)
    k = max(1, int(round(float(density) * d)))
    if n_informative is None:
        n_informative = max(1, d // 10)
    rng = np.random.default_rng([seed, 0])
    idx = rng.choice(d, size=min(int(n_informative), d), replace=False)
    coef = np.zeros(d, np.float32)
    coef[idx] = rng.standard_normal(len(idx), dtype=np.float32)
    blocks = SparseClassificationBlocks(n_samples, d, k, coef, seed,
                                        n_blocks or 1)
    if n_blocks is not None:
        return (blocks, coef) if return_coef else blocks
    X, y, _ = blocks.materialize()
    return (X, y, coef) if return_coef else (X, y)

"""The seeded block plan of the PyTorch port (the ``BlockPlan`` of
``dask_ml_tpu/parallel/elastic.py``, its epoch orders copied: numpy
only).

The rest of the JAX module (``ElasticRun``, the multi-host roster and
re-deals) comes with the multi-device port, ROADMAP Queue A item 10.
"""

from __future__ import annotations

import numpy as np


class BlockPlan:
    """Deterministic, seeded cross-epoch block permutation.

    ``epoch_order(e)`` is a permutation of ``range(n_blocks)`` drawn from
    ``np.random.RandomState([seed, e])``: a pure function of (seed,
    epoch), the JAX package's permutation for the same pair, so every
    resume derives the same order. ``shuffle=False`` keeps block-id
    order. (The JAX class's ``shard`` / ``redeal``, which deal blocks over
    a multi-host roster, come with ROADMAP Queue A item 10.)
    """

    def __init__(self, n_blocks: int, *, seed: int = 0,
                 shuffle: bool = True):
        if int(n_blocks) < 1:
            raise ValueError("n_blocks must be a positive integer")
        self.n_blocks = int(n_blocks)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)

    def epoch_order(self, epoch: int) -> list:
        if not self.shuffle:
            return list(range(self.n_blocks))
        rs = np.random.RandomState(
            np.array([self.seed & 0xFFFFFFFF, int(epoch) & 0xFFFFFFFF],
                     dtype=np.uint32))
        return [int(b) for b in rs.permutation(self.n_blocks)]

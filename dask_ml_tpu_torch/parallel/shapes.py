"""Shape buckets and compile counts of the PyTorch port (the counterpart
of ``dask_ml_tpu/parallel/shapes.py``).

Eager PyTorch compiles nothing per shape, so the estimators' staging pads
no rows for compiles. What stays:

- :class:`PadPolicy` maps a row count to a small set of padded bucket
  sizes; the serving loop pads each micro-batch to one
  (``parallel/serving.py``), so its batches come in a handful of shapes.
  :func:`active_policy` resolves the ``pad_policy`` config knob and
  :func:`bucket_rows` rounds a row count under it, as the JAX package's
  do; the port's staging calls neither (it pads no rows), so the knob
  changes no fit.
- :func:`enable_persistent_cache` is the ``compilation_cache`` knob's
  setter. The port has no XLA cache: the kernels' nvcc builds already
  persist in ``_kernels/_build``, so the knob only records a directory.
- :func:`bucket_nnz` gives ``ell_from_csr`` the JAX package's default ELL
  width, so a container built from the same CSR matches it slot for slot,
  and :func:`pad_tail` pads a streamed source's short last block to the
  common block shape, as the JAX package does.
- :func:`compile_stats` / :func:`reset_compile_stats` /
  :func:`track_compiles` count what compiling means here: an ``nvcc``
  build of a kernel source (``n_compiles``, ``compile_seconds``) and a
  first load of a kernel library into the process (``n_loads``,
  ``load_seconds``), read from ``_kernels/build.py``'s ``builds``. A
  serving loop after its warmup must add neither.
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import os
import threading
from typing import Optional, Sequence, Union

import numpy as np


@dataclasses.dataclass(frozen=True)
class PadPolicy:
    """Maps row counts to a small set of padded bucket sizes.

    ``waste_cap`` bounds the relative padding: the bucket quantum is the
    largest power of two ``q <= waste_cap * n``, so
    ``(bucket(n) - n) / n < waste_cap`` (plus at most one alignment
    round-up) and consecutive buckets grow by at most ``1 + waste_cap``.
    ``min_rows`` is the smallest bucket: every ``n <= min_rows`` pads to
    it."""

    waste_cap: float = 0.125
    min_rows: int = 64

    def __post_init__(self):
        if not 0.0 < self.waste_cap <= 1.0:
            raise ValueError(
                f"waste_cap must be in (0, 1], got {self.waste_cap}")
        if self.min_rows < 1:
            raise ValueError(f"min_rows must be >= 1, got {self.min_rows}")

    def bucket(self, n: int, align: int = 1) -> int:
        """The padded row count for ``n`` true rows: the smallest bucket
        ``>= max(n, min_rows)``, rounded up to a multiple of ``align``."""
        n = int(n)
        if n < 0:
            raise ValueError(f"n must be >= 0, got {n}")
        target = max(n, self.min_rows, 1)
        q = 1 << max(int(math.floor(
            math.log2(max(target * self.waste_cap, 1.0)))), 0)
        b = -(-target // q) * q
        align = max(int(align), 1)
        return -(-b // align) * align

    def signature(self) -> tuple:
        """Hashable identity for staging-memo keys."""
        return ("PadPolicy", self.waste_cap, self.min_rows)


DEFAULT_POLICY = PadPolicy()


def active_policy() -> Optional[PadPolicy]:
    """The policy the ``pad_policy`` config knob names: ``"auto"`` (the
    default) → :data:`DEFAULT_POLICY`, ``None`` → no bucketing, a
    :class:`PadPolicy` → itself."""
    from dask_ml_tpu_torch.config import get_config

    knob = get_config()["pad_policy"]
    if knob is None:
        return None
    if knob == "auto":
        return DEFAULT_POLICY
    if isinstance(knob, PadPolicy):
        return knob
    raise ValueError(
        f"pad_policy must be 'auto', None, or a PadPolicy; got {knob!r}")


def bucket_rows(n: int, align: int = 1,
                policy: Union[PadPolicy, None, str] = "active",
                record: bool = True) -> int:
    """Padded row count for ``n`` under ``policy`` (default: the active
    config policy); with no policy, ``n`` rounded up to a multiple of
    ``align``. The JAX package's rounding, bit for bit (the port pads to
    it over a mesh of more than one shard only). ``record`` is accepted
    for its signature: the port keeps no table of staged buckets."""
    del record
    if policy == "active":
        policy = active_policy()
    if policy is None:
        align = max(int(align), 1)
        return -(-int(n) // align) * align
    return policy.bucket(n, align=align)


# ---------------------------------------------------------------------------
# compile counts: nvcc builds and kernel library loads
# ---------------------------------------------------------------------------

_STAT_KEYS = (("n_compiles", "nvcc"), ("compile_seconds", "nvcc_seconds"),
              ("n_loads", "loads"), ("load_seconds", "load_seconds"))
_stats_lock = threading.Lock()
_base = {key: 0 for key, _ in _STAT_KEYS}


def _totals() -> dict:
    from dask_ml_tpu_torch._kernels import build

    with build._builds_lock:
        out = {key: build.builds[src] for key, src in _STAT_KEYS}
        # the host C builds (the wire's CRC-32C engine) are compiles too
        out["n_compiles"] += build.builds["cc"]
        out["compile_seconds"] += build.builds["cc_seconds"]
        return out


def compile_stats() -> dict:
    """Counts since the last :func:`reset_compile_stats`, process-wide:
    ``n_compiles`` / ``compile_seconds`` — ``nvcc`` builds of kernel
    sources (and ``cc`` builds of the host C libraries) and their wall
    seconds; ``n_loads`` / ``load_seconds`` —
    kernel libraries loaded into the process and the seconds of those
    loads."""
    totals = _totals()
    with _stats_lock:
        return {k: totals[k] - _base[k] for k, _ in _STAT_KEYS}


def reset_compile_stats() -> dict:
    """Zero the counts; returns the snapshot before the reset."""
    totals = _totals()
    with _stats_lock:
        out = {k: totals[k] - _base[k] for k, _ in _STAT_KEYS}
        _base.update(totals)
    return out


@contextlib.contextmanager
def track_compiles():
    """``with track_compiles() as t: ...`` leaves in ``t`` the counts
    accumulated inside the scope (process-wide: builds and loads from
    other threads land in the same delta). The global counts are not
    reset."""
    before = _totals()
    delta: dict = {}
    try:
        yield delta
    finally:
        after = _totals()
        for k, _ in _STAT_KEYS:
            delta[k] = after[k] - before[k]


def bucket_nnz(k: int, min_slots: int = 1, record: bool = True) -> int:
    """Padded per-row nonzero budget for an ELL width of ``k`` true slots:
    the next power of two (at most 2x slot waste), floored at
    ``min_slots``. A padded slot carries ``value=0`` at ``col=0`` and adds
    exactly 0.0 to every contraction. ``record`` as in
    :func:`bucket_rows`."""
    del record
    k = int(k)
    if k < 0:
        raise ValueError(f"k must be >= 0, got {k}")
    target = max(k, 1)
    return max(1 << (target - 1).bit_length(), max(int(min_slots), 1))


def bucket_cols(d: int, align: int = 1, record: bool = True) -> int:
    """Padded feature count for ``d`` true columns on a mesh whose model
    axis has ``align`` shards: ``d`` rounded up to a multiple of
    ``align``, without the row policy's bucketing (fitted state follows
    the padded width). ``record`` as in :func:`bucket_rows`."""
    del record
    align = max(int(align), 1)
    return -(-int(d) // align) * align


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


def enable_persistent_cache(path: Optional[str]) -> None:
    """The setter of the ``compilation_cache`` knob. The JAX package points
    XLA's persistent compilation cache at ``path``; the port compiles no
    program per shape, and its kernel builds persist in ``_kernels/_build``
    whatever the knob says, so here the directory is only created (``~``
    expanded). ``None`` turns the knob off."""
    if path is not None:
        os.makedirs(os.path.expanduser(str(path)), exist_ok=True)

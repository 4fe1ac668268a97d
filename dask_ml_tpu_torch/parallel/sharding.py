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

Inside a :func:`staging_memo` scope (the search driver's), repeated
stagings of the same source object return the staged copy, and device
tensors marked trusted skip the NaN/inf scan in ``check_array``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import threading
from typing import Optional

import numpy as np
import torch

from dask_ml_tpu_torch.config import get_config, resolve_device
from dask_ml_tpu_torch.ops.sparse import SparseRows, ell_from_csr


class StagingMemo:
    """Scoped host→device staging cache (the JAX package's ``StagingMemo``).

    Estimators stage their own inputs inside ``fit``, which, uncached,
    re-uploads the same CV slice once per candidate×split cell of a
    search. Inside a ``with staging_memo():`` scope, :func:`prepare_data`
    and ``check_array`` memoize on the *identity* of the source object
    (plus the device and the content of ``y`` and ``sample_weight``), so
    a search pays one transfer per distinct (slice, role).

    Identity keying is safe only because the scope holds strong references
    to every source object (no id reuse) and search CV slices are not
    written to; that is why the cache is scoped, not global.

    :meth:`trust` marks a device tensor as validated (NaN/inf-scanned
    once, or derived from validated input): ``check_array`` skips its
    scan, a host read, within the scope.
    """

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict = {}
        self._trusted: dict = {}  # id -> strong ref
        self.hits = 0

    def trust(self, t):
        with self._lock:
            self._trusted[id(t)] = t
        return t

    def is_trusted(self, t) -> bool:
        with self._lock:
            return id(t) in self._trusted

    def get_or_stage(self, key, refs, compute):
        with self._lock:
            if key in self._entries:
                self.hits += 1
                return self._entries[key][1]
        # staging runs outside the lock; a racing duplicate is benign —
        # the first stored value wins and both callers get it
        value = compute()
        with self._lock:
            self._entries.setdefault(key, (refs, value))
            return self._entries[key][1]

    @property
    def n_stagings(self) -> int:
        return len(self._entries)


_memo_stack: list = []
_memo_lock = threading.Lock()


@contextlib.contextmanager
def staging_memo():
    """Enable staging memoization for the dynamic scope (see
    :class:`StagingMemo`). The scope is process-wide, so the search's
    worker threads share it."""
    memo = StagingMemo()
    with _memo_lock:
        _memo_stack.append(memo)
    try:
        yield memo
    finally:
        with _memo_lock:
            _memo_stack.remove(memo)


def _current_memo() -> Optional[StagingMemo]:
    return _memo_stack[-1] if _memo_stack else None


def _content_key(a) -> Optional[str]:
    """Content key for small per-row vectors (y, sample_weight): estimators
    re-encode y on every fit, so identity keying would miss."""
    if a is None:
        return None
    if isinstance(a, torch.Tensor):
        return f"id:{id(a)}"
    arr = np.ascontiguousarray(np.asarray(a))
    if arr.dtype == object:
        return f"id:{id(a)}"
    h = hashlib.sha256(arr.tobytes()).hexdigest()[:24]
    return f"{arr.shape}:{arr.dtype}:{h}"


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
    one) as contiguous float32 tensors. Inside a :func:`staging_memo`
    scope a repeated call on the same objects returns the staged tensors
    (in a fresh ``DeviceData``: callers replace its fields)."""
    dev = resolve_device(device)
    memo = _current_memo()
    if memo is not None:
        key = ("data", id(X), str(dev), _content_key(y),
               _content_key(sample_weight))
        return dataclasses.replace(memo.get_or_stage(
            key, (X, y, sample_weight),
            lambda: _prepare_data_impl(X, sample_weight, dev, y)))
    return _prepare_data_impl(X, sample_weight, dev, y)


def _prepare_data_impl(X, sample_weight, dev, y) -> DeviceData:
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

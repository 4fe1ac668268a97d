"""Single-device staging (counterpart of ``dask_ml_tpu/parallel/sharding.py``).

The JAX package pads the sample axis to a mesh multiple and a shape bucket
so that XLA compiles one program per bucket. Eager PyTorch on one card has
nothing to recompile and no mesh to divide by, so staging here is one
host→device copy with no padding: ``n_padded == n``. The weight vector
keeps the reference's contract all the same — a row that carries weight 0
contributes nothing to sums, counts or inertia.

Sparse input stages as a :class:`~dask_ml_tpu_torch.ops.sparse.SparseRows`
container: one copy of ``values`` and one of ``cols`` (int32),
contiguous, with neither row nor slot padding.

X (dense, or a container's values) is staged in the explicit ``dtype``
config knob, else in the precision policy's storage dtype
(:func:`~dask_ml_tpu_torch.parallel.precision.staging_wire_dtype`), else
in float32: bf16 under ``precision="bf16"``. Weights and targets are
always float32, and a container's columns int32.

Inside a :func:`staging_memo` scope (the search driver's), repeated
stagings of the same source object return the staged copy, and device
tensors marked trusted skip the NaN/inf scan in ``check_array``.

**On a mesh of more than one data shard** (:mod:`~dask_ml_tpu_torch.
parallel.mesh`, passed as ``prepare_data(mesh=)`` by the callers that
reduce across the shards: KMeans) every rank is handed the same host
``X``, as the JAX single-controller user is. The rows are padded, with weight-0 rows, to
the JAX package's padded count (:func:`_padded_rows`: the shape bucket of
the ``pad_policy`` knob, a multiple of the shard count), and rank ``i``
stages only the ``i``-th equal block of rows: ``DeviceData.X`` is this
rank's block, ``row_offset`` its first row, ``n_padded`` the padded
count. With ``shard_features=True`` on a ``model`` axis the columns are
padded with zeros to a multiple of the model axis and each rank stages
only its column slice as well (the JAX ``shard_2d``). Sparse input over
more than one shard comes with ROADMAP Queue A item 10b.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import logging
import threading
from typing import Optional

import numpy as np
import torch

from dask_ml_tpu_torch.config import resolve_device
from dask_ml_tpu_torch.ops.sparse import SparseRows, ell_from_csr
from dask_ml_tpu_torch.parallel import mesh as mesh_lib
from dask_ml_tpu_torch.utils._log import log_array

logger = logging.getLogger(__name__)


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
    """A dataset staged onto the configured device: on a mesh, this rank's
    block of it."""

    X: object  # (n_loc, d_loc) f32 or bf16 tensor, contiguous, or a SparseRows
    weights: torch.Tensor  # (n_loc,) float32; 0 on padding rows
    n: int  # true number of rows
    n_features: int  # true number of features
    y: torch.Tensor = None  # (n_loc,) float32 targets, when given
    mesh: object = None  # the Mesh it was staged for
    n_padded: int = None  # rows over every shard (n outside a mesh)
    row_offset: int = 0  # this rank's first row
    col_offset: int = 0  # this rank's first column (feature-sharded)

    def __post_init__(self):
        if self.n_padded is None:
            self.n_padded = self.n


def pad_rows(n: int, n_shards: int) -> int:
    """Rows of padding needed to make ``n`` divisible by ``n_shards``."""
    return (-n) % n_shards


def _padded_rows(n: int, mesh) -> int:
    """Padded sample count for ``n`` on ``mesh``: the active policy's shape
    bucket, a multiple of the data-shard count (the JAX package's rule);
    ``n`` on a single shard."""
    from dask_ml_tpu_torch.parallel import shapes

    if not mesh_lib.is_sharded(mesh):
        return int(n)
    return shapes.bucket_rows(n, align=mesh_lib.n_data_shards(mesh))


def _row_block(a, n_padded: int, mesh):
    """This rank's block of rows of ``a`` (numpy or tensor, full length n)
    padded with zero rows to ``n_padded``."""
    rows = mesh_lib.data_sharding(mesh).rows(n_padded)
    n = int(a.shape[0])
    part = a[min(rows.start, n):min(rows.stop, n)]
    short = (rows.stop - rows.start) - int(part.shape[0])
    if short:
        if isinstance(part, torch.Tensor):
            part = torch.cat([part, part.new_zeros((short,)
                                                   + tuple(part.shape[1:]))])
        else:
            part = np.concatenate(
                [part, np.zeros((short,) + part.shape[1:], part.dtype)])
    return part


def _col_block(a, mesh):
    """This rank's column block of ``a`` (rows already taken), the columns
    zero-padded to a multiple of the model axis."""
    m = mesh_lib.n_model_shards(mesh)
    d = int(a.shape[1])
    pad = -(-d // m) * m - d
    if pad:
        if isinstance(a, torch.Tensor):
            a = torch.cat([a, a.new_zeros((a.shape[0], pad))], dim=1)
        else:
            a = np.concatenate([a, np.zeros((a.shape[0], pad), a.dtype)],
                               axis=1)
    return a[:, mesh_lib.feature_sharding(mesh).cols(d + pad)]


def shard_rows(x, mesh=None, dtype=None, device=None):
    """This rank's block of ``x`` padded along axis 0 to the padded row
    count of ``mesh`` (zero rows), on the device; returns ``(block,
    n_valid)``. Mask the padding through :func:`row_weights`."""
    mesh = mesh or mesh_lib.default_mesh()
    dev = resolve_device(device)
    n = int(x.shape[0])
    block = _row_block(x, _padded_rows(n, mesh), mesh)
    return torch.as_tensor(block).to(device=dev, dtype=dtype).contiguous(), n


def row_weights(n_padded: int, n_valid: int, mesh=None, sample_weight=None,
                dtype=torch.float32, device=None) -> torch.Tensor:
    """This rank's block of the per-row weights: ``sample_weight``
    (default 1) on real rows, 0 on padding rows."""
    mesh = mesh or mesh_lib.default_mesh()
    if sample_weight is None:
        w = np.ones(n_valid, dtype=np.float32)
    else:
        w = np.asarray(sample_weight, dtype=np.float32)
        if w.shape != (n_valid,):
            raise ValueError(
                f"sample_weight shape {w.shape} != ({n_valid},)")
    if n_padded > n_valid:
        w = np.concatenate([w, np.zeros(n_padded - n_valid, np.float32)])
    if mesh_lib.is_sharded(mesh):
        w = _row_block(w, n_padded, mesh)
    return torch.as_tensor(w).to(device=resolve_device(device),
                                 dtype=dtype).contiguous()


def shard_2d(x, mesh=None, dtype=None, device=None):
    """This rank's block of an (n, d) array over rows and columns: rows
    padded as :func:`shard_rows`, columns zero-padded to a multiple of the
    model axis. Returns ``(block, n_valid, d_valid)``. Zero columns add
    nothing to products, sums or distances."""
    mesh = mesh or mesh_lib.default_mesh()
    n, d = int(x.shape[0]), int(x.shape[1])
    block = _col_block(_row_block(x, _padded_rows(n, mesh), mesh), mesh)
    dev = resolve_device(device)
    return (torch.as_tensor(block).to(device=dev, dtype=dtype).contiguous(),
            n, d)


def replicate(x, mesh=None, dtype=None, device=None) -> torch.Tensor:
    """Small state (centers, coefficients) placed whole on this rank's
    device: every rank holds the same values."""
    return torch.as_tensor(x).to(device=resolve_device(device),
                                 dtype=dtype).contiguous()


def is_sparse_input(x) -> bool:
    """True for inputs that stage through the sparse path: a scipy sparse
    matrix or a :class:`SparseRows` container (host or device)."""
    if isinstance(x, SparseRows):
        return True
    import scipy.sparse

    return scipy.sparse.issparse(x)


def _stage_sparse(X, dev, dtype) -> SparseRows:
    A = X if isinstance(X, SparseRows) else ell_from_csr(X)
    values = torch.as_tensor(A.values).to(device=dev, dtype=dtype)
    cols = torch.as_tensor(A.cols).to(device=dev, dtype=torch.int32)
    return SparseRows(values.contiguous(), cols.contiguous(), A.d)


def _stage_vector(a, n: int, dev, what: str) -> torch.Tensor:
    t = (a if isinstance(a, torch.Tensor)
         else torch.as_tensor(np.asarray(a, dtype=np.float32)))
    if tuple(t.shape) != (n,):
        raise ValueError(f"{what} shape {tuple(t.shape)} != ({n},)")
    return t.to(device=dev, dtype=torch.float32).contiguous()


def prepare_data(X, sample_weight=None, device=None, y=None, mesh=None,
                 shard_features=None) -> DeviceData:
    """Stage a validated ``X`` (numpy, tensor, scipy CSR or
    :class:`SparseRows`), its ``sample_weight`` (default 1 per row) and
    its targets ``y`` onto ``device`` (default: the configured one) as
    contiguous tensors: X in the staging dtype (see the module
    docstring), weights and targets in float32. A ``mesh`` with more
    than one data shard stages this rank's block only, and
    ``shard_features=True`` on a ``model`` axis its column slice too (a
    no-op on a data-only mesh); see the module docstring. Without
    ``mesh`` the whole data is staged, in a world of ranks too: only a
    caller that reduces across the blocks asks for them. Inside a
    :func:`staging_memo` scope a repeated call on the same objects
    returns the staged tensors (in a fresh ``DeviceData``: callers
    replace its fields); the key holds the staging dtype and the
    policy's ``signature()``."""
    from dask_ml_tpu_torch.parallel import precision

    dev = resolve_device(device)
    dtype = precision.staging_wire_dtype() or torch.float32
    shard_features = (bool(shard_features) and mesh is not None
                      and mesh_lib.has_model_axis(mesh))
    memo = _current_memo()
    if memo is not None:
        key = ("data", id(X), str(dev), _content_key(y),
               _content_key(sample_weight), str(dtype),
               precision.resolve().signature(), id(mesh), shard_features)
        return dataclasses.replace(memo.get_or_stage(
            key, (X, y, sample_weight, mesh),
            lambda: _prepare_data_impl(X, sample_weight, dev, y, dtype,
                                       mesh, shard_features)))
    return _prepare_data_impl(X, sample_weight, dev, y, dtype, mesh,
                              shard_features)


def _prepare_data_impl(X, sample_weight, dev, y, dtype, mesh,
                       shard_features=False) -> DeviceData:
    if shard_features or mesh_lib.is_sharded(mesh):
        return _prepare_sharded(X, sample_weight, dev, y, dtype, mesh,
                                shard_features)
    if is_sparse_input(X):
        Xt = _stage_sparse(X, dev, dtype)
    else:
        Xt = torch.as_tensor(X).to(device=dev, dtype=dtype).contiguous()
    n, d = int(Xt.shape[0]), int(Xt.shape[1])
    if sample_weight is None:
        w = torch.ones(n, dtype=torch.float32, device=dev)
    else:
        w = _stage_vector(sample_weight, n, dev, "sample_weight")
    yt = None if y is None else _stage_vector(y, n, dev, "y")
    return DeviceData(X=Xt, weights=w, n=n, n_features=d, y=yt, mesh=mesh)


def _prepare_sharded(X, sample_weight, dev, y, dtype, mesh,
                     shard_features) -> DeviceData:
    if is_sparse_input(X):
        raise NotImplementedError(
            "sparse input over a mesh of more than one shard (the JAX "
            "shard_sparse_rows) comes with ROADMAP Queue A item 10b; stage "
            "it on one device")
    n, d = int(X.shape[0]), int(X.shape[1])
    n_pad = _padded_rows(n, mesh)
    lo = mesh_lib.data_sharding(mesh).rows(n_pad).start
    c0 = 0
    if shard_features:
        Xt, _, _ = shard_2d(X, mesh, dtype, device=dev)
        c0 = Xt.shape[1] * mesh_lib.model_index(mesh)
    else:
        Xt, _ = shard_rows(X, mesh, dtype, device=dev)
    sw = (None if sample_weight is None
          else _host_vector(sample_weight, n, "sample_weight"))
    w = row_weights(n_pad, n, mesh, sample_weight=sw, device=dev)
    yt = (None if y is None else shard_rows(
        _host_vector(y, n, "y"), mesh, torch.float32, device=dev)[0])
    log_array(logger, "prepare_data: X", Xt, mesh=mesh,
              rows=(lo, lo + int(Xt.shape[0])))
    return DeviceData(X=Xt, weights=w, n=n, n_features=d, y=yt, mesh=mesh,
                      n_padded=n_pad, row_offset=lo, col_offset=c0)


def _host_vector(a, n: int, what: str) -> np.ndarray:
    """A per-row vector as float32 numpy, checked to be (n,)."""
    if isinstance(a, torch.Tensor):
        a = a.detach().cpu().numpy()
    a = np.asarray(a, dtype=np.float32)
    if a.shape != (n,):
        raise ValueError(f"{what} shape {a.shape} != ({n},)")
    return a


def unpad_rows(x, n_valid: int):
    """Drop padding rows from a per-row result (labels, transforms) or a
    container (both leaves)."""
    return x[:n_valid]

"""Input validation and random-number handling for the PyTorch port
(counterpart of ``dask_ml_tpu/utils/validation.py``).

Validation runs on the host array before staging: the staging layer owns
the one host→device copy. Randomness is an explicit ``torch.Generator`` on
the configured device in place of a ``jax.random`` key. The two generators
give different numbers from the same seed (threefry against Philox), so
tests that compare the port with the JAX package hand both the same numpy
inputs and hold randomized paths to quality and determinism instead.
"""

from __future__ import annotations

import numpy as np
import torch

from dask_ml_tpu_torch.config import resolve_device
from dask_ml_tpu_torch.ops.sparse import SparseRows


def check_array(X, accept_sparse: bool = False):
    """Validate an input and return it as float32, ready to stage.

    Host inputs (numpy, lists) are validated in numpy and returned as a
    host ``np.ndarray``; a ``torch.Tensor`` (a ``device_outputs`` pipeline)
    is validated where it lies and returned as a tensor. Integer, bool and
    float64 inputs are converted to float32; NaN or infinity raises.
    DataFrames are rejected.

    Sparse input (a :class:`SparseRows` container or a scipy CSR matrix)
    is accepted only with ``accept_sparse=True`` — the GLMs take it, the
    dense-only estimators (KMeans) do not. Its column indices must lie in
    ``[0, d)``: the SpMV kernel trusts them. Values are checked for
    finiteness over the stored entries only and cast to float32; CSC and
    other formats are rejected with the conversion to use.

    Inside a staging scope (the search driver's ``staging_memo``) the
    result for one source object is computed once, and a device tensor
    marked trusted there skips the scan, a host read."""
    from dask_ml_tpu_torch.parallel.sharding import _current_memo

    memo = _current_memo()
    if memo is not None:
        return memo.get_or_stage(("check", id(X), bool(accept_sparse)),
                                 (X,), lambda: _check_array_impl(
                                     X, accept_sparse, memo))
    return _check_array_impl(X, accept_sparse, None)


def _check_array_impl(X, accept_sparse: bool, memo):
    if hasattr(X, "iloc"):
        raise TypeError(
            "DataFrame inputs are not supported here; pass .values")
    if isinstance(X, SparseRows) or hasattr(X, "tocsr"):
        if not accept_sparse:
            raise TypeError(
                "sparse input is not supported by this estimator (dense "
                "kernels only); densify with .toarray(). The GLMs accept "
                "SparseRows and scipy CSR")
        return (_check_rows(X) if isinstance(X, SparseRows)
                else _check_csr(X))
    is_tensor = isinstance(X, torch.Tensor)
    arr = X if is_tensor else np.asarray(X)
    if arr.ndim != 2:
        raise ValueError(
            f"Expected 2D array, got {arr.ndim}D array of shape "
            f"{tuple(arr.shape)}")
    _check_samples(arr.shape[0])
    if is_tensor:
        if arr.is_complex():
            raise ValueError(f"Unsupported dtype {arr.dtype}")
        trusted = memo is not None and memo.is_trusted(X)
        arr = arr.to(torch.float32)
        if not trusted and not bool(torch.isfinite(arr).all()):
            raise ValueError("Input contains NaN or infinity")
        return arr
    arr = _float32_host(arr)
    if not bool(np.isfinite(arr).all()):
        raise ValueError("Input contains NaN or infinity")
    return arr


def staging_dtype(np_dtype):
    """The dtype staging converts an input of ``np_dtype`` to, or ``None``
    when it keeps it: ints, uints, bools and float64 → ``torch.float32``
    (as in the JAX package with x64 off), float32 kept. The port stages
    float32 only, so float16 → ``torch.float32`` too, where the JAX
    package keeps it. One definition for every staging path."""
    dt = np.dtype(np_dtype)
    if dt.kind not in "fiub":
        raise ValueError(f"Unsupported dtype {dt}")
    return None if dt == np.float32 else torch.float32


def _check_samples(n: int) -> None:
    if n < 1:
        raise ValueError("Found array with 0 samples; at least 1 is needed")


def _float32_host(arr: np.ndarray) -> np.ndarray:
    return arr if staging_dtype(arr.dtype) is None \
        else arr.astype(np.float32)


def _check_rows(X: SparseRows) -> SparseRows:
    """A container, host or device: index range, value dtype, finiteness,
    each in one pass over its leaf."""
    _check_samples(X.shape[0])
    if isinstance(X.values, torch.Tensor):
        if X.values.is_complex():
            raise ValueError(f"Unsupported dtype {X.values.dtype}")
        vals = X.values.to(torch.float32)
        cols = torch.as_tensor(X.cols).to(torch.int32)
        finite = bool(torch.isfinite(vals).all())
    else:
        vals = _float32_host(np.asarray(X.values))
        cols = np.asarray(X.cols).astype(np.int32, copy=False)
        finite = bool(np.isfinite(vals).all())
    if tuple(cols.shape) != tuple(vals.shape) or vals.ndim != 2:
        raise ValueError(
            f"SparseRows values and cols must share one (n, k) shape; got "
            f"{tuple(vals.shape)} and {tuple(cols.shape)}")
    if vals.shape[1]:
        lo, hi = int(cols.min()), int(cols.max())
        if lo < 0 or hi >= X.d:
            raise ValueError(
                f"SparseRows column indices must lie in [0, {X.d}); found "
                f"range [{lo}, {hi}]")
    if not finite:
        raise ValueError("Input contains NaN or infinity")
    if vals is X.values and cols is X.cols:
        return X
    return SparseRows(vals, cols, X.d)


def _check_csr(X):
    """A scipy sparse matrix: CSR only, indices in range, the stored values
    finite and float32. Returns the CSR matrix (``prepare_data`` encodes
    it)."""
    import scipy.sparse

    if not scipy.sparse.issparse(X):
        raise TypeError(f"Unsupported sparse input {type(X).__name__}")
    if X.format != "csr":
        raise TypeError(
            f"sparse input must be CSR (row-major, the layout the blocked-"
            f"ELL encoding needs); got {X.format.upper()}. Convert with "
            "X.tocsr()")
    _check_samples(X.shape[0])
    if X.indices.size and (int(X.indices.min()) < 0
                           or int(X.indices.max()) >= X.shape[1]):
        raise ValueError(
            f"CSR column indices must lie in [0, {X.shape[1]}); found range "
            f"[{int(X.indices.min())}, {int(X.indices.max())}]")
    data = _float32_host(X.data)
    if not bool(np.isfinite(data).all()):
        raise ValueError("Input contains NaN or infinity")
    if data is X.data:
        return X
    out = X.copy()
    out.data = data
    return out


def svd_flip(u, v, u_based_decision: bool = False):
    """Deterministic SVD signs. The default is v-based, as scikit-learn
    ≥ 1.5's PCA and TruncatedSVD: the largest-|v| entry of each right
    singular vector is made positive; ``u_based_decision=True`` makes the
    largest-|u| entry of each left singular vector positive instead. Ties
    go to the first index; a zero vector is left as it is."""
    if u_based_decision:
        rows = torch.argmax(torch.abs(u), dim=0)
        signs = torch.sign(u[rows, torch.arange(u.shape[1],
                                                device=u.device)])
    else:
        cols = torch.argmax(torch.abs(v), dim=1)
        signs = torch.sign(v[torch.arange(v.shape[0], device=v.device),
                             cols])
    signs = torch.where(signs == 0, 1.0, signs)
    return u * signs[None, :], v * signs[:, None]


def check_random_state(seed=None, device=None) -> torch.Generator:
    """Coerce ``seed`` into a ``torch.Generator`` on the configured device
    (or ``device``): an int seeds it, ``None`` draws a fresh seed, a numpy
    ``RandomState`` supplies one, and a ``torch.Generator`` passes
    through."""
    if isinstance(seed, torch.Generator):
        return seed
    dev = resolve_device(device)
    if seed is None:
        value = int(np.random.SeedSequence().entropy % (2**63))
    elif isinstance(seed, (int, np.integer)):
        value = int(seed)
    elif isinstance(seed, np.random.RandomState):
        value = int(seed.randint(0, 2**31 - 1))
    else:
        raise TypeError(f"Cannot coerce {type(seed)!r} into a torch.Generator")
    g = torch.Generator(device=dev)
    g.manual_seed(value)
    return g


def check_random_state_np(seed=None) -> np.random.RandomState:
    """A numpy ``RandomState`` for host-side draws (landmark rows, the seeds
    handed to inner estimators): a ``RandomState`` passes through, anything
    else seeds a new one, as ``np.random.RandomState(seed)`` does."""
    if isinstance(seed, np.random.RandomState):
        return seed
    return np.random.RandomState(seed)


def row_norms(X, squared: bool = False) -> torch.Tensor:
    """Per-row L2 norms (or their squares) of a 2-D array, as a tensor where
    ``X`` lies (numpy input stays on the CPU)."""
    X = torch.as_tensor(X)
    sq = (X * X).sum(dim=-1)
    return sq if squared else torch.sqrt(sq)

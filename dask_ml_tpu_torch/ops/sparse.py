"""Sparse row matrices of the PyTorch port (counterpart of
``dask_ml_tpu/ops/sparse.py``): the blocked-ELL container and the
contractions the GLM solvers route through.

- :class:`SparseRows` — an (n, d) row matrix as ``values (n, k)`` and
  ``cols (n, k)``; unused slots hold ``(col=0, value=0)``, inert in every
  contraction because the value is 0. Duplicate columns in a row sum.
  The leaves are numpy arrays on the host and tensors once staged.
- :func:`matvec` / :func:`spmv` — ``A @ v``, the sparse linear predictor,
  as a ``torch.autograd.Function``. Its forward is the hand-written CUDA
  kernel ``_kernels/csrc/spmv.cu`` (K6) for CUDA tensors and the plain
  gather + row sum :func:`_spmv_ref` for CPU tensors (or ``kernel="torch"``
  anywhere). Its backward is :func:`pullback` with respect to ``v`` and,
  only when autograd asks for it, the slot-wise product with respect to
  ``values``; ``cols`` gets no gradient.
- :func:`pullback` (``A.T @ r``), :func:`pullback_mat`, :func:`matmat` and
  :func:`weighted_gram` (``A.T @ diag(h) @ A``) in plain PyTorch, as the
  JAX package computes them outside any Pallas kernel.

Products form in f32 and every reduction accumulates in f32 (the port
stages float32 only). On integer-valued data every partial sum is an
exactly representable integer, so the contractions are bit-identical to
the dense products they replace whatever their order. The pullback's
``index_add_`` uses float atomics on CUDA, so on float data it is not
bit-reproducible from run to run there.
"""

from __future__ import annotations

import numpy as np
import torch

from dask_ml_tpu_torch import _kernels

__all__ = [
    "SparseRows",
    "ell_from_csr",
    "ell_from_dense",
    "to_dense",
    "add_intercept_ell",
    "matvec",
    "matmat",
    "pullback",
    "pullback_mat",
    "weighted_gram",
    "spmv",
]


class SparseRows:
    """A sparse (n, d) row matrix in blocked-ELL layout.

    ``values`` and ``cols`` are ``(n, k)``: row ``i`` holds its nonzeros in
    slots ``0..k-1``; unused slots are ``(col=0, value=0)``. ``d`` is the
    true feature count. The container quacks like a 2-D array where the
    solver seams read one (``shape``, ``ndim``, ``dtype``, ``nbytes``)."""

    def __init__(self, values, cols, d: int):
        self.values = values
        self.cols = cols
        self.d = int(d)

    @property
    def shape(self) -> tuple:
        return (int(self.values.shape[0]), self.d)

    @property
    def ndim(self) -> int:
        return 2

    @property
    def dtype(self):
        return self.values.dtype

    @property
    def k(self) -> int:
        """The per-row nonzero budget (the padded ELL width)."""
        return int(self.values.shape[1])

    @property
    def nbytes(self) -> int:
        """Bytes held by the two leaves (not the dense n·d size)."""
        return sum(int(a.nbytes) if isinstance(a, np.ndarray)
                   else a.numel() * a.element_size()
                   for a in (self.values, self.cols))

    def to(self, device) -> "SparseRows":
        """Both leaves as tensors on ``device``."""
        return SparseRows(torch.as_tensor(self.values).to(device),
                          torch.as_tensor(self.cols).to(device), self.d)

    def __getitem__(self, idx):
        """Rows by slice or index array. Scalar indices are rejected: they
        would drop the row axis and leave a container whose shape lies."""
        if isinstance(idx, (int, np.integer)):
            raise TypeError(
                "SparseRows rows are indexed with slices or index arrays "
                f"(got scalar {idx!r}); use A[i:i+1] to keep the row axis")
        return SparseRows(self.values[idx], self.cols[idx], self.d)

    def __repr__(self):
        return (f"SparseRows(shape={self.shape}, k={self.k}, "
                f"dtype={self.dtype})")


# ---------------------------------------------------------------------------
# host-side encoding (numpy)
# ---------------------------------------------------------------------------


def ell_from_csr(X, k: int = None, dtype=None) -> SparseRows:
    """Encode a scipy sparse matrix as a host :class:`SparseRows`. ``k``
    (default: :func:`~dask_ml_tpu_torch.parallel.shapes.bucket_nnz` of the
    largest row's nonzero count) is the slot budget; a row with more
    nonzeros than an explicit ``k`` raises."""
    import scipy.sparse

    from dask_ml_tpu_torch.parallel.shapes import bucket_nnz

    if not scipy.sparse.issparse(X):
        raise TypeError(f"ell_from_csr expects a scipy sparse matrix, got "
                        f"{type(X).__name__}")
    X = X.tocsr()
    n, d = X.shape
    row_nnz = np.diff(X.indptr)
    k_true = int(row_nnz.max()) if n else 0
    if k is None:
        k = bucket_nnz(k_true)
    elif k_true > int(k):
        raise ValueError(
            f"a row has {k_true} nonzeros, more than the requested ELL "
            f"width k={k}; widen k")
    k = max(int(k), 1)
    vdt = np.dtype(dtype) if dtype is not None else (
        X.dtype if np.issubdtype(X.dtype, np.floating) else np.float32)
    values = np.zeros((n, k), vdt)
    cols = np.zeros((n, k), np.int32)
    if X.nnz:
        r = np.repeat(np.arange(n), row_nnz)
        slot = np.arange(X.nnz) - np.repeat(X.indptr[:-1], row_nnz)
        values[r, slot] = X.data.astype(vdt, copy=False)
        cols[r, slot] = X.indices.astype(np.int32, copy=False)
    return SparseRows(values, cols, d)


def ell_from_dense(X, k: int = None, dtype=None) -> SparseRows:
    """Encode a dense host array (tests and small drills)."""
    import scipy.sparse

    return ell_from_csr(scipy.sparse.csr_matrix(np.asarray(X)), k=k,
                        dtype=dtype)


def _tensors(A: SparseRows):
    return torch.as_tensor(A.values), torch.as_tensor(A.cols)


def to_dense(A: SparseRows) -> torch.Tensor:
    """Densify (small sizes, tests) as an f32 tensor where the leaves lie;
    duplicate column slots sum."""
    values, cols = _tensors(A)
    n, k = values.shape
    rows = torch.arange(n, device=values.device)[:, None]
    out = torch.zeros(n * A.d, dtype=torch.float32, device=values.device)
    out.index_add_(0, (rows * A.d + cols).reshape(-1),
                   values.to(torch.float32).reshape(-1))
    return out.view(n, A.d)


def add_intercept_ell(A: SparseRows) -> SparseRows:
    """Append the intercept column (index ``d``, value 1) as one extra slot
    per row, host or device. It concatenates, so for a moment both
    containers exist: callers drop the first."""
    n = int(A.values.shape[0])
    if isinstance(A.values, np.ndarray):
        return SparseRows(
            np.concatenate([A.values, np.ones((n, 1), A.values.dtype)], 1),
            np.concatenate([A.cols, np.full((n, 1), A.d, A.cols.dtype)], 1),
            A.d + 1)
    return SparseRows(
        torch.cat([A.values, A.values.new_ones((n, 1))], 1),
        torch.cat([A.cols, A.cols.new_full((n, 1), A.d)], 1), A.d + 1)


# ---------------------------------------------------------------------------
# K6: A @ v, the kernel, its plain version and its autograd Function
# ---------------------------------------------------------------------------


def _spmv_ref(values, cols, v):
    """Plain ``A @ v``: gather ``v[cols]`` (an int32 ``index_select``, no
    int64 copy of the index), multiply by the values, row sum in f32."""
    g = torch.index_select(v.to(values.dtype), 0, cols.reshape(-1))
    return g.view(values.shape).mul_(values).sum(dim=1, dtype=torch.float32)


def _spmv_cuda(values, cols, v):
    """Launch ``csrc/spmv.cu`` — replaces the TPU kernel
    ``dask_ml_tpu/ops/sparse.py::_spmv_impl``. See the source for what
    bounds it on the H100 and how the design answers that. The output is
    allocated here; the kernel runs on PyTorch's current stream and does
    not synchronise."""
    from dask_ml_tpu_torch._kernels import build

    if values.dim() != 2 or cols.shape != values.shape:
        raise ValueError(
            f"the SpMV kernel takes values and cols of one (n, k) shape; got "
            f"{tuple(values.shape)} and {tuple(cols.shape)}")
    if (values.dtype != torch.float32 or cols.dtype != torch.int32
            or v.dtype != torch.float32 or v.dim() != 1):
        raise ValueError(
            f"the SpMV kernel takes f32 values, int32 cols and a 1-D f32 v; "
            f"got {values.dtype}, {cols.dtype} and {v.dtype} of shape "
            f"{tuple(v.shape)}")
    if not (values.device == cols.device == v.device and values.is_cuda):
        raise ValueError(
            f"the SpMV kernel takes CUDA tensors on one device; got "
            f"{values.device}, {cols.device}, {v.device}")
    if not (values.is_contiguous() and cols.is_contiguous()
            and v.is_contiguous()):
        raise ValueError("the SpMV kernel takes contiguous tensors")
    n, k = values.shape
    if k < 1:
        raise ValueError("the SpMV kernel takes k >= 1 slots per row")
    out = torch.empty(n, dtype=torch.float32, device=values.device)
    if n == 0:
        return out
    lib = build.load("spmv")
    err = lib.dml_spmv(values.data_ptr(), cols.data_ptr(), v.data_ptr(), n, k,
                       out.data_ptr(), build.stream_of(values))
    build.check(err, "SpMV kernel")
    _kernels.launches["spmv"] += 1
    return out


class _SpMV(torch.autograd.Function):
    """``A @ v`` with the JAX package's custom VJP as its backward."""

    @staticmethod
    def forward(ctx, values, cols, v, d, use_kernel):
        ctx.save_for_backward(values, cols, v)
        ctx.d = d
        if use_kernel:
            return _spmv_cuda(values, cols, v)
        return _spmv_ref(values, cols, v)

    @staticmethod
    def backward(ctx, g):
        values, cols, v = ctx.saved_tensors
        dvalues = dv = None
        if ctx.needs_input_grad[0]:
            # (n, k): at the GLM cell 4 GB, so formed only when asked for
            dvalues = g.to(values.dtype)[:, None] * torch.index_select(
                v.to(values.dtype), 0, cols.reshape(-1)).view(values.shape)
        if ctx.needs_input_grad[2]:
            dv = pullback(SparseRows(values, cols, ctx.d), g).to(v.dtype)
        return dvalues, None, dv, None, None


def spmv(A: SparseRows, v, *, kernel: str = "auto"):
    """Blocked-ELL ``A @ v`` (n,) f32, differentiable in ``v`` and in
    ``A.values``. ``kernel="auto"`` launches K6 for CUDA tensors and runs
    :func:`_spmv_ref` for CPU tensors; ``"cuda"`` insists on the kernel;
    ``"torch"`` runs the plain version wherever the tensors lie. The
    backward is the same either way."""
    return _SpMV.apply(A.values, A.cols, v, A.d,
                       _kernels.use_cuda(kernel, A.values))


def matvec(A: SparseRows, v, *, kernel: str = "auto"):
    """``A @ v`` — the sparse linear predictor the GLM seams call; ``v`` is
    ``(A.d,)``. See :func:`spmv`."""
    return spmv(A, v, kernel=kernel)


# ---------------------------------------------------------------------------
# the other contractions (plain PyTorch on both devices)
# ---------------------------------------------------------------------------


def matmat(A: SparseRows, B):
    """``A @ B`` for a dense ``(d, m)`` operand (OVR scoring): gather B's
    rows per slot, reduce over slots in f32. Transient memory is
    O(n·k·m)."""
    n, k = A.values.shape
    g = torch.index_select(B.to(A.values.dtype), 0, A.cols.reshape(-1))
    g = g.view(n, k, -1) * A.values[:, :, None]
    return g.sum(dim=1, dtype=torch.float32)


def pullback(A: SparseRows, r):
    """``A.T @ r`` (d,) f32 — the gradient pullback, a scatter-add of the
    slot products over the flattened int32 column indices (the
    counterpart of XLA's ``segment_sum``); padded slots add 0."""
    prods = (A.values * r.to(A.values.dtype)[:, None]).to(torch.float32)
    out = torch.zeros(A.d, dtype=torch.float32, device=prods.device)
    return out.index_add_(0, A.cols.reshape(-1), prods.reshape(-1))


def pullback_mat(A: SparseRows, R):
    """``A.T @ R`` (d, m) f32 for a dense ``(n, m)`` cotangent."""
    n, k = A.values.shape
    m = int(R.shape[1])
    prods = (A.values[:, :, None] * R.to(A.values.dtype)[:, None, :]).to(
        torch.float32)
    out = torch.zeros((A.d, m), dtype=torch.float32, device=prods.device)
    return out.index_add_(0, A.cols.reshape(-1), prods.reshape(n * k, m))


#: bound on the (chunk, k, k) outer-product buffer of weighted_gram
_GRAM_BUDGET = 1 << 22


def weighted_gram(A: SparseRows, h):
    """``A.T @ diag(h) @ A`` (d, d) f32 — the GLM curvature that Newton
    needs, as a scatter-add of each row's per-slot outer products
    (O(nnz·k) work), in row chunks that bound the transient
    ``(chunk, k, k)`` buffer to ``_GRAM_BUDGET`` entries. Only sensible
    where a dense (d, d) Hessian is."""
    n, k = A.values.shape
    d = A.d
    vals = A.values.to(torch.float32)
    w = vals * h.to(torch.float32)[:, None]
    H = torch.zeros(d * d, dtype=torch.float32, device=vals.device)
    c = max(1, _GRAM_BUDGET // max(k * k, 1))
    for s in range(0, n, c):
        ci = A.cols[s:s + c].to(torch.int64)
        contrib = w[s:s + c, :, None] * vals[s:s + c, None, :]
        H.index_add_(0, (ci[:, :, None] * d + ci[:, None, :]).reshape(-1),
                     contrib.reshape(-1))
    return H.view(d, d)

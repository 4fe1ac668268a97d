"""Sparse row matrices of the PyTorch port (counterpart of
``dask_ml_tpu/ops/sparse.py``): the blocked-ELL container and the
contractions the GLM solvers route through.

- :class:`SparseRows` — an (n, d) row matrix as ``values (n, k)`` and
  ``cols (n, k)``; unused slots hold ``(col=0, value=0)``, inert in every
  contraction because the value is 0. Duplicate columns in a row sum.
  The leaves are numpy arrays on the host and tensors once staged.
- :func:`matvec` / :func:`spmv` — ``A @ v``, the sparse linear predictor,
  as a ``torch.autograd.Function``. Its forward is a hand-written CUDA
  kernel of ``_kernels/csrc/spmv.cu`` (K6) for CUDA tensors and the plain
  gather + row sum :func:`_spmv_ref` for CPU tensors (or ``kernel="torch"``
  anywhere). Its backward is the pullback with respect to ``v`` (a kernel
  of the same source where the forward ran one) and, only when autograd
  asks for it, the slot-wise product with respect to ``values``; ``cols``
  gets no gradient.
- :func:`pullback` (``A.T @ r``) — the same source's pullback kernel for
  CUDA tensors, the plain ``index_add_`` scatter :func:`_pullback_ref` for
  CPU tensors (or ``kernel="torch"`` anywhere).
- :func:`dvector_plan` — where the kernels keep the ``(d,)`` vector that
  the forward gathers from and the pullback scatters into: the shared
  memory of one block, of a thread block cluster of 2 (the pullback: also
  of 4), or L2. A
  pure function of ``(n, k, d)`` and the card's constants.
- :func:`matmat` (an autograd function whose backward for ``B`` is
  :func:`pullback_mat`), :func:`pullback_mat` and :func:`weighted_gram`
  (``A.T @ diag(h) @ A``) in plain PyTorch, as the JAX package computes
  them outside any Pallas kernel; the last two add their products in
  fixed point, so that they repeat their bits.

Values are float32 or bfloat16 (``ell_from_csr(..., dtype=torch.bfloat16)``,
or a container staged under ``precision="bf16"``); cols are always int32.
Every reduction accumulates in :func:`_accum_dtype` (at least f32). The
forward contractions (K6, :func:`matmat`) round the dense operand to the
values' dtype and form each product in f32 (exact for two bf16
operands), as the Pallas K6 does. The pullbacks (K6-b,
:func:`pullback_mat`) keep the cotangent in f32 and form each product in
f32: unlike the JAX package's bf16 ``pullback``, which rounds the
cotangent and each product to bf16 and so loses a logistic gradient
(σ(η) − y is ±½ to bf16's 8 bits; an L-BFGS fit on bf16 values then
lands far from the f32 fit, in the JAX package too: PERF.md §6).
On integer-valued data every partial sum is an
exactly representable integer, so the contractions are bit-identical to
the dense products they replace whatever their order. On float data the
kernels repeat their own bits from run to run: the forward sums each row in
a fixed order, the pullback adds its products as fixed-point integers, and
so do ``pullback_mat`` and ``weighted_gram`` (int64 ``index_add_``): no
gradient of a container adds floats with atomics. The plain pullback
``_pullback_ref`` (a float ``index_add_``, the reference the kernel is
held against) adds with float atomics on CUDA and does not.
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
    "dvector_plan",
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
    nonzeros than an explicit ``k`` raises. ``dtype=torch.bfloat16``
    builds a bf16 container, whose leaves are CPU tensors (numpy has no
    bfloat16): the values rounded to nearest even, the cols int32."""
    if dtype == torch.bfloat16:
        A = ell_from_csr(X, k=k, dtype=np.float32)
        return SparseRows(torch.from_numpy(A.values).to(torch.bfloat16),
                          torch.from_numpy(A.cols), A.d)
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


def _accum_dtype(A: SparseRows):
    """The dtype the contractions accumulate in: the state dtype of the
    values (at least f32)."""
    from dask_ml_tpu_torch.parallel.precision import state_dtype

    return state_dtype(A.dtype)


def _spmv_ref(values, cols, v):
    """Plain ``A @ v``: gather ``v[cols]`` rounded to the values' dtype
    (an int32 ``index_select``, no int64 copy of the index), multiply by
    the values in f32, row sum in f32: the Pallas kernel's function."""
    g = torch.index_select(v.to(values.dtype), 0, cols.reshape(-1))
    g = g.view(values.shape)
    if values.dtype != torch.float32:
        g = g.to(torch.float32)
        values = values.to(torch.float32)
    return g.mul_(values).sum(dim=1, dtype=torch.float32)


#: the card's constants the plan rests on (H100 SXM) and the tiles of the
#: shared-memory kernels (``csrc/spmv.cu``: a block's 2 groups of 512
#: threads each walk tiles of their own, 4 slots a thread)
_SMEM_BLOCK_BYTES = 232_448
_SMS = 132
_GROUPS = 2
_TILE_SLOTS = 2048
_MAX_TILE_K = _TILE_SLOTS // 4
#: cluster sizes the kernels are built for, forward and pullback. Every
#: block of a cluster inspects every slot of the cluster's tiles, so a
#: kernel's time grows with the cluster: measured on an H100 at n = 1e7,
#: k = 101, the forward in a cluster of 4 is slower than the L2 kernel and
#: the pullback in a cluster of 8 slower than device atomics (PERF.md has
#: the numbers).
_PLAN_CLUSTERS = {False: (1, 2), True: (1, 2, 4)}


def _tile_rows(k: int) -> int:
    """Rows of a tile: a multiple of 4 (so that a tile starts on a 16-byte
    boundary whatever ``k``) with at most ``_TILE_SLOTS`` slots."""
    return (_TILE_SLOTS // k) & ~3


def _fits(k: int, d: int, cluster: int, pullback: bool) -> bool:
    """Whether a cluster of ``cluster`` blocks holds a ``(d,)`` vector for
    rows of ``k`` slots: each block ``ceil(d / cluster)`` floats beside
    what the kernel needs besides (two staging tiles of
    ``_tile_rows(k) * k`` floats for each of the forward's 2 groups; the
    pullback needs nothing) in its 232,448 bytes."""
    if k > _MAX_TILE_K:
        return False
    besides = 0 if pullback else 8 * _GROUPS * _tile_rows(k) * k
    return 4 * -(-d // cluster) + besides <= _SMEM_BLOCK_BYTES


def dvector_plan(n: int, k: int, d: int, *, pullback: bool = False) -> int:
    """Where K6 (or, with ``pullback=True``, its backward) keeps the
    ``(d,)`` vector for an ``(n, k)`` container: the number of blocks (1
    or 2 for the forward; 1, 2 or 4 for the pullback) of the cluster whose
    shared memory holds it, or 0 for L2.

    The smallest cluster that fits (:func:`_fits`) is taken. The vector
    stays in L2 where ``d`` is beyond the largest cluster that still beats
    the L2 kernel, where a row is wider than a tile, and where the
    container's ``n * k`` slots are fewer than the floats a full grid
    copies into shared memory (every cluster its own ``d``)."""
    n, k, d = int(n), int(k), int(d)
    if n < 1 or k < 1:
        return 0
    for cluster in _PLAN_CLUSTERS[bool(pullback)]:
        if _fits(k, d, cluster, pullback):
            return cluster if n * k >= (_SMS // cluster) * d else 0
    return 0


def _check_kernel_args(what, values, cols, x, xname):
    """What both K6 wrappers hold their arguments to; returns (n, k)."""
    if values.dim() != 2 or cols.shape != values.shape:
        raise ValueError(
            f"the {what} kernel takes values and cols of one (n, k) shape; "
            f"got {tuple(values.shape)} and {tuple(cols.shape)}")
    if (values.dtype not in (torch.float32, torch.bfloat16)
            or cols.dtype != torch.int32
            or x.dtype != torch.float32 or x.dim() != 1):
        raise ValueError(
            f"the {what} kernel takes f32 or bf16 values, int32 cols and a "
            f"1-D f32 "
            f"{xname}; got {values.dtype}, {cols.dtype} and {x.dtype} of "
            f"shape {tuple(x.shape)}")
    if not (values.device == cols.device == x.device and values.is_cuda):
        raise ValueError(
            f"the {what} kernel takes CUDA tensors on one device; got "
            f"{values.device}, {cols.device}, {x.device}")
    if not (values.is_contiguous() and cols.is_contiguous()
            and x.is_contiguous()):
        raise ValueError(f"the {what} kernel takes contiguous tensors")
    n, k = values.shape
    if k < 1:
        raise ValueError(f"the {what} kernel takes k >= 1 slots per row")
    return n, k


def _spmv_cuda(values, cols, v, cluster=None):
    """Launch K6 (``csrc/spmv.cu``) — replaces the TPU kernel
    ``dask_ml_tpu/ops/sparse.py::_spmv_impl``. See the source for what
    bounds it on the H100 and how the design answers that. ``cluster`` is
    :func:`dvector_plan`'s answer unless the caller (a test, a timing)
    names one: 1 or 2 launch the kernel that keeps ``v`` in shared memory
    (a cluster launch needs sm_90 and is refused at launch where the shape
    does not fit), 0 the one that gathers from L2. The output and the
    ``(cluster, n)`` scratch of partial outputs are allocated here; the
    kernels run on PyTorch's current stream and do not synchronise. bf16
    values are the kernel's bf16 case (counters ``spmv_bf16`` /
    ``spmv_l2_bf16``): ``v`` is rounded to bf16 here, once, and handed
    over widened to f32."""
    from dask_ml_tpu_torch._kernels import build

    n, k = _check_kernel_args("SpMV", values, cols, v, "v")
    d = int(v.numel())
    bf16 = values.dtype == torch.bfloat16
    suffix = "_bf16" if bf16 else ""
    if bf16:
        v = v.to(torch.bfloat16).to(torch.float32)
    out = torch.empty(n, dtype=torch.float32, device=values.device)
    if n == 0:
        return out
    if cluster is None:
        cluster = dvector_plan(n, k, d)
    lib = build.load("spmv")
    stream = build.stream_of(values)
    if cluster == 0:
        err = lib.dml_spmv(values.data_ptr(), int(bf16), cols.data_ptr(),
                           v.data_ptr(), n, k, out.data_ptr(), stream)
        build.check(err, "SpMV kernel (v in L2)")
        _kernels.count("spmv_l2" + suffix)
    else:
        partial = None
        if cluster > 1:
            partial = torch.empty((cluster, n), dtype=torch.float32,
                                  device=values.device)
        err = lib.dml_spmv_smem(
            values.data_ptr(), int(bf16), cols.data_ptr(), v.data_ptr(), n,
            k, d, cluster, None if partial is None else partial.data_ptr(),
            out.data_ptr(), stream)
        build.check(err, f"SpMV kernel (v in a cluster of {cluster})")
        _kernels.count("spmv" + suffix)
    return out


def _pullback_ref(values, cols, r, d):
    """Plain ``A.T @ r``: a scatter-add of the slot products over the
    flattened int32 column indices (the counterpart of XLA's
    ``segment_sum``); padded slots add 0. Each product is formed in f32
    from the values (widened) and ``r`` in f32 (see the module docstring
    for the bf16 case)."""
    prods = values.to(torch.float32) * r.to(torch.float32)[:, None]
    out = torch.zeros(d, dtype=torch.float32, device=prods.device)
    return out.index_add_(0, cols.reshape(-1), prods.reshape(-1))


def _values_bound(values):
    """The bits of ``max |values|`` as a one-word int32 tensor on the
    values' device, no host read — the fixed-point scale of the pullback
    kernel and of :func:`pullback_mat` needs it. Reduced once (on the card
    by the pullback source's ``dml_spmv_absmax``, elsewhere by
    ``torch.amax``) and kept on the tensor as ``_dml_absmax`` until its
    ``_version`` changes. A NaN or inf value gives a non-finite bound."""
    held = getattr(values, "_dml_absmax", None)
    if held is not None and held[0] == values._version:
        return held[1]
    if values.is_cuda and values.dtype in (torch.float32, torch.bfloat16) \
            and values.is_contiguous():
        from dask_ml_tpu_torch._kernels import build

        bound = torch.empty(1, dtype=torch.int32, device=values.device)
        err = build.load("spmv").dml_spmv_absmax(
            values.data_ptr(), int(values.dtype == torch.bfloat16),
            values.numel(), bound.data_ptr(), build.stream_of(values))
        build.check(err, "pullback kernel (max |values|)")
    else:
        bound = torch.amax(torch.abs(values)).to(torch.float32).reshape(
            1).view(torch.int32)
    values._dml_absmax = (values._version, bound)
    return bound


def _pullback_cuda(values, cols, r, d, cluster=None):
    """Launch K6's backward (``csrc/spmv.cu``) — the kernel that takes the
    place of the ``segment_sum`` the JAX package's custom VJP
    (``dask_ml_tpu/ops/sparse.py::_spmv_bwd``) leaves to XLA. One pass
    over the container, the ``(n, k)`` product never formed. Each product
    is rounded to a 64-bit fixed-point integer (one scale a call, from
    ``max |values|``, ``max |r|`` and ``n k``) and the integers are added,
    so every route repeats its bits and gives the bits of every other
    route; on integer-valued data every sum is exact. ``cluster`` as in
    :func:`_spmv_cuda`: 1, 2 or 4 keep the low words of ``g`` in every
    cluster's shared memory (the ``(clusters, d)`` scratch of low and high
    words is allocated here), 0 adds with 64-bit atomics on device
    memory. bf16 values are the kernel's bf16 case (counters
    ``spmv_pullback_bf16`` / ``spmv_pullback_l2_bf16``): the values are
    widened where loaded, ``r`` stays f32."""
    from dask_ml_tpu_torch._kernels import build

    n, k = _check_kernel_args("pullback", values, cols, r, "r")
    bf16 = values.dtype == torch.bfloat16
    suffix = "_bf16" if bf16 else ""
    d = int(d)
    if r.numel() != n:
        raise ValueError(
            f"the pullback kernel takes one r per row; got {r.numel()} for "
            f"{n} rows")
    if d < 1:
        raise ValueError("the pullback kernel takes d >= 1 columns")
    if n == 0:
        return torch.zeros(d, dtype=torch.float32, device=values.device)
    if cluster is None:
        cluster = dvector_plan(n, k, d, pullback=True)
    g = torch.empty(d, dtype=torch.float32, device=values.device)
    lib = build.load("spmv")
    stream = build.stream_of(values)
    a_bound = _values_bound(values)
    r_bound = torch.empty(1, dtype=torch.int32, device=values.device)
    if cluster == 0:
        acc = torch.empty(d, dtype=torch.int64, device=values.device)
        err = lib.dml_spmv_pullback_atomic(
            values.data_ptr(), int(bf16), cols.data_ptr(), r.data_ptr(), n,
            k, d, a_bound.data_ptr(), r_bound.data_ptr(), acc.data_ptr(),
            g.data_ptr(), stream)
        build.check(err, "pullback kernel (g in L2)")
        _kernels.count("spmv_pullback_l2" + suffix)
        return g
    what = f"pullback kernel (g in a cluster of {cluster})"
    clusters = lib.dml_spmv_pullback_clusters(n, k, d, cluster, int(bf16))
    if clusters < 1:
        build.check(-clusters, what)
    words = torch.empty((2, clusters, d), dtype=torch.int32,
                        device=values.device)
    err = lib.dml_spmv_pullback_smem(
        values.data_ptr(), int(bf16), cols.data_ptr(), r.data_ptr(), n, k, d,
        cluster, a_bound.data_ptr(), r_bound.data_ptr(), words[0].data_ptr(),
        words[1].data_ptr(), clusters, g.data_ptr(), stream)
    build.check(err, what)
    _kernels.count("spmv_pullback" + suffix)
    return g


class _SpMV(torch.autograd.Function):
    """``A @ v`` with the JAX package's custom VJP as its backward: kernels
    both ways where ``use_kernel``, the plain versions both ways where
    not."""

    @staticmethod
    def forward(ctx, values, cols, v, d, use_kernel):
        ctx.save_for_backward(values, cols, v)
        ctx.d = d
        ctx.use_kernel = use_kernel
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
            if ctx.use_kernel:
                # autograd may hand over an expanded (stride 0) cotangent
                dv = _pullback_cuda(values, cols, g.contiguous(), ctx.d)
            else:
                dv = _pullback_ref(values, cols, g, ctx.d)
            dv = dv.to(v.dtype)
        return dvalues, None, dv, None, None


def spmv(A: SparseRows, v, *, kernel: str = "auto"):
    """Blocked-ELL ``A @ v`` (n,) f32, differentiable in ``v`` and in
    ``A.values``. ``kernel="auto"`` launches K6 for CUDA tensors and runs
    :func:`_spmv_ref` for CPU tensors; ``"cuda"`` insists on the kernel;
    ``"torch"`` runs the plain version wherever the tensors lie. The
    backward follows the forward: the pullback kernel where K6 ran, the
    plain ``index_add_`` where the plain version did. Raises
    ``ValueError`` unless ``v`` is ``(A.d,)``, before any launch."""
    if tuple(v.shape) != (A.d,):
        raise ValueError(
            f"spmv takes v of shape ({A.d},) for a container of {A.d} "
            f"columns; got {tuple(v.shape)}")
    return _SpMV.apply(A.values, A.cols, v, A.d,
                       _kernels.use_cuda(kernel, A.values))


def matvec(A: SparseRows, v, *, kernel: str = "auto"):
    """``A @ v`` — the sparse linear predictor the GLM seams call; ``v`` is
    ``(A.d,)``. See :func:`spmv`."""
    return spmv(A, v, kernel=kernel)


# ---------------------------------------------------------------------------
# A.T @ r through K6's backward, and the other contractions (plain PyTorch
# on both devices)
# ---------------------------------------------------------------------------


def _matmat_ref(values, cols, B):
    """``A @ B``: gather B's rows per slot (rounded to the values' dtype),
    products in f32, reduce over slots in f32."""
    n, k = values.shape
    g = torch.index_select(B.to(values.dtype), 0, cols.reshape(-1))
    if values.dtype != torch.float32:
        g, values = g.to(torch.float32), values.to(torch.float32)
    g = g.view(n, k, -1) * values[:, :, None]
    return g.sum(dim=1, dtype=torch.float32)


class _MatMat(torch.autograd.Function):
    """``A @ B`` whose backward for ``B`` is :func:`pullback_mat` (64-bit
    fixed-point adds, so the softmax gradient repeats its bits on the
    card) and, only when autograd asks for it, the slot-wise product for
    ``values``."""

    @staticmethod
    def forward(ctx, values, cols, B, d):
        ctx.save_for_backward(values, cols, B)
        ctx.d = d
        return _matmat_ref(values, cols, B)

    @staticmethod
    def backward(ctx, G):
        values, cols, B = ctx.saved_tensors
        dvalues = dB = None
        if ctx.needs_input_grad[0]:
            n, k = values.shape
            gathered = torch.index_select(B.to(values.dtype), 0,
                                          cols.reshape(-1)).view(n, k, -1)
            dvalues = (gathered * G.to(values.dtype)[:, None, :]).sum(dim=2)
        if ctx.needs_input_grad[2]:
            dB = pullback_mat(SparseRows(values, cols, ctx.d), G).to(B.dtype)
        return dvalues, None, dB, None


def matmat(A: SparseRows, B):
    """``A @ B`` for a dense ``(d, m)`` operand (OVR scoring, softmax
    logits): gather B's rows per slot, reduce over slots in f32. Transient
    memory is O(n·k·m). Differentiable in ``B`` through
    :func:`pullback_mat` and in ``A.values``. Raises ``ValueError`` unless
    ``B`` has ``A.d`` rows."""
    if B.ndim != 2 or int(B.shape[0]) != A.d:
        raise ValueError(
            f"matmat takes B of shape ({A.d}, m) for a container of {A.d} "
            f"columns; got {tuple(B.shape)}")
    return _MatMat.apply(A.values, A.cols, B, A.d)


def pullback(A: SparseRows, r, *, kernel: str = "auto"):
    """``A.T @ r`` (d,) f32 — the gradient pullback; padded slots add 0.
    ``kernel`` as in :func:`spmv`: ``"auto"`` launches K6's backward for
    CUDA tensors and runs :func:`_pullback_ref` for CPU tensors; ``"cuda"``
    insists on the kernel; ``"torch"`` runs the plain version wherever the
    tensors lie."""
    if _kernels.use_cuda(kernel, A.values):
        return _pullback_cuda(A.values, A.cols,
                              r.to(torch.float32).contiguous(), A.d)
    return _pullback_ref(A.values, A.cols, r, A.d)


#: bound on the (chunk, k, m) product buffer of pullback_mat
_PULLBACK_MAT_BUDGET = 1 << 24


def _fixed_scale(bound, count: int):
    """The exponent ``e`` of one call's fixed point, as the pullback
    kernel takes it: each product ``p`` of magnitude at most ``bound``
    becomes ``rint(p·2^e)`` with at most ``cap = min(39, 61 −
    ceil(log2(count)))`` bits, so that a sum of ``count`` of them stays
    inside 62 bits. A 0-d int tensor on the bound's device; 0 for a zero
    or non-finite bound."""
    cap = min(39, 61 - (max(count - 1, 0).bit_length() if count > 1 else 0))
    _, ex = torch.frexp(bound)  # bound < 2^ex
    ok = torch.isfinite(bound) & (bound > 0)
    return torch.where(ok, cap - ex, torch.zeros_like(ex))


def pullback_mat(A: SparseRows, R):
    """``A.T @ R`` (d, m) f32 for a dense ``(n, m)`` cotangent — the
    backward of :func:`matmat` (the softmax gradient).

    The products are added in fixed point, as the pullback kernel adds
    its own: each f32 product ``a·r`` is rounded to an integer at one
    power-of-two scale a call (from ``max|values|``, ``max|R|`` and the
    count ``n·k``, so that no sum leaves 62 bits) and the int64 sums,
    made with an integer ``index_add_`` into a ``(d·m,)`` buffer, are
    exact in any order: the result repeats its bits on the card, where a
    float ``index_add_`` adds in an order that changes from run to run.
    ``max|values|`` is the bound cached on the values tensor, which the
    pullback kernel shares (:func:`_values_bound`). The scale stays on
    the device: no host read. A non-finite bound gives NaN everywhere.
    Row chunks bound the transient ``(chunk, k, m)`` buffers to
    ``_PULLBACK_MAT_BUDGET`` entries."""
    n, k = A.values.shape
    d = A.d
    m = int(R.shape[1])
    vals = A.values.to(torch.float32)
    Rf = R.to(torch.float32)
    bound = (_values_bound(A.values).view(torch.float32)[0].double()
             * torch.amax(torch.abs(Rf)).double()) if n * k * m else (
        torch.zeros((), dtype=torch.float64, device=vals.device))
    e = _fixed_scale(bound, n * k)
    scale = torch.exp2(e.double())
    acc = torch.zeros(d * m, dtype=torch.int64, device=vals.device)
    cols = torch.arange(m, device=vals.device)
    c = max(1, _PULLBACK_MAT_BUDGET // max(k * m, 1))
    for s in range(0, n, c):
        p = vals[s:s + c, :, None] * Rf[s:s + c, None, :]  # f32 products
        q = (p.double() * scale).round_().to(torch.int64)
        idx = A.cols[s:s + c].to(torch.int64)[:, :, None] * m + cols
        acc.index_add_(0, idx.reshape(-1), q.reshape(-1))
    out = (acc.double() * torch.exp2(-e.double())).float().view(d, m)
    return torch.where(torch.isfinite(bound), out, torch.nan)


#: bound on the (chunk, k, k) outer-product buffer of weighted_gram
_GRAM_BUDGET = 1 << 22


def weighted_gram(A: SparseRows, h):
    """``A.T @ diag(h) @ A`` (d, d) f32 — the GLM curvature that Newton
    needs, as a scatter-add of each row's per-slot outer products
    (O(nnz·k) work), in row chunks that bound the transient
    ``(chunk, k, k)`` buffer to ``_GRAM_BUDGET`` entries. Only sensible
    where a dense (d, d) Hessian is.

    The products are added in fixed point, as the pullback kernel adds
    its own: each is rounded to a multiple of ``2^-e`` (one ``e`` a call,
    from the largest product bound ``max|h·a|·max|a|`` and the count
    ``n·k²``, so that the largest product takes at most 39 bits and no sum
    leaves 62) and the int64 sums are exact in any order, so the Gram
    repeats its bits on the card, where a float ``index_add_`` adds in an
    order that changes from run to run. The scale stays on the device: no
    host read. A non-finite bound gives NaN everywhere."""
    n, k = A.values.shape
    d = A.d
    dev = A.values.device
    vals = A.values.to(_accum_dtype(A))
    w = vals * h.to(torch.float32)[:, None]
    bound = (torch.amax(torch.abs(w)) * torch.amax(torch.abs(vals))).double()
    cap = min(39, 61 - max(n * k * k - 1, 1).bit_length())
    _, ex = torch.frexp(bound)  # bound < 2^ex
    e = cap - ex
    # 2^e as two f32 factors, each inside f32's range: an f32 product times
    # them is exact, and so is its rounding to an integer
    e1 = torch.div(e, 2, rounding_mode="floor")
    s1, s2 = torch.exp2(e1.float()), torch.exp2((e - e1).float())
    H = torch.zeros(d * d, dtype=torch.int64, device=dev)
    c = max(1, _GRAM_BUDGET // max(k * k, 1))
    for s in range(0, n, c):
        ci = A.cols[s:s + c].to(torch.int64)
        contrib = w[s:s + c, :, None] * vals[s:s + c, None, :]
        q = contrib.mul_(s1).mul_(s2).round_().to(torch.int64)
        H.index_add_(0, (ci[:, :, None] * d + ci[:, None, :]).reshape(-1),
                     q.reshape(-1))
    out = (H.double() * torch.exp2(-e.double())).float().view(d, d)
    return torch.where(torch.isfinite(bound), out, torch.nan)

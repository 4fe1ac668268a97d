"""Fused distance-reduction family of the PyTorch port (counterpart of
``dask_ml_tpu/ops/fused_distance.py``).

Squared Euclidean distances from n query rows X to m target rows Y,
reduced along the target axis before the (n × m) matrix ever exists:

- :func:`fused_rowwise_min` — per-row min d² (k-means|| rounds), with the
  optional ``row_need`` block skip;
- :func:`fused_argmin_min` — per-row (argmin int32, min d²) (assignment,
  ``predict_labels``);
- :func:`fused_argmin_min2` — per-row (argmin, min d², second-best d²),
  the bound-seeding primitive of bounded Lloyd, with ``row_need``;
- :func:`fused_argmin_weight` — per-row argmin plus the per-target sum of
  row weights (k-means|| candidate weighting);
- :func:`fused_argmin_min_sketched` — argmin and full-space min d² against
  sketched targets (the argmin_min kernel with a caller-supplied |x|²),
  with ``row_need``.

Each takes ``kernel="auto" | "cuda" | "torch"``. ``"auto"`` launches the
hand-written CUDA kernel (``_kernels/csrc/fused_distance.cu``) for a CUDA
tensor and runs the plain PyTorch version for a CPU tensor; ``"cuda"``
insists on the kernel; ``"torch"`` runs the plain version wherever the
tensor lies (the card's reference run in ``chip_smoke.py``). A build or
launch error raises: nothing here gives way to the plain version.

Score convention, shared by the kernel and the plain versions so ties
break identically: the reduction runs over ``s_j = |y_j|² − 2·x·y_j`` with
``|y|²`` in f32 from the ORIGINAL Y and ``x·y_j`` formed from Y cast to
X's dtype, accumulated in f32; ``|x|²`` is added back only to the
returned min value, which is clamped at 0 against cancellation. X may be
float32 or bfloat16 (the JAX package's bf16 case): with bf16 X the
products are those of bf16 operands, exact in f32, so on the card the
bf16 kernel gives the bits of the f32 kernel run on ``X.float()``. Masked
targets score +inf and never win; ties go to the lowest index; when every
target is masked the argmin is 0 and the min is +inf. Indices are int32 at
every public function (``torch.argmin`` gives int64).

``row_need`` skips work in groups of ``_FUSED_BLK`` rows whatever tile the
kernel uses: a group with no needed row returns the identity of the
caller's reduction for every row — +inf for :func:`fused_rowwise_min`,
zeros for the argmin consumers — and rows that share a group with a needed
row get the full answer (:func:`row_block_evaluated`).
"""

from __future__ import annotations

import torch

from dask_ml_tpu_torch import _kernels

#: rows per ``row_need`` skip group — a contract of the family, independent
#: of the CUDA kernel's tile. Module-level so tests can shrink it.
_FUSED_BLK = 1024

#: epilogue -> (code in csrc/fused_distance.cu, launch counter)
_EPILOGUES = {"min": (0, "fused_rowwise_min"),
              "argmin_min": (1, "fused_argmin_min"),
              "argmin_weight": (2, "fused_argmin_weight"),
              "argmin_min2": (3, "fused_argmin_min2")}


# ---------------------------------------------------------------------------
# plain PyTorch versions (the reference every kernel is held against)
# ---------------------------------------------------------------------------


def _row_sumsq(X):
    """Per-row Σx² in f32."""
    Xf = X.to(torch.float32)
    return (Xf * Xf).sum(dim=1)


def _scores_ref(X, Y, mask):
    """(n, m) reduction scores ``|y|² − 2·x·y`` with masked targets at
    +inf. ``|y|²`` comes from the ORIGINAL Y in f32, the product from Y
    cast to X's dtype (bf16 X: bf16 operands, exact products) accumulated
    in f32."""
    y2 = _row_sumsq(Y)
    prod = X.to(torch.float32) @ Y.to(X.dtype).to(torch.float32).T
    s = y2[None, :] - 2.0 * prod
    if mask is not None:
        s = torch.where(mask.to(torch.bool)[None, :], s,
                        torch.full_like(s, float("inf")))
    return s


def _min_ref(X, Y, mask):
    s = _scores_ref(X, Y, mask)
    return torch.clamp(s.min(dim=1).values + _row_sumsq(X), min=0.0)


def _argmin_min_ref(X, Y, mask):
    s = _scores_ref(X, Y, mask)
    mn, idx = s.min(dim=1)  # first index among equal minima
    return (idx.to(torch.int32),
            torch.clamp(mn + _row_sumsq(X), min=0.0))


def _argmin_min2_ref(X, Y, mask):
    """(argmin, min d², second-best d²): the best score and the best score
    with the argmin column masked out. With one valid target (or none)
    the second-best is +inf."""
    s = _scores_ref(X, Y, mask)
    mn, idx = s.min(dim=1)
    s2 = s.scatter(1, idx[:, None], float("inf"))
    x2 = _row_sumsq(X)
    return (idx.to(torch.int32), torch.clamp(mn + x2, min=0.0),
            torch.clamp(s2.min(dim=1).values + x2, min=0.0))


def _argmin_min_sk_ref(Zp, vals, x2, mask):
    """Sketched assignment: the scores contract over the p support columns
    of ``Zp``; the returned min adds back the caller's full-space ``x2``
    (n,) instead of the restricted rows' own |z|²."""
    s = _scores_ref(Zp, vals, mask)
    mn, idx = s.min(dim=1)
    return idx.to(torch.int32), torch.clamp(mn + x2.to(torch.float32),
                                            min=0.0)


def _argmin_weight_ref(X, w, Y, mask):
    s = _scores_ref(X, Y, mask)
    idx = s.argmin(dim=1)
    m = Y.shape[0]
    onehot = (torch.arange(m, device=X.device)[None, :]
              == idx[:, None]).to(torch.float32)
    cw = w.to(torch.float32) @ onehot  # (m,)
    if mask is not None:
        cw = torch.where(mask.to(torch.bool), cw, torch.zeros_like(cw))
    return idx.to(torch.int32), cw


def _row_blocks(n: int):
    """(n_blocks, padded_n) of the ``row_need`` grouping — the one
    definition shared by the plain path, the kernel's group flags and
    :func:`row_block_evaluated`."""
    blk = _FUSED_BLK
    nb = (n + blk - 1) // blk
    return nb, nb * blk


def _group_need(row_need):
    """(n_blocks,) bool: does each ``_FUSED_BLK``-row group hold a needed
    row?"""
    n = row_need.shape[0]
    nb, n_pad = _row_blocks(n)
    need = row_need.to(torch.bool)
    if n_pad != n:
        need = torch.cat([need, need.new_zeros(n_pad - n)])
    return need.view(nb, _FUSED_BLK).any(dim=1)


def row_block_evaluated(row_need):
    """Per-row "this row's group was evaluated": True for every row that
    shares a ``_FUSED_BLK`` group with at least one needed row."""
    n = row_need.shape[0]
    return torch.repeat_interleave(_group_need(row_need), _FUSED_BLK)[:n]


def _blocked_ref(fn, X, row_need, fills, *rowwise):
    """Plain ``row_need`` path: ``fn`` runs on the rows of evaluated groups
    only (with the matching rows of each ``rowwise`` argument); the other
    rows of each output take its entry of ``fills``, the reduction
    identity."""
    ev = row_block_evaluated(row_need)
    got = fn(X[ev], *(a[ev] for a in rowwise))
    got = got if isinstance(got, tuple) else (got,)
    outs = []
    for g, fill in zip(got, fills):
        out = torch.full((X.shape[0],), fill, dtype=g.dtype, device=X.device)
        out[ev] = g
        outs.append(out)
    return tuple(outs) if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# the CUDA kernel (K2 argmin_min, K3 min, K4 argmin_weight, K5 argmin_min2)
# ---------------------------------------------------------------------------


def _fused_cuda(X, Y, mask, epilogue: str, w=None, row_need=None, x2=None,
                counter=None):
    """Launch ``csrc/fused_distance.cu`` — replaces the TPU kernel
    ``dask_ml_tpu/ops/fused_distance.py::_fused_pallas`` (epilogues
    ``min``, ``argmin_min``, ``argmin_weight``, ``argmin_min2``, with the
    ``need2d`` group skip as ``row_need`` and the ``x2d`` external |x|² as
    ``x2``). See the source for what bounds it on the H100 and how the
    design answers that. Outputs and scratch are allocated here; the
    kernel runs on PyTorch's current stream and does not synchronise.
    ``counter`` names the launch counter (default: the epilogue's); a
    bf16 X counts under that name with ``_bf16`` appended, and the kernel
    takes Y rounded to bf16 (held in f32) with ``|y|²`` from the original
    Y."""
    from dask_ml_tpu_torch._kernels import build

    if X.dtype not in (torch.float32, torch.bfloat16) or X.dim() != 2:
        raise ValueError(
            f"the fused distance kernel takes 2-D float32 or bfloat16 X; "
            f"got {X.dtype} of shape {tuple(X.shape)}")
    n, d = X.shape
    m = Y.shape[0]
    if Y.dim() != 2 or Y.shape[1] != d or m < 1:
        raise ValueError(
            f"Y must be (m >= 1, {d}); got shape {tuple(Y.shape)}")
    if n >= 2**31 or m >= 2**31:
        raise ValueError("the fused distance kernel takes n, m < 2**31")
    if epilogue == "argmin_weight" and (row_need is not None
                                        or x2 is not None):
        raise ValueError("argmin_weight takes neither row_need nor x2")
    dev = X.device
    X = X.contiguous()
    Yf = Y.to(device=dev, dtype=torch.float32)
    y2 = _row_sumsq(Yf).contiguous()
    Yf = Yf.to(X.dtype).to(torch.float32).contiguous()
    maskf = (torch.ones(m, dtype=torch.float32, device=dev) if mask is None
             else mask.to(device=dev, dtype=torch.float32).contiguous())
    if maskf.shape != (m,):
        raise ValueError(f"mask must be ({m},); got {tuple(maskf.shape)}")
    am = mn = mn2 = cw_part = cw = wf = gneed = x2f = None
    if epilogue != "min":
        am = torch.empty(n, dtype=torch.int32, device=dev)
    if epilogue != "argmin_weight":
        mn = torch.empty(n, dtype=torch.float32, device=dev)
    if epilogue == "argmin_min2":
        mn2 = torch.empty(n, dtype=torch.float32, device=dev)
    if epilogue == "argmin_weight":
        wf = w.to(device=dev, dtype=torch.float32).contiguous()
        if wf.shape != (n,):
            raise ValueError(f"w must be ({n},); got {tuple(wf.shape)}")
        cw = torch.empty(m, dtype=torch.float32, device=dev)
    if x2 is not None:
        x2f = x2.to(device=dev, dtype=torch.float32).contiguous()
        if x2f.shape != (n,):
            raise ValueError(f"x2 must be ({n},); got {tuple(x2f.shape)}")
    if row_need is not None and row_need.shape != (n,):
        raise ValueError(
            f"row_need must be ({n},); got {tuple(row_need.shape)}")
    outs = {"min": (mn,), "argmin_min": (am, mn),
            "argmin_weight": (am, cw), "argmin_min2": (am, mn, mn2)}[epilogue]
    if n == 0:
        if cw is not None:
            cw.zero_()
        return outs if len(outs) > 1 else outs[0]
    lib = build.load("fused_distance")
    if epilogue == "argmin_weight":
        nb = -(-n // lib.dml_fused_rows_per_block())
        cw_part = torch.empty((m, nb), dtype=torch.float32, device=dev)
    if row_need is not None:
        gneed = _group_need(row_need.to(dev)).to(torch.uint8).contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()

    code, default_counter = _EPILOGUES[epilogue]
    bf16 = X.dtype == torch.bfloat16
    err = lib.dml_fused_distance(
        code, ptr(X), int(bf16), ptr(Yf), ptr(y2), ptr(maskf), ptr(gneed),
        _FUSED_BLK, ptr(x2f), ptr(wf), n, m, d, ptr(am), ptr(mn), ptr(mn2),
        ptr(cw_part), ptr(cw), build.stream_of(X))
    build.check(err, f"fused distance kernel ({epilogue})")
    _kernels.count((counter or default_counter) + ("_bf16" if bf16 else ""))
    return outs if len(outs) > 1 else outs[0]


# ---------------------------------------------------------------------------
# public family
# ---------------------------------------------------------------------------


def fused_rowwise_min(X, Y, mask=None, *, kernel: str = "auto",
                      row_need=None):
    """Per-row ``min_j d²(x_i, y_j)`` over valid Y rows, shape (n,) f32.
    All-masked returns +inf per row. ``row_need`` (optional (n,) bool)
    skips ``_FUSED_BLK``-row groups with no needed row; their rows return
    +inf."""
    if _kernels.use_cuda(kernel, X):
        return _fused_cuda(X, Y, mask, "min", row_need=row_need)
    if row_need is None:
        return _min_ref(X, Y, mask)
    return _blocked_ref(lambda Xe: _min_ref(Xe, Y, mask), X, row_need,
                        (float("inf"),))


def fused_argmin_min(X, Y, mask=None, *, kernel: str = "auto"):
    """Per-row (argmin index int32, min squared distance f32) over valid Y
    rows. Ties break to the lowest index."""
    if _kernels.use_cuda(kernel, X):
        return _fused_cuda(X, Y, mask, "argmin_min")
    return _argmin_min_ref(X, Y, mask)


def fused_argmin_min2(X, Y, mask=None, *, kernel: str = "auto",
                      row_need=None):
    """Per-row (argmin int32, min d² f32, second-best d² f32) over valid Y
    rows — the bound-seeding primitive of bounded Lloyd. Same contracts
    as :func:`fused_argmin_min`; the second-best is the min over every
    valid target but the argmin (a later target tying the best gives
    second == best), +inf with one valid target, and all-masked gives
    (0, +inf, +inf). ``row_need`` skips ``_FUSED_BLK``-row groups with no
    needed row; their rows return zeros (overlay carried values through
    :func:`row_block_evaluated`)."""
    if _kernels.use_cuda(kernel, X):
        return _fused_cuda(X, Y, mask, "argmin_min2", row_need=row_need)
    if row_need is None:
        return _argmin_min2_ref(X, Y, mask)
    return _blocked_ref(lambda Xe: _argmin_min2_ref(Xe, Y, mask), X,
                        row_need, (0, 0.0, 0.0))


def fused_argmin_min_sketched(Z, vals, support=None, mask=None, *,
                              x2=None, kernel: str = "auto", row_need=None):
    """Per-row (argmin int32, min FULL-SPACE d² f32) against sketched
    targets ``vals`` (k, p) on one shared transform-column support (see
    :mod:`dask_ml_tpu_torch.ops.fast_transform`). The contraction runs
    over the p support columns, which is exact for the argmin; the value
    adds back the full-space ``|x − μ|²``.

    With ``support`` (p,) (distinct entries), ``Z`` (n, d_pad) is the
    fully transformed data: the support gather and (unless ``x2`` is
    given) the full-row |z|² happen here, outside the kernel. With
    ``support=None``, ``Z`` is the restricted (n, p) block and ``x2``
    (n,) is required. ``row_need`` skips groups as in
    :func:`fused_argmin_min2` (skipped rows return zeros). On the card
    this is the argmin_min kernel at (n, k, p) with ``x2`` as its
    external |x|²."""
    if support is not None:
        Zp = Z[:, support.to(device=Z.device, dtype=torch.long)]
        if x2 is None:
            x2 = _row_sumsq(Z)
    else:
        if x2 is None:
            raise ValueError(
                "fused_argmin_min_sketched: support=None means Z is the "
                "restricted (n, p) block; the full-space |x - mu|^2 must "
                "then be supplied via x2=")
        Zp = Z
    if _kernels.use_cuda(kernel, Zp):
        return _fused_cuda(Zp, vals, mask, "argmin_min", row_need=row_need,
                           x2=x2, counter="fused_argmin_min_sketched")
    if row_need is None:
        return _argmin_min_sk_ref(Zp, vals, x2, mask)
    return _blocked_ref(lambda Ze, xe: _argmin_min_sk_ref(Ze, vals, xe, mask),
                        Zp, row_need, (0, 0.0), x2)


def fused_argmin_weight(X, w, Y, mask=None, *, kernel: str = "auto"):
    """Per-row argmin (int32, (n,)) plus ``cw[j] = Σ_i w_i·[argmin_i == j]``
    (f32, (m,)). Masked targets always get ``cw == 0``. On the card the
    cross-block sum runs in a fixed order, so ``cw`` is bit-reproducible
    from run to run."""
    if _kernels.use_cuda(kernel, X):
        return _fused_cuda(X, Y, mask, "argmin_weight", w=w)
    return _argmin_weight_ref(X, w, Y, mask)

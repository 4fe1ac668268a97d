"""Fused distance-reduction family of the PyTorch port (counterpart of
``dask_ml_tpu/ops/fused_distance.py``).

Squared Euclidean distances from n query rows X to m target rows Y,
reduced along the target axis before the (n × m) matrix ever exists:

- :func:`fused_rowwise_min` — per-row min d² (k-means|| rounds), with the
  optional ``row_need`` block skip;
- :func:`fused_argmin_min` — per-row (argmin int32, min d²) (assignment,
  ``predict_labels``);
- :func:`fused_argmin_weight` — per-row argmin plus the per-target sum of
  row weights (k-means|| candidate weighting).

Each takes ``kernel="auto" | "cuda" | "torch"``. ``"auto"`` launches the
hand-written CUDA kernel (``_kernels/csrc/fused_distance.cu``) for a CUDA
tensor and runs the plain PyTorch version for a CPU tensor; ``"cuda"``
insists on the kernel; ``"torch"`` runs the plain version wherever the
tensor lies (the card's reference run in ``chip_smoke.py``). A build or
launch error raises: nothing here gives way to the plain version.

Score convention, shared by the kernel and the plain versions so ties
break identically: the reduction runs over ``s_j = |y_j|² − 2·x·y_j`` with
``|y|²`` in f32 from the ORIGINAL Y; ``|x|²`` is added back only to the
returned min value, which is clamped at 0 against cancellation. Masked
targets score +inf and never win; ties go to the lowest index; when every
target is masked the argmin is 0 and the min is +inf. Indices are int32 at
every public function (``torch.argmin`` gives int64).

``row_need`` skips work in groups of ``_FUSED_BLK`` rows whatever tile the
kernel uses: a group with no needed row returns +inf for every row (the
identity of the caller's running minimum); rows that share a group with a
needed row get the full answer (:func:`row_block_evaluated`).
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
              "argmin_weight": (2, "fused_argmin_weight")}


# ---------------------------------------------------------------------------
# plain PyTorch versions (the reference every kernel is held against)
# ---------------------------------------------------------------------------


def _row_sumsq(X):
    """Per-row Σx² in f32."""
    Xf = X.to(torch.float32)
    return (Xf * Xf).sum(dim=1)


def _scores_ref(X, Y, mask):
    """(n, m) reduction scores ``|y|² − 2·x·y`` with masked targets at
    +inf; ``|y|²`` comes from the original Y in f32."""
    y2 = _row_sumsq(Y)
    prod = X.to(torch.float32) @ Y.to(torch.float32).T
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


def _blocked_min_ref(X, Y, mask, row_need):
    """Plain ``row_need`` path of :func:`fused_rowwise_min`: only the rows
    of evaluated groups are computed; the others return +inf."""
    ev = row_block_evaluated(row_need)
    out = torch.full((X.shape[0],), float("inf"), dtype=torch.float32,
                     device=X.device)
    out[ev] = _min_ref(X[ev], Y, mask)
    return out


# ---------------------------------------------------------------------------
# the CUDA kernel (K2 argmin_min, K3 min, K4 argmin_weight)
# ---------------------------------------------------------------------------


def _use_cuda(kernel: str, X) -> bool:
    if kernel not in ("auto", "cuda", "torch"):
        raise ValueError(f"kernel must be auto|cuda|torch, got {kernel!r}")
    if kernel == "torch":
        return False
    if X.is_cuda:
        return True
    if kernel == "cuda":
        raise ValueError(
            f"kernel='cuda' needs CUDA tensors; X lies on {X.device}")
    return False


def _fused_cuda(X, Y, mask, epilogue: str, w=None, row_need=None):
    """Launch ``csrc/fused_distance.cu`` — replaces the TPU kernel
    ``dask_ml_tpu/ops/fused_distance.py::_fused_pallas`` (epilogues
    ``min``, ``argmin_min``, ``argmin_weight``). See the source for what
    bounds it on the H100 and how the design answers that. Outputs and
    scratch are allocated here; the kernel runs on PyTorch's current
    stream and does not synchronise."""
    from dask_ml_tpu_torch._kernels import build

    if X.dtype != torch.float32 or X.dim() != 2:
        raise ValueError(
            f"the fused distance kernel takes 2-D float32 X; got "
            f"{X.dtype} of shape {tuple(X.shape)}")
    n, d = X.shape
    m = Y.shape[0]
    if Y.dim() != 2 or Y.shape[1] != d or m < 1:
        raise ValueError(
            f"Y must be (m >= 1, {d}); got shape {tuple(Y.shape)}")
    if n >= 2**31 or m >= 2**31:
        raise ValueError("the fused distance kernel takes n, m < 2**31")
    dev = X.device
    X = X.contiguous()
    Yf = Y.to(device=dev, dtype=torch.float32).contiguous()
    y2 = _row_sumsq(Yf).contiguous()
    maskf = (torch.ones(m, dtype=torch.float32, device=dev) if mask is None
             else mask.to(device=dev, dtype=torch.float32).contiguous())
    if maskf.shape != (m,):
        raise ValueError(f"mask must be ({m},); got {tuple(maskf.shape)}")
    am = mn = cw_part = cw = wf = gneed = None
    if epilogue != "min":
        am = torch.empty(n, dtype=torch.int32, device=dev)
    if epilogue != "argmin_weight":
        mn = torch.empty(n, dtype=torch.float32, device=dev)
    if epilogue == "argmin_weight":
        wf = w.to(device=dev, dtype=torch.float32).contiguous()
        if wf.shape != (n,):
            raise ValueError(f"w must be ({n},); got {tuple(wf.shape)}")
        cw = torch.empty(m, dtype=torch.float32, device=dev)
    if n == 0:
        if cw is not None:
            cw.zero_()
            return am, cw
        return (am, mn) if am is not None else mn
    lib = build.load("fused_distance")
    if epilogue == "argmin_weight":
        nb = -(-n // lib.dml_fused_rows_per_block())
        cw_part = torch.empty((m, nb), dtype=torch.float32, device=dev)
    if row_need is not None:
        if row_need.shape != (n,):
            raise ValueError(
                f"row_need must be ({n},); got {tuple(row_need.shape)}")
        gneed = _group_need(row_need.to(dev)).to(torch.uint8).contiguous()

    def ptr(t):
        return None if t is None else t.data_ptr()

    code, counter = _EPILOGUES[epilogue]
    err = lib.dml_fused_distance(
        code, ptr(X), ptr(Yf), ptr(y2), ptr(maskf),
        ptr(gneed), _FUSED_BLK, ptr(wf), n, m, d, ptr(am), ptr(mn),
        ptr(cw_part), ptr(cw), build.stream_of(X))
    build.check(err, f"fused distance kernel ({epilogue})")
    _kernels.launches[counter] += 1
    if epilogue == "min":
        return mn
    if epilogue == "argmin_min":
        return am, mn
    return am, cw


# ---------------------------------------------------------------------------
# public family
# ---------------------------------------------------------------------------


def fused_rowwise_min(X, Y, mask=None, *, kernel: str = "auto",
                      row_need=None):
    """Per-row ``min_j d²(x_i, y_j)`` over valid Y rows, shape (n,) f32.
    All-masked returns +inf per row. ``row_need`` (optional (n,) bool)
    skips ``_FUSED_BLK``-row groups with no needed row; their rows return
    +inf."""
    if _use_cuda(kernel, X):
        return _fused_cuda(X, Y, mask, "min", row_need=row_need)
    if row_need is None:
        return _min_ref(X, Y, mask)
    return _blocked_min_ref(X, Y, mask, row_need)


def fused_argmin_min(X, Y, mask=None, *, kernel: str = "auto"):
    """Per-row (argmin index int32, min squared distance f32) over valid Y
    rows. Ties break to the lowest index."""
    if _use_cuda(kernel, X):
        return _fused_cuda(X, Y, mask, "argmin_min")
    return _argmin_min_ref(X, Y, mask)


def fused_argmin_weight(X, w, Y, mask=None, *, kernel: str = "auto"):
    """Per-row argmin (int32, (n,)) plus ``cw[j] = Σ_i w_i·[argmin_i == j]``
    (f32, (m,)). Masked targets always get ``cw == 0``. On the card the
    cross-block sum runs in a fixed order, so ``cw`` is bit-reproducible
    from run to run."""
    if _use_cuda(kernel, X):
        return _fused_cuda(X, Y, mask, "argmin_weight", w=w)
    return _argmin_weight_ref(X, w, Y, mask)

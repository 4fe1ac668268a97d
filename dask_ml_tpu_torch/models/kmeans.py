"""KMeans functional core of the PyTorch port: Lloyd iterations (plain,
single-pass and bounded), sketched assignment and the k-means||
initialization (counterpart of ``dask_ml_tpu/models/kmeans.py``).

Plain functions on tensors. Every distance-and-reduce step goes through
the fused family (:mod:`dask_ml_tpu_torch.ops.fused_distance`), and one
Lloyd iteration over the data is one launch of the single-pass kernel
``_kernels/csrc/lloyd.cu`` on the card. Loops that the JAX package runs as
``lax.while_loop`` / ``fori_loop`` on the device are Python loops here;
the Lloyd loops read ``shift`` back to the host once an iteration for the
reference's stopping rule ``shift < tol``.

Random numbers come from an explicit ``torch.Generator``. PyTorch's
generator (Philox) cannot reproduce ``jax.random``'s threefry bits, so
k-means|| is held to the reference by the quality of its result and by
determinism under a seed, while the Lloyd loops are held to it bit for
bit from a shared ``init=`` array.

Rows with weight 0 contribute nothing to sums, counts or inertia.

**Over a mesh** (``mesh=``, :mod:`~dask_ml_tpu_torch.parallel.mesh`) X
and w are this rank's block of the row-sharded data, and every kernel
launches on the block as it does on the whole data. The cross-shard sums
go through :func:`~dask_ml_tpu_torch.parallel.hierarchy.hpsum` (ledger ops
``kmeans.mstep``, ``kmeans.inertia``, ``kmeans.stats``, ``kmeans.tol``,
``kmeans.init.seed``, ``kmeans.init.rounds``, ``kmeans.init.stats``,
``fused.argmin_weight``), and gathers of per-row results through
:func:`~dask_ml_tpu_torch.parallel.hierarchy.gather_blocks`. A fit does
not depend on the world size: the k-means|| draws are made over the whole
data by every rank from the same generator (each takes its slice), the
candidate rows are placed by a global prefix of the hit counts, and
``compute_inertia`` sums the per-row costs in the one order of a single
device. So on integer-valued data (where every cross-shard sum of the
loops is exact) world 1, 2, 3 and 4 give the same centers, labels,
``n_iter`` and inertia, bit for bit.
"""

from __future__ import annotations

import logging
from typing import Optional

import numpy as np
import torch

from dask_ml_tpu_torch import _kernels
from dask_ml_tpu_torch.ops.fused_distance import (
    _row_blocks,
    _row_sumsq,
    fused_argmin_min,
    fused_argmin_min2,
    fused_argmin_min_sketched,
    fused_argmin_weight,
    fused_rowwise_min,
    row_block_evaluated,
)
from dask_ml_tpu_torch.parallel import mesh as mesh_lib
from dask_ml_tpu_torch.parallel import telemetry
from dask_ml_tpu_torch.parallel.hierarchy import (
    gather_blocks,
    hpsum,
    mpgather,
    mpsum,
)
from dask_ml_tpu_torch.parallel.mesh import is_sharded

logger = logging.getLogger(__name__)

_INF = float("inf")


# ---------------------------------------------------------------------------
# Lloyd iterations
# ---------------------------------------------------------------------------


def _assign(X, w, centers, kernel: str = "auto"):
    """Labels, weighted min-distances and inertia through the fused
    family."""
    labels, mind = fused_argmin_min(X, centers, kernel=kernel)
    return labels, mind, (mind * w).sum()


def _new_centers(sums, counts, centers):
    """THE M-step finalization shared by every Lloyd implementation.
    Counts are weighted sums and may be in (0, 1); only exact zeros are
    empty clusters, which keep their old center."""
    occupied = counts > 0
    safe = torch.where(occupied, counts, torch.ones_like(counts))
    return torch.where(occupied[:, None], sums / safe[:, None], centers)


def _weighted_sums(X, w, labels, k: int):
    """Per-cluster weighted (k, d) sums and (k,) counts by a one-hot
    matmul, in f32 whatever X's dtype (a bf16 X is widened: the sums are
    those of the JAX fused and bounded loops, which the single-pass kernel
    computes too)."""
    onehot = (torch.nn.functional.one_hot(labels.long(), k)
              .to(torch.float32) * w[:, None])
    return onehot.T @ X.to(torch.float32), onehot.sum(dim=0)


def _m_step(X, w, labels, centers):
    """Weighted one-hot-matmul M-step."""
    sums, counts = _weighted_sums(X, w, labels, centers.shape[0])
    return _new_centers(sums, counts, centers), counts


def lloyd_step(X, w, centers, kernel: str = "auto"):
    """One Lloyd iteration. Returns (new_centers, labels, inertia, shift)."""
    labels, _, inertia = _assign(X, w, centers, kernel=kernel)
    new_centers, _ = _m_step(X, w, labels, centers)
    shift = ((new_centers - centers) ** 2).sum()
    return new_centers, labels, inertia, shift


def _tol_tensor(tol, device):
    return torch.as_tensor(tol, dtype=torch.float32, device=device)


def lloyd_loop(X, w, centers, tol, max_iter: int, kernel: str = "auto"):
    """Lloyd over a small problem through :func:`lloyd_step` (the k-means||
    finishing pass over the candidate buffer). Returns (centers, inertia,
    n_iter, shift); stops when ``shift < tol`` or after ``max_iter``."""
    centers = centers.to(torch.float32)
    tol_t = _tol_tensor(tol, centers.device)
    inertia = torch.tensor(_INF, device=centers.device)
    shift = torch.tensor(_INF, device=centers.device)
    it = 0
    while it < max_iter and bool(shift >= tol_t):
        centers, _, inertia, shift = lloyd_step(X, w, centers, kernel=kernel)
        it += 1
    return centers, inertia, it, shift


def _lloyd_stats_ref(X, w, centers):
    """Plain version of one single-pass Lloyd iteration: the weighted
    (k, d) sums, (k,) counts and the inertia of assigning X to
    ``centers``. With bf16 X the product takes the centers cast to bf16,
    ``|c|²`` comes from the f32 centers, and the sums and ``|x|²`` are
    those of X widened to f32 (the JAX kernel's bf16 case)."""
    k = centers.shape[0]
    Xf = X.to(torch.float32)
    c2 = (centers * centers).sum(dim=1)
    Cc = centers.to(X.dtype).to(torch.float32)
    scores = c2[:, None] - 2.0 * (Cc @ Xf.T)  # (k, n)
    best = scores.argmin(dim=0)
    oh_w = ((torch.arange(k, device=X.device)[:, None] == best[None, :])
            .to(torch.float32) * w[None, :])
    sums = oh_w @ Xf
    counts = oh_w.sum(dim=1)
    x2 = (Xf * Xf).sum(dim=1)
    mind = torch.clamp(scores.min(dim=0).values + x2, min=0.0)
    return sums, counts, (mind * w).sum()


def _lloyd_cuda_supported(k: int, d: int, dtype=torch.float32) -> bool:
    """Does the single-pass kernel's shared-memory budget hold (k, d) for
    X of ``dtype`` (a bf16 tile takes half the bytes)?"""
    from dask_ml_tpu_torch._kernels import build

    return bool(build.load("lloyd").dml_lloyd_supported(
        k, d, int(dtype == torch.bfloat16)))


def _lloyd_stats_cuda(X, w, centers):
    """Launch ``csrc/lloyd.cu`` — replaces the TPU kernel
    ``dask_ml_tpu/models/kmeans.py::_lloyd_iter_pallas``. One pass over X
    computes the sums, counts and inertia; a second, fixed-order launch
    reduces the per-block partials (bit-reproducible). ``|c|²`` is
    :func:`_row_sumsq` of the centers, as the fused distance kernels take
    it, so from the same centers the kernel's argmins are K2's bits. See
    the source for what bounds it on the H100. A bf16 X is the kernel's
    bf16 case (counted as ``lloyd_iter_bf16``): the centers are passed
    rounded to bf16, ``|c|²`` from the f32 centers."""
    from dask_ml_tpu_torch._kernels import build

    n, d = X.shape
    k = centers.shape[0]
    bf16 = X.dtype == torch.bfloat16
    if (X.dtype not in (torch.float32, torch.bfloat16)
            or w.dtype != torch.float32
            or not X.is_cuda or w.device != X.device
            or centers.device != X.device
            or not X.is_contiguous() or not w.is_contiguous()
            or w.shape != (n,) or centers.shape != (k, d)):
        raise ValueError(
            "the Lloyd kernel takes contiguous float32 or bfloat16 X "
            "(n, d), float32 w (n,) "
            f"and centers (k, d) on one CUDA device; got X {X.dtype} "
            f"{tuple(X.shape)} on {X.device}, w {w.dtype} {tuple(w.shape)} "
            f"on {w.device}, centers {tuple(centers.shape)} on "
            f"{centers.device}")
    if not 0 < n < 2**31:
        raise ValueError(f"the Lloyd kernel takes 0 < n < 2**31; got {n}")
    lib = build.load("lloyd")
    if not lib.dml_lloyd_supported(k, d, int(bf16)):
        raise ValueError(
            f"kernel='cuda': k={k}, d={d} exceeds the Lloyd kernel's "
            "shared-memory budget (centers + a (k, d+1) accumulator + one "
            "128-row tile of X); use kernel='auto' for the two-pass form")
    C = centers.to(torch.float32)
    c2 = _row_sumsq(C).contiguous()
    C = C.to(X.dtype).to(torch.float32).contiguous()
    P = k * (d + 1) + 1
    partial = torch.empty(lib.dml_lloyd_max_partials() * P,
                          dtype=torch.float32, device=X.device)
    out = torch.empty(P, dtype=torch.float32, device=X.device)
    code = lib.dml_lloyd_iter(X.data_ptr(), int(bf16), w.data_ptr(),
                              C.data_ptr(), c2.data_ptr(), n, k, d,
                              partial.data_ptr(), out.data_ptr(),
                              build.stream_of(X))
    build.check(code, "Lloyd kernel")
    _kernels.count("lloyd_iter_bf16" if bf16 else "lloyd_iter")
    acc = out[:-1].view(k, d + 1)
    return acc[:, :d], acc[:, d], out[-1]


def _lloyd_stats_two_pass(X, w, centers):
    """The card's form beyond the single-pass kernel's bound (the
    counterpart of the JAX ``"xla"`` branch): the assignment runs through
    the fused argmin kernel, the M-step is a one-hot matmul."""
    labels, mind = fused_argmin_min(X, centers, kernel="cuda")
    sums, counts = _weighted_sums(X, w, labels, centers.shape[0])
    return sums, counts, (mind * w).sum()


def _lloyd_stats_fn(X, k: int, d: int, kernel: str):
    if kernel not in ("auto", "cuda", "torch"):
        raise ValueError(f"kernel must be auto|cuda|torch, got {kernel!r}")
    if kernel == "torch":
        return _lloyd_stats_ref
    if not X.is_cuda:
        if kernel == "cuda":
            raise ValueError(
                f"kernel='cuda' needs CUDA tensors; X lies on {X.device}")
        return _lloyd_stats_ref
    if kernel == "cuda" or _lloyd_cuda_supported(k, d, X.dtype):
        return _lloyd_stats_cuda
    return _lloyd_stats_two_pass


def lloyd_loop_fused(X, w, centers0, tol, *, max_iter: int,
                     kernel: str = "auto", mesh=None,
                     shard_features: bool = False):
    """Lloyd over the full data, one single-pass kernel launch per
    iteration on the card (``kernel="auto"`` or ``"cuda"``; beyond the
    kernel's shared-memory bound ``"auto"`` takes the two-pass form, and
    ``"cuda"`` raises). On the CPU, or with ``kernel="torch"``, each
    iteration runs the plain version. ``shift`` is read back to the host
    once an iteration for the stopping rule — one device sync per
    iteration. Returns (centers, inertia, n_iter, shift).

    With ``mesh`` each rank runs the kernel on its block and the three
    M-step operands (sums, counts, inertia) are summed over the sample
    axes, ``hpsum(op="kmeans.mstep")``, before the centers update: every
    rank then holds the same centers. ``shard_features=True`` on a mesh
    with a ``model`` axis runs the feature-parallel route
    (:func:`_lloyd_loop_features`), the JAX package's non-kernel route:
    ``kernel="cuda"`` refuses it."""
    k, d = centers0.shape
    if (shard_features and mesh is not None
            and mesh_lib.has_model_axis(mesh)):
        if kernel not in ("auto", "cuda", "torch"):
            raise ValueError(
                f"kernel must be auto|cuda|torch, got {kernel!r}")
        if kernel == "cuda":
            raise ValueError(
                "kernel='cuda' does not compose with feature sharding (the "
                "single-pass kernel accumulates d-global state); use "
                "kernel='auto' or 'torch'")
        return _lloyd_loop_features(X, w, centers0, tol, max_iter=max_iter,
                                    mesh=mesh)
    stats = _lloyd_stats_fn(X, k, d, kernel)
    centers = centers0.to(torch.float32)
    tol_t = _tol_tensor(tol, centers.device)
    inertia = torch.tensor(_INF, device=centers.device)
    shift = torch.tensor(_INF, device=centers.device)
    it = 0
    while it < max_iter and bool(shift >= tol_t):
        sums, counts, inertia = stats(X, w, centers)
        if mesh is not None:
            sums = hpsum(sums, mesh, op="kmeans.mstep")
            counts = hpsum(counts, mesh, op="kmeans.mstep")
            inertia = hpsum(inertia, mesh, op="kmeans.mstep")
        new_centers = _new_centers(sums, counts, centers)
        shift = ((new_centers - centers) ** 2).sum()
        centers = new_centers
        it += 1
    return centers, inertia, it, shift


def _lloyd_loop_features(X, w, centers0, tol, *, max_iter: int, mesh):
    """The feature-parallel Lloyd loop (the JAX ``shard_features`` branch):
    X is this rank's (rows, columns) block, ``centers0`` the full
    (k, d_padded) centers, of which each rank keeps its column slice. The
    per-row ``|x|²`` (once) and each iteration's partial scores
    ``|c|² − 2x·c`` are summed over the model axis (``mpsum``, ops
    ``kmeans.x2`` / ``kmeans.scores``), so the argmin, counts and inertia
    agree on every model shard; the M-step sums stay column-local and go
    over the sample axes (``hpsum``, op ``kmeans.mstep``), the shift over
    the model axis (``kmeans.shift``). ``torch.matmul`` and ``argmin``:
    the JAX route is its XLA path, not a kernel. Returns the full centers
    (gathered over the model axis, ``kmeans.centers``), inertia, n_iter
    and shift."""
    k = centers0.shape[0]
    cols = mesh_lib.feature_sharding(mesh).cols(centers0.shape[1])
    if centers0.shape[1] // mesh_lib.n_model_shards(mesh) != X.shape[1]:
        raise ValueError(
            f"centers0 has {centers0.shape[1]} columns; the feature-sharded "
            f"X block has {X.shape[1]} of {mesh_lib.n_model_shards(mesh)} "
            "column blocks (pad the centers' columns as prepare_data pads "
            "X's)")
    Xf = X.to(torch.float32)
    x2 = mpsum(_row_sumsq(X), mesh, op="kmeans.x2")
    kidx = torch.arange(k, device=X.device)[:, None]
    centers = centers0.to(device=X.device, dtype=torch.float32)[:, cols]
    tol_t = _tol_tensor(tol, X.device)
    inertia = torch.tensor(_INF, device=X.device)
    shift = torch.tensor(_INF, device=X.device)
    it = 0
    while it < max_iter and bool(shift >= tol_t):
        cx = centers.to(X.dtype).to(torch.float32)
        c2 = (centers * centers).sum(dim=1)
        scores = mpsum(c2[:, None] - 2.0 * (cx @ Xf.T), mesh,
                       op="kmeans.scores")  # (k, n_loc)
        best = scores.argmin(dim=0)
        oh_w = (kidx == best[None, :]).to(torch.float32) * w[None, :]
        sums = hpsum(oh_w @ Xf, mesh, op="kmeans.mstep")
        counts = hpsum(oh_w.sum(dim=1), mesh, op="kmeans.mstep")
        mind = torch.clamp(scores.min(dim=0).values + x2, min=0.0)
        inertia = hpsum((mind * w).sum(), mesh, op="kmeans.mstep")
        new_centers = _new_centers(sums, counts, centers)
        shift = mpsum(((new_centers - centers) ** 2).sum(), mesh,
                      op="kmeans.shift")
        centers = new_centers
        it += 1
    return (mpgather(centers, mesh, op="kmeans.centers", axis=1), inertia,
            it, shift)


def compute_inertia(X, w, centers, kernel: str = "auto", mesh=None,
                    n_valid=None):
    """Weighted cost of assigning X to ``centers`` (a 0-d tensor).

    Over more than one data shard each rank runs the argmin kernel on its
    block, the per-row costs ``w·min d²`` are gathered (op
    ``kmeans.inertia``), and every rank sums the first ``n_valid`` of them
    (default: all rows) in the one order a single device sums them: the
    inertia does not depend on the world size."""
    if not is_sharded(mesh):
        return _assign(X, w, centers, kernel=kernel)[2]
    _, mind = fused_argmin_min(X, centers, kernel=kernel)
    rows = gather_blocks(mind * w, mesh, op="kmeans.inertia")
    return rows[:n_valid].sum()


def predict_labels(X, centers, kernel: str = "auto", mesh=None,
                   n_valid=None):
    """Nearest-center labels, int32. Over more than one data shard each
    rank labels its block and the labels of every block are gathered (op
    ``kmeans.labels``): every rank returns the first ``n_valid`` (default:
    all rows)."""
    labels = fused_argmin_min(X, centers, kernel=kernel)[0]
    if not is_sharded(mesh):
        return labels
    return gather_blocks(labels, mesh, op="kmeans.labels")[:n_valid]


def _mean_feature_variance(X, w, mesh=None):
    def total(t):
        return t if mesh is None else hpsum(t, mesh, op="kmeans.tol")

    sw = total(w.sum())
    mean = total((w[:, None] * X).sum(dim=0)) / sw
    var = total((w[:, None] * (X - mean) ** 2).sum(dim=0)) / sw
    return var.mean()


def scaled_tolerance(X, w, tol, mesh=None):
    """``tol`` scaled by the mean per-feature variance of the weighted
    data, as sklearn and the reference do (a 0-d f32 tensor); with
    ``mesh`` the weighted sums run over every shard (op ``kmeans.tol``),
    X being this rank's row block."""
    return tol * _mean_feature_variance(X, w, mesh)


# ---------------------------------------------------------------------------
# Batched candidate cells (the search driver's fast path)
# ---------------------------------------------------------------------------


def _device_vector(values, dtype, device):
    """A short host list as a tensor on ``device``, copied without waiting
    on the card."""
    host = torch.tensor(values, dtype=dtype)
    if device.type == "cuda":
        host = host.pin_memory()
    return host.to(device, non_blocking=True)


def batched_lloyd_cells(data, members, eval_sets, *, max_iter: int,
                        generator=None, idx0=None, kernel: str = "auto"):
    """Every ``(n_clusters, tol)`` KMeans candidate over one training set,
    fit and scored with no host read (the JAX ``batched_lloyd_cells``).

    - **One trajectory a unique ``n_clusters``.** Candidates differing
      only in ``tol`` follow the same Lloyd trajectory and differ only in
      where they stop, so each unique k runs ``max_iter`` iterations from
      its init, recording the centers, ``shift`` and inertia of every
      step; each iteration is one :func:`_lloyd_stats_fn` call on the
      trajectory's own ``(k, d)`` centers — on the card the single-pass
      Lloyd kernel (``csrc/lloyd.cu``). Nothing pads k to a common width:
      eager PyTorch compiles nothing per shape.
    - **Stops selected on the device.** Member m stops at the first t
      with ``shift_t < tol_m`` (else at ``max_iter − 1``), the single-fit
      loop's rule; ``tol`` is scaled on the device by the mean feature
      variance. The JAX program freezes a trajectory once every member
      has stopped; here every trajectory runs all ``max_iter`` steps,
      since skipping one would need a host read, and the steps after the
      last stop are never selected.
    - **Scores on the device.** Each member's final centers are gathered
      at its stop, and each eval set is scored through the fused
      argmin/min family (K2 on the card), as ``KMeans.score`` scores.

    The init: ``idx0`` (the first ``max(k)`` entries of a permutation of
    the rows) if given — the tests hand in the JAX package's draw — else
    ``torch.randperm(n, generator=generator)``, the draw of
    :func:`init_random`. Trajectory k starts from the rows
    ``sort(idx0[:k])``, which is :func:`init_random`'s choice, so a member
    follows a standalone ``KMeans(init="random", random_state=s)`` fit.

    ``data`` is the staged training :class:`DeviceData`, ``members`` a
    list of ``(n_clusters, tol)``, ``eval_sets`` staged DeviceData.
    Returns ``(n_iters (M,), train_inertia (M,), [eval inertias (M,)])``
    as device tensors; the train inertia is that of the centers before
    the last update, as the single-pass kernel reports it.

    **Over a mesh** (``data.mesh`` of more than one data shard, and each
    eval set staged over the same mesh) every rank runs every
    trajectory's K1 on its own block. Each step's sums, counts and
    inertias of all trajectories go through one ``hpsum`` (op
    ``kmeans.batched``: one collective a step, not one a trajectory), so
    every rank holds the same centers. The init rows are global row ids:
    their owner fills them in and every other rank adds zeros (op
    ``kmeans.batched.init``, exact). Each eval set's per-row costs of
    every member are gathered once (op ``kmeans.batched.eval``) and
    summed in the one order :func:`compute_inertia` sums them. So on
    integer data a world of ranks gives the single device's results bit
    for bit.
    """
    if not members:
        raise ValueError("batched_lloyd_cells takes at least one member")
    mesh = getattr(data, "mesh", None)
    if not is_sharded(mesh):
        mesh = None
    X, w = data.X, data.weights
    dev = X.device
    d = int(X.shape[1])
    ks = [int(k) for k, _ in members]
    uks = sorted(set(ks))
    max_k = max(uks)
    T = int(max_iter)
    if idx0 is None:
        idx0 = torch.randperm(data.n, generator=generator, device=dev)
    elif not isinstance(idx0, torch.Tensor):
        idx0 = _device_vector(np.asarray(idx0).tolist(), torch.int64, dev)
    idx0 = idx0[:max_k].to(device=dev, dtype=torch.int64)
    tol_arr = (_device_vector([float(t) for _, t in members], torch.float32,
                              dev) * _mean_feature_variance(X, w, mesh))
    member_u = _device_vector([uks.index(k) for k in ks], torch.int64, dev)

    stats_fns, centers, hists, shifts, inertias = [], [], [], [], []
    for k in uks:
        stats_fns.append(_lloyd_stats_fn(X, k, d, kernel))
        rows = torch.sort(idx0[:k]).values
        if mesh is None:
            centers.append(torch.index_select(X, 0, rows).to(torch.float32))
        else:
            centers.append(_rows_by_owner(X, rows, data.row_offset, mesh,
                                          "kmeans.batched.init"))
        hists.append([])
        shifts.append([])
        inertias.append([])
    with telemetry.span("kmeans-batched-trajectories", ks=len(uks),
                        steps=T):
        for _ in range(T):
            parts = [stats(X, w, c) for stats, c in zip(stats_fns, centers)]
            if mesh is not None:
                parts = _sum_stats_once(parts, mesh)
            for u, (sums, counts, inertia) in enumerate(parts):
                new_centers = _new_centers(sums, counts, centers[u])
                shifts[u].append(((new_centers - centers[u]) ** 2).sum())
                inertias[u].append(inertia)
                hists[u].append(new_centers)
                centers[u] = new_centers
    hists = [torch.stack(h) for h in hists]  # each (T, k, d)
    shifts = torch.stack([torch.stack(s) for s in shifts])  # (U, T)
    inertias = torch.stack([torch.stack(i) for i in inertias])  # (U, T)

    below = shifts[member_u] < tol_arr[:, None]  # (M, T)
    first = torch.argmax(below.to(torch.int32), dim=1)
    stop = torch.where(below.any(dim=1), first,
                       torch.full_like(first, T - 1))
    n_iters = stop + 1
    train_inertia = inertias[member_u, stop]
    centers_m = [torch.index_select(hists[uks.index(k)], 0, stop[m:m + 1])[0]
                 for m, k in enumerate(ks)]
    evals = []
    for e in eval_sets:
        if mesh is None:
            evals.append(torch.stack([compute_inertia(e.X, e.weights, c,
                                                      kernel=kernel)
                                      for c in centers_m]))
            continue
        costs = torch.stack([fused_argmin_min(e.X, c, kernel=kernel)[1]
                             * e.weights for c in centers_m], dim=1)
        every = gather_blocks(costs, mesh, op="kmeans.batched.eval")[:e.n]
        evals.append(torch.stack([every[:, m].contiguous().sum()
                                  for m in range(len(centers_m))]))
    return n_iters, train_inertia, evals


def _rows_by_owner(X, rows, row_offset: int, mesh, op: str):
    """The rows at global ids ``rows`` (a tensor) of the row-sharded data,
    as f32, on every rank: the rank that holds a row fills it in, every
    other rank adds zeros, and one ``hpsum`` adds them up (exact)."""
    local = rows - int(row_offset)
    mine = (local >= 0) & (local < X.shape[0])
    picked = torch.index_select(X, 0, torch.where(mine, local,
                                                  torch.zeros_like(local)))
    buf = torch.where(mine[:, None], picked.to(torch.float32),
                      torch.zeros((), dtype=torch.float32, device=X.device))
    return hpsum(buf, mesh, op=op)


def _sum_stats_once(parts, mesh):
    """Every trajectory's (sums, counts, inertia) partials summed over the
    sample axes by one ``hpsum`` of their concatenation (op
    ``kmeans.batched``), split back into the same shapes."""
    flat = torch.cat([t.reshape(-1) for part in parts for t in part])
    total = hpsum(flat, mesh, op="kmeans.batched")
    out, at = [], 0
    for part in parts:
        got = []
        for t in part:
            got.append(total[at:at + t.numel()].reshape(t.shape))
            at += t.numel()
        out.append(tuple(got))
    return out


# ---------------------------------------------------------------------------
# Bound-based Lloyd: skip distance work with Elkan/Yinyang center-movement
# bounds (arxiv 2105.02936, arxiv 1605.02989)
# ---------------------------------------------------------------------------

#: relative inflation of every bound-side quantity (seeds and movement
#: decrements): a row is skipped only when its margin clears the f32
#: rounding of the sqrt and the movement norms with room to spare
_BOUND_SLACK = 1e-5

#: absolute slack on the seeded squared distances, scaled by the operands'
#: magnitudes ``|x|² + max|c|²``: ``|c|² − 2x·c + |x|²`` cancels, so its
#: f32 error is relative to the norms, not to the distance
_BOUND_EPS_ABS = 1e-5


def _bounded_auto_wins(n: int, k: int, d: int) -> bool:
    """Does ``algorithm='auto'`` take the bounded loop? The JAX package's
    cold-start rule (the port has no decisions cache): n ≥ 2^16 and
    k ≥ 4."""
    return n >= (1 << 16) and k >= 4


def _bounded_groups(k: int, groups):
    """(G, size) of the Yinyang center grouping: ``'auto'`` takes
    t = ⌈k/10⌉ groups, an int clips to [1, k]. Centers are grouped by
    contiguous index (``gid = arange(k) // size``)."""
    if groups == "auto":
        G = max(1, -(-k // 10))
    else:
        G = max(1, min(int(groups), k))
    size = -(-k // G)
    return -(-k // size), size


def _bounded_need(ub, lb, w_pos, *, prune: bool):
    """The Yinyang global filter: a row needs distance work unless its
    upper bound is strictly below its tightest group lower bound (at
    equality the true distances may tie, and the tie is the oracle's to
    break)."""
    if not prune:
        return w_pos
    return w_pos & (ub >= lb.min(dim=1).values)


def _bounded_assign(X_pad, x2_pad, centers, labels, ub, lb, w_pos, *,
                    kernel: str, prune: bool):
    """One bounded assignment step: evaluate the groups of rows the bounds
    cannot clear through :func:`fused_argmin_min2`, keep the carried
    labels and bounds of skipped groups, and reseed the bounds of
    evaluated rows (upper = best distance, every group lower = the global
    second-best, each with the magnitude-scaled slack). Returns (labels,
    ub, lb, rows_skipped, bounds_held); the counts are 0-d tensors."""
    s = _BOUND_SLACK
    need = _bounded_need(ub, lb, w_pos, prune=prune)
    idx, d1, d2 = fused_argmin_min2(X_pad, centers, row_need=need,
                                    kernel=kernel)
    ev = row_block_evaluated(need)
    labels = torch.where(ev, idx, labels)
    c2max = (centers * centers).sum(dim=1).max()
    slack_sq = _BOUND_EPS_ABS * (x2_pad + c2max)
    bdt = ub.dtype
    ub = torch.where(ev, (torch.sqrt(d1 + slack_sq) * (1 + s)).to(bdt), ub)
    lb_seed = (torch.sqrt(torch.clamp(d2 - slack_sq, min=0.0))
               * (1 - s)).to(bdt)
    lb = torch.where(ev[:, None], lb_seed[:, None], lb)
    skipped = (w_pos & ~ev).sum()
    held = (w_pos & ~need).sum()
    return labels, ub, lb, skipped, held


def _bounded_move(ub, lb, labels, centers, new_centers, gid, G: int):
    """Center-movement maintenance: the upper bound grows by the assigned
    center's movement, each group lower bound shrinks by its group's
    largest movement (inflated by the slack)."""
    delta = (torch.sqrt(((new_centers - centers) ** 2).sum(dim=1))
             * (1 + _BOUND_SLACK))
    dg = torch.zeros(G, dtype=delta.dtype, device=delta.device)
    dg = dg.scatter_reduce(0, gid, delta, "amax")
    return ub + delta[labels.long()], lb - dg[None, :]


#: layout version of the bounded loop's carry ``(centers, labels, ub, lb,
#: it, shift, skip_h, held_h)``: :func:`lloyd_bounded_resumable` binds it
#: into every snapshot, so a resume against a snapshot of another layout
#: raises. Bump on any change of the carry.
BOUNDED_CARRY_VERSION = 1


def _bounded_init_state(centers0, n_pad: int, G: int, max_iter: int,
                        bounds_dtype=torch.float32):
    """The carry before the first iteration: zero bounds (in
    ``bounds_dtype``) force a full evaluation (``ub >= min(lb)`` holds at
    0 ≥ 0), which seeds everything; ``it`` is a host int and ``shift``
    starts at +inf."""
    dev = centers0.device
    return (centers0.to(torch.float32),
            torch.zeros(n_pad, dtype=torch.int32, device=dev),
            torch.zeros(n_pad, dtype=bounds_dtype, device=dev),
            torch.zeros((n_pad, G), dtype=bounds_dtype, device=dev),
            0,
            torch.tensor(_INF, device=dev),
            torch.zeros(max_iter, dtype=torch.int64, device=dev),
            torch.zeros(max_iter, dtype=torch.int64, device=dev))


def _pad_rows_to_blocks(X, w):
    """Zero rows with weight 0 up to whole ``row_need`` groups, once,
    before the loop; weight-0 rows are inert everywhere."""
    n = X.shape[0]
    _, n_pad = _row_blocks(n)
    if n_pad == n:
        return X, w
    return (torch.cat([X, X.new_zeros((n_pad - n, X.shape[1]))]),
            torch.cat([w, w.new_zeros(n_pad - n)]))


def _bounded_final_assign(X, w, centers, *, kernel: str):
    """The bounded loop's post-loop full assignment and inertia: the same
    expression as :func:`predict_labels` and :func:`compute_inertia`."""
    labels, mind = fused_argmin_min(X, centers, kernel=kernel)
    return labels, (mind * w).sum()


def _bounded_setup(X, w, k: int, groups, kernel: str, bounds_dtype):
    """What every chunk of the bounded loop reads and never changes: the
    rows padded to whole ``row_need`` groups (once, before the loop),
    their weight-positive mask and ``Σx²`` (f32 whatever X's dtype), and
    the center grouping. ``bounds_dtype`` follows the rule of
    :func:`~dask_ml_tpu_torch.parallel.precision.lloyd_bounds_dtype`:
    float32 or wider, never a low-precision bound."""
    if bounds_dtype not in (torch.float32, torch.float64):
        raise ValueError(
            f"bounds_dtype must be torch.float32 or torch.float64 (bounds "
            f"are solver state, never below float32); got {bounds_dtype}")
    if kernel not in ("auto", "cuda", "torch"):
        raise ValueError(f"kernel must be auto|cuda|torch, got {kernel!r}")
    G, size = _bounded_groups(k, groups)
    X_pad, w_pad = _pad_rows_to_blocks(X, w)
    return {"X_pad": X_pad, "w_pos": w_pad > 0,
            "x2_pad": _row_sumsq(X_pad), "G": G, "bdt": bounds_dtype,
            "gid": torch.arange(k, device=X.device) // size}


def _m_step_over(X, w, labels, centers, mesh):
    """The bounded loop's M-step: :func:`_m_step`'s one-hot sums, summed
    over the sample axes with ``mesh`` (``hpsum(op="kmeans.mstep")``)."""
    sums, counts = _weighted_sums(X, w, labels, centers.shape[0])
    if mesh is not None:
        sums = hpsum(sums, mesh, op="kmeans.mstep")
        counts = hpsum(counts, mesh, op="kmeans.mstep")
    return _new_centers(sums, counts, centers)


def _bounded_chunk(X, w, state, tol_t, prep, *, max_iter: int, chunk: int,
                   kernel: str, prune: bool, mesh=None):
    """Up to ``chunk`` bounded Lloyd iterations from the carry ``state``,
    stopping as the whole loop does (``it == max_iter`` or
    ``shift < tol``): the unit :func:`lloyd_bounded_resumable` saves
    between, and the body of :func:`lloyd_loop_bounded`, so chunked runs
    compose to the same trajectory. Returns the new carry; with ``mesh``
    the carry's rows are this rank's block."""
    centers, labels, ub, lb, it, shift, skip_h, held_h = state
    n = X.shape[0]
    it0 = it
    while it < max_iter and it - it0 < chunk and bool(shift >= tol_t):
        labels, ub, lb, skipped, held = _bounded_assign(
            prep["X_pad"], prep["x2_pad"], centers, labels, ub, lb,
            prep["w_pos"], kernel=kernel, prune=prune)
        skip_h[it], held_h[it] = skipped, held
        new_centers = _m_step_over(X, w, labels[:n], centers, mesh)
        shift = ((new_centers - centers) ** 2).sum()
        ub, lb = _bounded_move(ub, lb, labels, centers, new_centers,
                               prep["gid"], prep["G"])
        centers = new_centers
        it += 1
    return centers, labels, ub, lb, it, shift, skip_h, held_h


def lloyd_loop_bounded(X, w, centers0, tol, *, max_iter: int,
                       kernel: str = "auto", groups="auto",
                       prune: bool = True, bounds_dtype=torch.float32,
                       mesh=None):
    """Lloyd that skips distance work through Elkan/Yinyang center-movement
    bounds, bit-identical to the plain loop (:func:`lloyd_loop`) from the
    same ``centers0``.

    Per iteration: rows whose upper bound is below their tightest group
    lower bound keep their label, and their ``_FUSED_BLK``-row groups skip
    the distance pass; everyone else goes through
    :func:`fused_argmin_min2` (the kernel skips whole groups on the card),
    whose best and second-best distances reseed the bounds. The M-step is
    the oracle's own :func:`_m_step` over the unpadded rows, so centers,
    shifts and the stopping iteration are those of the unpruned loop.
    Then each center's movement loosens the bounds. A Python loop like
    :func:`lloyd_loop_fused`, reading ``shift`` once an iteration; the
    bounds, labels and per-iteration counts stay on the device. The loop
    is one :func:`_bounded_chunk` over the JAX package's 8-tuple carry.

    Returns ``(centers, inertia, n_iter, shift, labels, stats)``: inertia
    and labels from one full assignment against the returned centers,
    ``stats`` with ``rows_skipped`` (rows whose distance work was avoided,
    group granularity) and ``bounds_held`` (rows whose bound held), int64
    tensors of length ``max_iter``, zero past ``n_iter``. ``bounds_dtype``
    (float32 or float64, the facade's ``lloyd_bounds_dtype``) is the
    dtype of the bounds; X may be float32 or bfloat16.

    With ``mesh`` X and w are this rank's block: the bounds, the
    ``row_need`` groups and K5 are per block, the M-step sums go over the
    sample axes (``hpsum(op="kmeans.mstep")``, two operands an
    iteration), and so do the final inertia (``kmeans.inertia``) and the
    per-iteration counts (``kmeans.stats``). The returned labels are this
    rank's block."""
    prep = _bounded_setup(X, w, centers0.shape[0], groups, kernel,
                          bounds_dtype)
    state = _bounded_init_state(centers0, prep["X_pad"].shape[0], prep["G"],
                                max_iter, prep["bdt"])
    state = _bounded_chunk(X, w, state, _tol_tensor(tol, centers0.device),
                           prep, max_iter=max_iter, chunk=max_iter,
                           kernel=kernel, prune=prune, mesh=mesh)
    centers, _, _, _, it, shift, skip_h, held_h = state
    labels_f, inertia = _bounded_final_assign(X, w, centers, kernel=kernel)
    if mesh is not None:
        inertia = hpsum(inertia, mesh, op="kmeans.inertia")
        skip_h = hpsum(skip_h, mesh, op="kmeans.stats")
        held_h = hpsum(held_h, mesh, op="kmeans.stats")
    return (centers, inertia, it, shift, labels_f,
            {"rows_skipped": skip_h, "bounds_held": held_h})


def lloyd_bounded_resumable(X, w, centers0, tol, *, max_iter: int,
                            path: str, chunk_iters: int = 10,
                            every: int = 1, kernel: str = "auto",
                            groups="auto", prune: bool = True,
                            bounds_dtype=torch.float32):
    """Preemption-safe bounded Lloyd: chunks of ``chunk_iters`` iterations
    with the whole carry, bounds included, saved through a
    :class:`~dask_ml_tpu_torch.parallel.faults.ScanCheckpoint` after
    every ``every`` chunks, so a killed fit resumes bit-identically from
    the last snapshot, with its pruning intact.

    The snapshot binds :data:`BOUNDED_CARRY_VERSION` and the problem's
    shape; a snapshot of another layout or problem raises. Returns the
    tuple of :func:`lloyd_loop_bounded`, equal to it bit for bit; the
    snapshot is deleted on completion."""
    from dask_ml_tpu_torch.checkpoint import leaf_tensor
    from dask_ml_tpu_torch.parallel.faults import ScanCheckpoint

    class _BoundedLloydCheckpoint(ScanCheckpoint):
        KIND = "lloyd_bounded"

    k, d = centers0.shape
    prep = _bounded_setup(X, w, k, groups, kernel, bounds_dtype)
    dev = centers0.device
    ckpt = _BoundedLloydCheckpoint(
        path, every=every,
        bind={"carry_version": BOUNDED_CARRY_VERSION,
              "n": int(X.shape[0]), "k": int(k), "d": int(d),
              "G": int(prep["G"]), "max_iter": int(max_iter)})
    snap = ckpt.load()
    if snap is None:
        state = _bounded_init_state(centers0, prep["X_pad"].shape[0],
                                    prep["G"], max_iter, prep["bdt"])
    else:
        carry = snap[0]
        state = tuple(int(leaf) if i == 4
                      else leaf_tensor(leaf, dev)
                      for i, leaf in enumerate(carry))
    tol_t = _tol_tensor(tol, dev)
    while state[4] < max_iter and bool(state[5] >= tol_t):
        state = _bounded_chunk(X, w, state, tol_t, prep, max_iter=max_iter,
                               chunk=int(chunk_iters), kernel=kernel,
                               prune=prune)
        ckpt.tick(state, [], state[4], 0)
    centers, _, _, _, it, shift, skip_h, held_h = state
    labels_f, inertia = _bounded_final_assign(X, w, centers, kernel=kernel)
    ckpt.delete()
    return (centers, inertia, it, shift, labels_f,
            {"rows_skipped": skip_h, "bounds_held": held_h})


# ---------------------------------------------------------------------------
# sketched assignment
# ---------------------------------------------------------------------------


def sketched_assign_wins(n: int, k: int, d: int, p: int) -> bool:
    """Should assignment against a sketch run the sketched contraction
    (staging matmul + O(n·k·p)) rather than the exact one against the
    reconstructed centers (O(n·k·d))? The JAX package's cold-start rule:
    2p ≤ d and k ≥ 8. Both give the same labels; this is a speed choice."""
    return 2 * p <= d and k >= 8


def _predict_sketched_fast(X, Wp, off, vals, kernel: str = "auto"):
    """Labels through the sketch: ``Zp = X @ Wp − off`` (the centering
    folded into one affine map) and the sketched argmin with x2 = 0 (the
    argmin does not depend on the per-row constant)."""
    Zp = X @ Wp.to(X.dtype) - off[None, :].to(X.dtype)
    zero = torch.zeros(X.shape[0], dtype=torch.float32, device=X.device)
    return fused_argmin_min_sketched(Zp, vals, x2=zero, kernel=kernel)[0]


def predict_labels_sketched(X, Wp, off, vals, centers, kernel: str = "auto",
                            mesh=None, n_valid=None):
    """Labels for X under a sketched model — the one assignment of the
    sketched family, shared by ``KMeans.fit`` and ``KMeans.predict``.
    ``Wp`` is the (d, p) staging slice, ``off = μ @ Wp`` its centering
    offset, ``centers`` the dense reconstruction (with the mean added
    back); :func:`sketched_assign_wins` picks the contraction. Over more
    than one data shard X is this rank's block: it is labelled on its own
    (K2-x, or K2 on the dense route) and every block's labels are
    gathered (op ``kmeans.labels``), the first ``n_valid`` on every
    rank."""
    n, d = X.shape
    k, p = vals.shape
    if not sketched_assign_wins(n, k, d, p):
        return predict_labels(X, centers, kernel=kernel, mesh=mesh,
                              n_valid=n_valid)
    labels = _predict_sketched_fast(X, Wp, off, vals, kernel=kernel)
    if not is_sharded(mesh):
        return labels
    return gather_blocks(labels, mesh, op="kmeans.labels")[:n_valid]


# ---------------------------------------------------------------------------
# k-means|| (Bahmani et al. 2012, Algorithm 2)
# ---------------------------------------------------------------------------


def _categorical(p, gen: torch.Generator, num: int):
    """``num`` indices drawn with replacement ∝ ``p`` (non-negative, not
    all zero) by inverse-CDF search on an f64 cumulative sum. Unlike
    ``torch.multinomial`` it takes any number of categories (the seeding
    draw runs over every row)."""
    c = torch.cumsum(p.to(torch.float64), dim=0)
    u = torch.rand(num, generator=gen, device=p.device,
                   dtype=torch.float64) * c[-1]
    return torch.searchsorted(c, u, right=True).clamp_(max=p.numel() - 1)


def _kmeanspp_on_candidates(cand, cw, n_clusters: int, gen, n_trials: int):
    """Weighted greedy k-means++ over the small candidate buffer (sklearn's
    ``_kmeans_plusplus`` with ``n_trials`` local trials). Rows with
    ``cw == 0`` are drawn only through the 1e-30 floor, i.e. only when
    every real potential is zero."""
    i0 = _categorical(torch.clamp(cw, min=1e-30), gen, 1)[0]
    c0 = cand[i0]
    centers = torch.zeros((n_clusters, cand.shape[1]), dtype=torch.float32,
                          device=cand.device)
    centers[0] = c0
    zero = torch.zeros_like(cw)
    mind = torch.where(cw > 0, ((cand - c0[None, :]) ** 2).sum(dim=1), zero)
    for j in range(1, n_clusters):
        pot = mind * cw
        ids = _categorical(torch.clamp(pot, min=1e-30), gen, n_trials)
        cs = cand[ids]  # (L, d)
        d2 = ((cand[None, :, :] - cs[:, None, :]) ** 2).sum(dim=-1)
        newmind = torch.minimum(mind[None, :], d2)  # (L, n_cand)
        b = (newmind * cw[None, :]).sum(dim=1).argmin()
        centers[j] = cs[b]
        mind = torch.where(cw > 0, newmind[b], zero)
    return centers


def _owned_rows(X, rows, mesh, op: str):
    """The rows of the whole (row-sharded) data at global indices ``rows``
    (a tensor), in that order, on every rank: each rank fills the rows it
    holds into an (r, d) buffer, the buffers are gathered, and each row is
    taken from its owner's."""
    n_loc = X.shape[0]
    i = mesh_lib.data_index(mesh)
    owner = torch.clamp(rows // n_loc, max=mesh_lib.n_data_shards(mesh) - 1)
    mine = owner == i
    buf = torch.zeros((rows.shape[0], X.shape[1]), dtype=torch.float32,
                      device=X.device)
    buf[mine] = X[rows[mine] - i * n_loc].to(torch.float32)
    every = gather_blocks(buf, mesh, op=op)  # (shards * r, d)
    return every[owner * rows.shape[0]
                 + torch.arange(rows.shape[0], device=X.device)]


def _global_categorical_row(X, w, gen, n_valid: int, mesh):
    """The row :func:`_categorical` draws ∝ ``clamp(w, 1e-30)`` over the
    whole data, from every rank's block: the global cumulative sum is each
    block's own plus the totals of the blocks before it (a gather of one
    f64 a rank), every rank draws the same ``u``, the index is the count
    of cumulative sums ≤ ``u`` (an ``hpsum``), and its owner hands the row
    to every rank. Ops ``kmeans.init.seed``."""
    c = torch.cumsum(torch.clamp(w, min=1e-30).to(torch.float64), dim=0)
    totals = gather_blocks(c[-1:], mesh, op="kmeans.init.seed")
    before = torch.cumsum(totals, dim=0) - totals
    u = torch.rand(1, generator=gen, device=w.device,
                   dtype=torch.float64) * totals.sum()
    i = mesh_lib.data_index(mesh)
    below = ((before[i] + c) <= u).sum()
    idx = torch.clamp(hpsum(below, mesh, op="kmeans.init.seed"),
                      max=n_valid - 1)
    return _owned_rows(X, idx.reshape(1), mesh, "kmeans.init.seed")[0]


def _init_seed_phase(X, w, gen, *, max_rounds: int, max_cand: int,
                     mesh=None, n_valid=None):
    """k-means|| phase 1 — first center ∝ w, per-row min-distances, φ₀,
    and the data-dependent round count (read to the host)."""
    d = X.shape[1]
    if is_sharded(mesh):
        first = _global_categorical_row(X, w, gen, n_valid, mesh)
    else:
        idx0 = _categorical(torch.clamp(w, min=1e-30), gen, 1)[0]
        first = X[idx0].to(torch.float32)
    cand = torch.zeros((max_cand, d), dtype=torch.float32, device=X.device)
    cand[0] = first
    mind0 = torch.where(w > 0, ((X - first[None, :]) ** 2).sum(dim=1),
                        torch.zeros_like(w))
    phi0 = (mind0 * w).sum()
    if mesh is not None:
        phi0 = hpsum(phi0, mesh, op="kmeans.init.seed")
    n_rounds = int(torch.clamp(
        torch.round(torch.log(torch.clamp(phi0, min=1e-30))),
        1, max_rounds))
    return cand, mind0, phi0, n_rounds


def _pack_hits(mask, cap: int):
    """Indices of the first ``cap`` True entries of ``mask``, ascending
    (then zeros) — the same candidates for the same mask, with no host
    sync. ``torch.topk`` over equal scores would leave their order
    unspecified on the card."""
    n = mask.shape[0]
    pos = torch.cumsum(mask, dim=0) - 1
    slot = torch.where(mask & (pos < cap), pos, torch.full_like(pos, cap))
    buf = torch.zeros(cap + 1, dtype=torch.long, device=mask.device)
    # every slot < cap is written once; slot `cap` collects the rest and
    # is dropped
    buf.scatter_(0, slot, torch.arange(n, device=mask.device))
    return buf[:cap]


def _global_draw(X, gen, n_valid: int, mesh):
    """This rank's slice of one ``torch.rand(n_valid)`` that every rank
    draws whole from the same generator (the draw of a single device over
    the true rows); padding rows get 1.0, which no probability beats."""
    n_loc = X.shape[0]
    lo = mesh_lib.data_index(mesh) * n_loc
    u = torch.rand(n_valid, generator=gen, device=X.device)[lo:lo + n_loc]
    if u.shape[0] < n_loc:
        u = torch.cat([u, u.new_ones(n_loc - u.shape[0])])
    return u


def _pack_hits_global(X, hits, cap: int, mesh):
    """The rows of the first ``cap`` hits of the whole data in row order,
    (cap, d) f32 with zeros past the hits, and the global hit count: each
    rank packs its own first ``cap`` hits, the packs and the hit counts
    are gathered (ops ``kmeans.init.rounds``), and global slot ``s`` is
    taken from the rank whose prefix of the hit counts holds it."""
    counts = gather_blocks(hits.sum().reshape(1), mesh,
                           op="kmeans.init.rounds")
    mine = X[_pack_hits(hits, cap)].to(torch.float32)  # (cap, d)
    packs = gather_blocks(mine, mesh, op="kmeans.init.rounds")
    ends = torch.cumsum(counts, dim=0)
    slot = torch.arange(cap, device=X.device)
    q = torch.clamp(torch.searchsorted(ends, slot, right=True),
                    max=counts.shape[0] - 1)
    rows = packs[q * cap + slot - (ends[q] - counts[q])]
    total = ends[-1]
    return torch.where((slot < total)[:, None], rows,
                       torch.zeros_like(rows)), total


def _init_rounds_phase(X, w, l, cand, mind0, n_rounds: int, gen, *,
                       max_cand: int, cap: int, kernel: str = "auto",
                       prune: bool = True, mesh=None, n_valid=None):
    """k-means|| phase 2 — the sampling rounds. Each round draws rows
    ∝ l·mind·w/φ, packs up to ``cap`` hits into the candidate buffer, and
    updates ``mind`` against ONLY the new rows through
    :func:`fused_rowwise_min`.

    ``prune=True`` skips the distance work of rows whose minimum provably
    cannot improve: ``d(x, c) ≥ |‖x‖ − ‖c‖|``, so when the squared gap
    between ‖x‖ and the new rows' norm interval exceeds ``mind`` (less an
    absolute slack that covers f32 rounding) the row's group may skip via
    ``row_need``. Skipped rows keep ``mind`` exactly, so pruned and
    unpruned rounds draw identical candidates. Returns (cand, n_cand,
    overflow, rows_skipped, rows_considered); the counts are tensors.

    Over more than one data shard every rank draws the whole
    ``torch.rand(n_valid)`` and takes its slice, φ is summed over the
    shards and the hits are packed in global row order
    (:func:`_pack_hits_global`), so the candidates are those of one
    device; K3 runs on each block. The skip counts are this rank's."""
    sharded = is_sharded(mesh)
    n = X.shape[0]
    dev = X.device
    cap_iota = torch.arange(cap, device=dev)
    w_real = w > 0
    zero = torch.zeros_like(w)
    if prune:
        x2 = _row_sumsq(X)
        xnorm = torch.sqrt(x2)
    # one trash row past the buffer takes the writes of unfilled slots
    buf = torch.cat([cand, cand.new_zeros((1, cand.shape[1]))])
    n_cand = torch.tensor(1, dtype=torch.long, device=dev)
    overflow = torch.tensor(0, dtype=torch.long, device=dev)
    skipped = torch.tensor(0, dtype=torch.long, device=dev)
    considered = torch.tensor(0, dtype=torch.long, device=dev)
    mind = mind0
    for _ in range(n_rounds):
        phi = (mind * w).sum()
        if mesh is not None:
            phi = hpsum(phi, mesh, op="kmeans.init.rounds")
        p = torch.clamp(l * mind * w / torch.clamp(phi, min=1e-30), max=1.0)
        if sharded:
            hits = _global_draw(X, gen, n_valid, mesh) < p
            rows, total = _pack_hits_global(X, hits, cap, mesh)
        else:
            hits = torch.rand(n, generator=gen, device=dev) < p
            total = hits.sum()
            rows = X[_pack_hits(hits, cap)].to(torch.float32)  # (cap, d)
        count = torch.minimum(torch.clamp(total, max=cap), max_cand - n_cand)
        ok = cap_iota < count
        slots = torch.where(ok, n_cand + cap_iota,
                            torch.full_like(cap_iota, max_cand))
        buf[slots] = rows
        if prune:
            rn = torch.sqrt((rows * rows).sum(dim=1))
            r_lo = torch.where(ok, rn, torch.full_like(rn, _INF)).min()
            r_hi = torch.where(ok, rn, torch.zeros_like(rn)).max()
            gap = torch.clamp(torch.maximum(r_lo - xnorm, xnorm - r_hi),
                              min=0.0)
            slack = 1e-5 * (x2 + r_hi * r_hi) + 1e-12
            need = (gap * gap - slack < mind) & w_real
            skipped = skipped + (w_real & ~need).sum()
            considered = considered + w_real.sum()
            dmin_new = fused_rowwise_min(X, rows, mask=ok, kernel=kernel,
                                         row_need=need)
        else:
            dmin_new = fused_rowwise_min(X, rows, mask=ok, kernel=kernel)
        mind = torch.where(w_real, torch.minimum(mind, dmin_new), zero)
        overflow = torch.maximum(overflow, total - count)
        n_cand = n_cand + count
    return buf[:max_cand], n_cand, overflow, skipped, considered


def _global_top_up(X, w, gen, n_clusters: int, need: int, n_valid: int,
                   mesh):
    """The ``need`` rows :func:`_init_weights_phase`'s top-up draws on one
    device (the smallest of one whole-data uniform draw over rows of
    positive weight), from every rank's block: each rank's smallest, a
    gather of them, the global smallest, their owners' rows."""
    u = _global_draw(X, gen, n_valid, mesh)
    u = torch.where(w > 0, u, torch.full_like(u, _INF))
    kk = min(n_clusters, X.shape[0])
    vals, idx = torch.topk(-u, kk)
    lo = mesh_lib.data_index(mesh) * X.shape[0]
    if kk < n_clusters:
        vals = torch.cat([vals, vals.new_full((n_clusters - kk,), -_INF)])
        idx = torch.cat([idx, idx.new_zeros(n_clusters - kk)])
    all_vals = gather_blocks(vals, mesh, op="kmeans.init.weights")
    all_idx = gather_blocks(idx + lo, mesh, op="kmeans.init.weights")
    pick = all_idx[torch.topk(all_vals, n_clusters).indices[:need]]
    return _owned_rows(X, pick, mesh, "kmeans.init.weights")


def _init_weights_phase(X, w, cand, n_cand: int, gen, *, n_clusters: int,
                        max_cand: int, kernel: str = "auto", mesh=None,
                        n_valid=None):
    """k-means|| phase 3 — top-up to ``n_clusters`` candidates with random
    distinct real rows when the draw came up short, then the candidate
    weights (total row weight nearest each candidate) through
    :func:`fused_argmin_weight` (with ``mesh``, each rank's partial summed
    over the shards before anything reads it)."""
    need = min(max(n_clusters - n_cand, 0), n_clusters)
    if need > 0:
        if is_sharded(mesh):
            cand[n_cand:n_cand + need] = _global_top_up(
                X, w, gen, n_clusters, need, n_valid, mesh)
        else:
            u = torch.rand(X.shape[0], generator=gen, device=X.device)
            u = torch.where(w > 0, u, torch.full_like(u, _INF))
            extra = torch.topk(-u, n_clusters).indices[:need]
            cand[n_cand:n_cand + need] = X[extra].to(torch.float32)
        n_cand += need
    valid = torch.arange(max_cand, device=X.device) < n_cand
    _, cw = fused_argmin_weight(X, w, cand, mask=valid, kernel=kernel,
                                mesh=mesh)
    return cand, n_cand, cw


def _init_finish_phase(cand, cw, tol, gen, *, n_clusters: int,
                       n_trials: int, finish_iters: int,
                       kernel: str = "auto"):
    """k-means|| phase 4 — weighted greedy k-means++ over the candidates
    plus the small finishing Lloyd loop."""
    centers = _kmeanspp_on_candidates(cand, cw, n_clusters, gen, n_trials)
    centers, _, _, _ = lloyd_loop(cand, cw, centers, tol,
                                  max_iter=finish_iters, kernel=kernel)
    return centers


def _init_scalable_config(n_padded: int, n_clusters: int,
                          oversampling_factor: float,
                          max_iter: Optional[int]) -> dict:
    """Buffer and cap sizing — the reference's rule, unchanged."""
    l = float(oversampling_factor * n_clusters)
    max_rounds = 20
    if max_iter is not None:
        max_rounds = int(min(max(max_iter, 1), max_rounds))
    return dict(
        l=l,
        max_rounds=max_rounds,
        cap=int(min(max(4 * int(np.ceil(l)) + 16, 64), n_padded)),
        max_cand=int(1 + np.ceil(l) * max_rounds + n_clusters),
        n_trials=2 + int(np.log(max(n_clusters, 2))),
    )


def _n_padded(X, mesh) -> int:
    """Rows over every shard (the blocks are equal)."""
    if mesh is None:
        return int(X.shape[0])
    return int(X.shape[0]) * mesh_lib.n_data_shards(mesh)


def init_scalable(X, w, n_valid: int, n_clusters: int, gen,
                  oversampling_factor: float = 2.0,
                  max_iter: Optional[int] = None, mesh=None,
                  kernel: str = "auto"):
    """k-means|| init: seeding, sampling rounds, candidate weighting and
    the finishing k-means++ + Lloyd over the candidates. With ``mesh`` X
    and w are this rank's block, and every rank returns the centers a
    single device would draw from the same generator (module
    docstring)."""
    cfg = _init_scalable_config(_n_padded(X, mesh), n_clusters,
                                oversampling_factor, max_iter)
    tol = scaled_tolerance(X, w, 1e-4, mesh=mesh)
    with telemetry.span("kmeans-init-seed"):
        cand, mind0, phi0, n_rounds = _init_seed_phase(
            X, w, gen, max_rounds=cfg["max_rounds"],
            max_cand=cfg["max_cand"], mesh=mesh, n_valid=n_valid)
    with telemetry.span("kmeans-init-rounds"):
        cand, n_cand, overflow, r_skip, r_total = _init_rounds_phase(
            X, w, cfg["l"], cand, mind0, n_rounds, gen,
            max_cand=cfg["max_cand"], cap=cfg["cap"], kernel=kernel,
            mesh=mesh, n_valid=n_valid)
        n_cand = int(n_cand)
    with telemetry.span("kmeans-init-weights"):
        cand, n_cand, cw = _init_weights_phase(
            X, w, cand, n_cand, gen, n_clusters=n_clusters,
            max_cand=cfg["max_cand"], kernel=kernel, mesh=mesh,
            n_valid=n_valid)
    with telemetry.span("kmeans-init-finish"):
        centers = _init_finish_phase(
            cand, cw, tol, gen, n_clusters=n_clusters,
            n_trials=cfg["n_trials"], finish_iters=100, kernel=kernel)
    logger.info(
        "k-means|| init: phi0=%.4g, %d rounds, %d candidates, "
        "round skip ratio %.3f", float(phi0), n_rounds, n_cand,
        float(r_skip) / max(float(r_total), 1.0))
    if int(overflow) > 0:
        logger.warning(
            "k-means|| round drew %d candidates beyond the per-round cap "
            "of %d; the overflow was dropped", int(overflow), cfg["cap"])
    return centers


def init_random(X, w, n_valid: int, n_clusters: int, gen, mesh=None):
    """``n_clusters`` distinct random rows (with ``mesh``, of the whole
    data: every rank draws the same permutation and the owners hand the
    rows over)."""
    perm = torch.randperm(n_valid, generator=gen, device=X.device)
    rows = torch.sort(perm[:n_clusters]).values
    if is_sharded(mesh):
        return _owned_rows(X, rows, mesh, "kmeans.init.random")
    return X[rows].to(torch.float32)


def init_pp(X, n_valid: int, n_clusters: int, gen, mesh=None):
    """k-means++ on the host with scikit-learn's ``kmeans_plusplus``, like
    the reference (only sensible for modest n; needs scikit-learn, which
    the rest of the port does not). With ``mesh`` every rank gathers the
    whole data first."""
    try:
        from sklearn.cluster import kmeans_plusplus
    except ImportError as e:
        raise ImportError(
            "init='k-means++' (init_pp) runs scikit-learn's "
            "kmeans_plusplus on the host and needs scikit-learn, which is "
            "not installed; use init='k-means||' or 'random'") from e

    if is_sharded(mesh):
        X = gather_blocks(X, mesh, op="kmeans.init.pp")
    Xh = X[:n_valid].to(torch.float32).cpu().numpy()
    seed = int(torch.randint(0, 2**31 - 1, (1,), generator=gen,
                             device=X.device))
    centers, _ = kmeans_plusplus(Xh, n_clusters, random_state=seed)
    return torch.as_tensor(centers, dtype=torch.float32, device=X.device)


def k_init(X, w, n_valid: int, n_clusters: int, gen,
           init="k-means||", oversampling_factor: float = 2.0,
           max_iter: Optional[int] = None, mesh=None,
           kernel: str = "auto"):
    """Init dispatch: an array, 'k-means||', 'k-means++' or 'random'
    (``mesh``: X and w are this rank's block)."""
    if isinstance(init, (np.ndarray, torch.Tensor)):
        centers = torch.as_tensor(init).to(device=X.device,
                                           dtype=torch.float32)
        if tuple(centers.shape) != (n_clusters, X.shape[1]):
            raise ValueError(
                f"init array must have shape ({n_clusters}, {X.shape[1]}), "
                f"got {tuple(centers.shape)}")
        return centers
    if init == "k-means||":
        return init_scalable(X, w, n_valid, n_clusters, gen,
                             oversampling_factor=oversampling_factor,
                             max_iter=max_iter, kernel=kernel, mesh=mesh)
    if init == "k-means++":
        return init_pp(X, n_valid, n_clusters, gen, mesh=mesh)
    if init == "random":
        return init_random(X, w, n_valid, n_clusters, gen, mesh=mesh)
    raise ValueError(
        f"init must be 'k-means||', 'k-means++', 'random', or an array; "
        f"got {init!r}")


def _init_phase_traffic(n: int, d: int, itemsize: int, *, n_rounds: int,
                        max_cand: int, n_clusters: int, n_trials: int,
                        finish_iters: int) -> dict:
    """Logical bytes each k-means|| phase must move (the JAX package's
    dominant terms, with the fused kernels): ``seed`` one pass over X and
    the (n,) min-distance write; ``rounds`` a pass over X and three (n,)
    vectors a round; ``weights`` a pass over X, the (n,) weights and the
    nearest-candidate write; ``finish`` the candidate-buffer passes of the
    k-means++ trials and the small Lloyd loop."""
    row = n * d * itemsize
    return dict(
        seed=row + 4 * n,
        rounds=max(int(n_rounds), 0) * (row + 3 * 4 * n),
        weights=row + 2 * 4 * n,
        finish=(n_clusters * n_trials + 2 * finish_iters) * max_cand * d * 4)


def _init_phase_collective_traffic(mesh, d: int, *, n_rounds: int, cap: int,
                                   max_cand: int) -> dict:
    """Per-mesh-axis logical collective bytes of each k-means|| phase, the
    JAX package's model (:func:`~dask_ml_tpu_torch.parallel.hierarchy.
    collective_bytes` of each term): ``seed`` the φ₀ scalar; ``rounds``
    per round the φ scalar, the draw count and the ``cap``-row candidate
    gather (cap·d·4 bytes); ``weights`` the (max_cand,) weight sum;
    ``finish`` 0 (replicated candidate work)."""
    from dask_ml_tpu_torch.parallel.hierarchy import collective_bytes

    def cb(nbytes):
        return collective_bytes(mesh, int(nbytes))

    def add(a, b):
        return {k: a.get(k, 0) + b.get(k, 0) for k in set(a) | set(b)}

    zero = {k: 0 for k in cb(0)}
    per_round = add(add(cb(4), cb(4)), cb(cap * d * 4))
    rounds = zero
    for _ in range(max(int(n_rounds), 0)):
        rounds = add(rounds, per_round)
    return dict(seed=cb(4), rounds=rounds,
                weights=cb(max_cand * 4), finish=zero)


def measure_init_phases(X, w, n_clusters: int, gen,
                        oversampling_factor: float = 2.0,
                        max_iter: Optional[int] = None, mesh=None,
                        kernel: str = "auto", n_valid=None) -> dict:
    """Wall seconds of each k-means|| phase (seeding, the sampling rounds,
    the candidate weighting, the finishing k-means++ and Lloyd loop), run
    one at a time with a device sync after each, where the fit runs them
    back to back (the JAX package's ``measure_init_phases``). Each phase
    runs once to warm up and again, from the same generator state, to be
    timed. Returns::

        {"seconds": {phase: s}, "bytes_moved": {phase: bytes},
         "effective_gbps": {phase: bytes / s / 1e9},
         "fused": {"rounds": bool, "weights": bool},
         "round_skip_ratio": share of (row, round) distance work the
                             rounds' norm bound skipped,
         "n_rounds": int, "n_cand": int}

    ``fused`` says whether the rounds and the weighting ran the kernels
    (K3, K4): on a CUDA tensor unless ``kernel="torch"`` (``kernel`` as in
    :func:`init_scalable`). A measurement harness, not a production
    path. With ``mesh`` (X and w this rank's block, ``n_valid`` the true
    rows) the phases run over the mesh, and a hierarchical mesh adds
    ``bytes_moved_by_axis`` and ``effective_gbps_by_axis`` from
    :func:`_init_phase_collective_traffic`."""
    import time

    n, d = _n_padded(X, mesh), int(X.shape[1])
    n_valid = n if n_valid is None else int(n_valid)
    cfg = _init_scalable_config(n, n_clusters, oversampling_factor,
                                max_iter)
    tol = scaled_tolerance(X, w, 1e-4, mesh=mesh)

    def sync():
        if X.is_cuda:
            torch.cuda.synchronize(X.device)

    phases = {}

    def timed(name, fn):
        state = gen.get_state()
        fn()  # warm: a first launch may build and load the kernels
        gen.set_state(state)
        sync()
        t0 = time.perf_counter()
        with telemetry.span(f"kmeans-init/{name}"):
            out = fn()
            sync()
        phases[name] = time.perf_counter() - t0
        return out

    cand, mind0, _, n_rounds = timed("seed", lambda: _init_seed_phase(
        X, w, gen, max_rounds=cfg["max_rounds"], max_cand=cfg["max_cand"],
        mesh=mesh, n_valid=n_valid))
    cand, n_cand, _, skip, total = timed(
        "rounds", lambda: _init_rounds_phase(
            X, w, cfg["l"], cand.clone(), mind0, n_rounds, gen,
            max_cand=cfg["max_cand"], cap=cfg["cap"], kernel=kernel,
            mesh=mesh, n_valid=n_valid))
    n_cand = int(n_cand)
    if mesh is not None:
        skip = hpsum(skip, mesh, op="kmeans.init.stats")
        total = hpsum(total, mesh, op="kmeans.init.stats")
    cand, n_cand, cw = timed("weights", lambda: _init_weights_phase(
        X, w, cand.clone(), n_cand, gen, n_clusters=n_clusters,
        max_cand=cfg["max_cand"], kernel=kernel, mesh=mesh,
        n_valid=n_valid))
    timed("finish", lambda: _init_finish_phase(
        cand, cw, tol, gen, n_clusters=n_clusters,
        n_trials=cfg["n_trials"], finish_iters=100, kernel=kernel))
    fused = _kernels.use_cuda(kernel, X)
    traffic = _init_phase_traffic(
        n, d, X.element_size(), n_rounds=n_rounds,
        max_cand=cfg["max_cand"], n_clusters=n_clusters,
        n_trials=cfg["n_trials"], finish_iters=100)
    report = {
        "seconds": phases,
        "bytes_moved": traffic,
        "effective_gbps": {p: traffic[p] / max(phases[p], 1e-9) / 1e9
                           for p in phases},
        "fused": {"rounds": fused, "weights": fused},
        "round_skip_ratio": float(skip) / max(float(total), 1.0),
        "n_rounds": int(n_rounds),
        "n_cand": n_cand,
    }
    if mesh is not None and mesh_lib.is_hierarchical(mesh):
        by_axis = _init_phase_collective_traffic(
            mesh, d, n_rounds=n_rounds, cap=cfg["cap"],
            max_cand=cfg["max_cand"])
        report["bytes_moved_by_axis"] = by_axis
        report["effective_gbps_by_axis"] = {
            p: {ax: b / max(phases[p], 1e-9) / 1e9
                for ax, b in by_axis[p].items()}
            for p in phases}
    return report

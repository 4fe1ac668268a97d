"""Two-level (pod, chip) scale-out of the PyTorch port: the collective
family over ``torch.distributed`` process groups and its per-axis traffic
ledger (counterpart of ``dask_ml_tpu/parallel/hierarchy.py``).

Every model core reduces over a sharded sample axis. On a flat
``("data",)`` mesh that reduction is one ``all_reduce`` over the data
group. On a two-level ``("pod", "chip")`` mesh (:func:`make_hierarchical_
mesh`) it is an ``all_reduce`` over the ``chip`` group and then one over
the ``pod`` group, so one already-reduced partial per pod crosses pods.
The degenerate ``n_pods=1`` mesh runs the pod stage over a group of one.

The collectives run under NCCL when every rank has its own card and under
gloo on the CPU and for ranks that share one card; CUDA tensors take
either. A sum is an ``all_reduce``, a gather an ``all_gather``, and a
reduce-scatter an ``all_reduce`` and a slice: gloo has no reduce-scatter
of CUDA tensors. On a world of one rank without a process group every
collective is the identity and records nothing.

**Traffic ledger.** Each collective records its logical combining bytes
per mesh axis into a process-wide :class:`TrafficLedger` (mirrored into
the telemetry registry as ``collective.bytes{axis=}`` /
``collective.calls{axis=,op=}`` when the ``telemetry`` knob is on), with
the JAX package's model: ``(s - 1) * B`` bytes per reduction group over an
axis of size ``s``; the chip stage runs one group per pod, the pod stage
one group; a mesh with a ``model`` axis multiplies the sample-axis terms
by its size:

    flat  : (N - 1) * B            over axis "data"
    hier  : n_pods * (cpp - 1) * B over axis "chip"
            (n_pods - 1) * B       over axis "pod"

A gather (:func:`gather_blocks`) forwards ``s - 1`` blocks a group, as the
JAX ``mpgather`` is charged: ``B`` a shard's block, the pod stage's
blocks are a pod's ``cpp`` blocks.

Every rank's ledger holds these mesh-wide bytes, as the one JAX process
does. One deviation: the JAX package records once per trace, so a
``while_loop`` body counts once; eager PyTorch has no trace, and the port
records every collective it executes. A port fit's ``kmeans.mstep`` bytes
are the JAX per-trace bytes times the iterations it ran.

**The model axis.** ``make_hierarchical_mesh(..., model_parallel=m)`` adds
an innermost ``'model'`` axis for feature-parallel work. :func:`mpsum`,
:func:`mpgather` and :func:`mpsum_scatter` run over the model group and
record under the ``model`` ledger axis, one group per data coordinate;
each is the identity, and records nothing, when the model axis is absent
or of size 1.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Optional, Sequence

import numpy as np
import torch

from dask_ml_tpu_torch.parallel.mesh import (
    CHIP_AXIS,
    DATA_AXIS,
    MODEL_AXIS,
    POD_AXIS,
    Mesh,
    data_axes,
    data_pspec,
    is_hierarchical,
    make_mesh,
    model_index,
    n_data_shards,
    n_model_shards,
)

__all__ = [
    "make_hierarchical_mesh",
    "hpsum",
    "hpmean",
    "hpsum_scatter",
    "mpsum",
    "mpgather",
    "mpsum_scatter",
    "model_metered",
    "record_model_collective",
    "TrafficLedger",
    "ledger",
    "reset_ledger",
    "ledger_snapshot",
    "collective_bytes",
    "record_collective",
    "record_axis_collective",
]


def make_hierarchical_mesh(
    n_pods: int,
    chips_per_pod: Optional[int] = None,
    devices: Optional[Sequence[int]] = None,
    model_parallel: int = 1,
) -> Mesh:
    """An ``(n_pods, chips_per_pod)`` mesh with axes ``('pod', 'chip')``,
    or with ``model_parallel=m > 1`` an ``(n_pods, chips_per_pod, m)``
    mesh with axes ``('pod', 'chip', 'model')`` whose model groups lie
    inside pods. ``chips_per_pod=None`` is solved from the rank count.
    Ranks fill the grid pod-major, so shard ``i`` is rank ``i`` as on the
    flat mesh over the same ranks. ``model_parallel=1`` is the plain
    two-axis mesh."""
    if model_parallel and int(model_parallel) > 1:
        return make_mesh(
            devices=devices,
            shape=(n_pods, chips_per_pod, int(model_parallel)),
            axis_names=(POD_AXIS, CHIP_AXIS, MODEL_AXIS))
    return make_mesh(devices=devices, shape=(n_pods, chips_per_pod),
                     axis_names=(POD_AXIS, CHIP_AXIS))


# ---------------------------------------------------------------------------
# per-axis traffic ledger
# ---------------------------------------------------------------------------


class TrafficLedger:
    """Thread-safe per-(op, axis) logical-byte and call accounting, mirrored
    into the telemetry registry at the same site when the knob is on."""

    def __init__(self):
        self._lock = threading.Lock()
        self._entries: dict = {}  # (op, axis) -> [bytes, calls]

    def record(self, op: str, axis: str, nbytes: int, calls: int = 1) -> None:
        nbytes = int(nbytes)
        with self._lock:
            e = self._entries.setdefault((str(op), str(axis)), [0, 0])
            e[0] += nbytes
            e[1] += int(calls)
        from dask_ml_tpu_torch.parallel import telemetry

        if telemetry.enabled():
            reg = telemetry.metrics()
            reg.counter("collective.bytes", axis=axis).inc(nbytes)
            reg.counter("collective.calls", axis=axis, op=op).inc(calls)

    def snapshot(self) -> dict:
        """JSON-round-trippable view::

            {"bytes": {axis: total_bytes},
             "calls": {"axis/op": n_calls},
             "ops":   {op: {axis: bytes}}}
        """
        with self._lock:
            items = sorted(self._entries.items())
        by_axis: dict = {}
        calls: dict = {}
        by_op: dict = {}
        for (op, axis), (b, c) in items:
            by_axis[axis] = by_axis.get(axis, 0) + b
            calls[f"{axis}/{op}"] = calls.get(f"{axis}/{op}", 0) + c
            by_op.setdefault(op, {})
            by_op[op][axis] = by_op[op].get(axis, 0) + b
        return {"bytes": by_axis, "calls": calls, "ops": by_op}

    def reset(self) -> None:
        with self._lock:
            self._entries.clear()


_ledger = TrafficLedger()


def ledger() -> TrafficLedger:
    """The process-wide per-axis collective-traffic ledger."""
    return _ledger


def reset_ledger() -> None:
    _ledger.reset()


def ledger_snapshot() -> dict:
    return _ledger.snapshot()


def _itemsize(dtype) -> int:
    if isinstance(dtype, torch.dtype):
        return dtype.itemsize
    return int(np.dtype(dtype).itemsize)


def collective_bytes(mesh: Mesh, nbytes: int) -> dict:
    """Per-axis logical combining bytes of ONE full sample-axis reduction
    of an ``nbytes``-byte operand (this rank's operand) over ``mesh``:
    ``(N-1)*B`` on ``"data"`` flat; ``n_pods*(cpp-1)*B`` on ``"chip"`` and
    ``(n_pods-1)*B`` on ``"pod"`` hierarchical; every term times the model
    axis's size. Axes of size 1 charge exactly 0."""
    nbytes = int(nbytes)
    m = n_model_shards(mesh)
    if is_hierarchical(mesh):
        n_pods = int(mesh.shape[POD_AXIS])
        cpp = int(mesh.shape[CHIP_AXIS])
        return {CHIP_AXIS: m * n_pods * (cpp - 1) * nbytes,
                POD_AXIS: m * (n_pods - 1) * nbytes}
    return {DATA_AXIS: m * (n_data_shards(mesh) - 1) * nbytes}


def record_collective(op: str, mesh: Mesh, shape, dtype) -> None:
    """Record one full sample-axis reduction of a ``(shape, dtype)``
    operand."""
    nbytes = int(np.prod(tuple(shape), dtype=np.int64)) * _itemsize(dtype)
    for axis, b in collective_bytes(mesh, nbytes).items():
        _ledger.record(op, axis, b)


def record_axis_collective(op: str, mesh: Mesh, axis: str,
                           nbytes: int) -> None:
    """Record a single-axis collective with the (size-1)*B-per-group model:
    the ``chip`` stage one group per (pod, model) coordinate, the ``pod``
    stage one per model coordinate, a ``model``-axis collective one per
    data coordinate, any other axis one group."""
    s = int(mesh.shape[axis])
    m = n_model_shards(mesh)
    if axis == CHIP_AXIS and is_hierarchical(mesh):
        groups = int(mesh.shape[POD_AXIS]) * m
    elif axis == POD_AXIS and is_hierarchical(mesh):
        groups = m
    elif axis == MODEL_AXIS:
        groups = n_data_shards(mesh)
    else:
        groups = 1
    _ledger.record(op, axis, (s - 1) * int(nbytes) * groups)


# ---------------------------------------------------------------------------
# the reductions
# ---------------------------------------------------------------------------


def _local(mesh: Mesh) -> bool:
    """A world of one rank with no process group: every collective on it
    is the identity and records nothing."""
    return not mesh.groups and mesh.size == 1


def _group(mesh: Mesh, axis: str):
    """``axis``'s process group, or None on a layout of one rank along
    it."""
    group = mesh.groups.get(axis)
    if group is None and mesh.shape[axis] != 1:
        raise RuntimeError(
            f"the {mesh.shape} mesh has no process group for axis {axis!r}: "
            "build it with make_mesh on every rank after runtime.initialize")
    return group


def _all_reduce(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over ``axis``'s group, as a new tensor (``x`` is left
    as it was). The identity on a layout of one rank along the axis."""
    group = _group(mesh, axis)
    if group is None:
        return x
    import torch.distributed as dist

    y = x.detach().clone(memory_format=torch.contiguous_format).reshape(-1)
    dist.all_reduce(y, group=group)
    return y.reshape(x.shape)


def _all_gather(x: torch.Tensor, mesh: Mesh, axis: str) -> torch.Tensor:
    """The blocks of every rank along ``axis`` concatenated on dim 0 in
    coordinate order (every block has ``x``'s shape). The identity on a
    layout of one rank along the axis."""
    group = _group(mesh, axis)
    if group is None:
        return x
    import torch.distributed as dist

    parts = [torch.empty_like(x, memory_format=torch.contiguous_format)
             for _ in range(mesh.shape[axis])]
    dist.all_gather(parts, x.detach().contiguous(), group=group)
    # a group numbers its ranks in their global order, which need not be
    # the order of the coordinates along the axis
    return torch.cat([parts[dist.get_group_rank(group, r)]
                      for r in mesh.axis_ranks(axis)])


def _reduce_data(x: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """The sample-axis sum: chip group then pod group on a hierarchical
    mesh, the data group on a flat one."""
    if is_hierarchical(mesh):
        return _all_reduce(_all_reduce(x, mesh, CHIP_AXIS), mesh, POD_AXIS)
    return _all_reduce(x, mesh, DATA_AXIS)


def hpsum(x, mesh: Mesh, *, op: str = "psum"):
    """All-reduce-sum over the mesh's sample axes: chip then pod on a
    hierarchical mesh, the data group on a flat one. ``op`` labels the
    call in the traffic ledger. ``x`` is this rank's partial; every rank
    gets the sum."""
    if _local(mesh):
        return x
    record_collective(op, mesh, x.shape, x.dtype)
    return _reduce_data(x, mesh)


def hpmean(x, mesh: Mesh, *, op: str = "pmean"):
    """:func:`hpsum` divided by the shard count."""
    return hpsum(x, mesh, op=op) / n_data_shards(mesh)


def _scatter_slice(full: torch.Tensor, size: int, index: int, what: str):
    if full.shape[0] % size:
        raise ValueError(
            f"{what}: axis 0 of length {full.shape[0]} does not divide "
            f"over {size} shards")
    step = full.shape[0] // size
    return full[index * step:(index + 1) * step]


def hpsum_scatter(x, mesh: Mesh, *, op: str = "psum_scatter"):
    """Reduce-scatter: each rank keeps its slice of the full sum, axis 0
    tiled over the ``chip`` axis (the data axis on a flat mesh). It runs
    as an ``all_reduce`` and a slice: gloo has no reduce-scatter of CUDA
    tensors. The ledger charges it as :func:`hpsum`."""
    if _local(mesh):
        return x
    record_collective(op, mesh, x.shape, x.dtype)
    full = _reduce_data(x, mesh)
    axis = CHIP_AXIS if is_hierarchical(mesh) else DATA_AXIS
    return _scatter_slice(full, mesh.shape[axis], mesh.coord(axis),
                          "hpsum_scatter")


def _record_gather(op: str, mesh: Mesh, nbytes: int) -> None:
    """Record one gather of an ``nbytes`` block a data shard over the
    sample axes: ``s - 1`` blocks forwarded a group (the ``mpgather``
    model), the chip stage one group per (pod, model) coordinate, the pod
    stage's blocks a pod's ``cpp`` blocks."""
    nbytes = int(nbytes)
    m = n_model_shards(mesh)
    if is_hierarchical(mesh):
        n_pods = int(mesh.shape[POD_AXIS])
        cpp = int(mesh.shape[CHIP_AXIS])
        _ledger.record(op, CHIP_AXIS, m * n_pods * (cpp - 1) * nbytes)
        _ledger.record(op, POD_AXIS, m * (n_pods - 1) * cpp * nbytes)
    else:
        _ledger.record(op, DATA_AXIS,
                       m * (n_data_shards(mesh) - 1) * nbytes)


def gather_blocks(x, mesh: Mesh, *, op: str = "gather"):
    """Every data shard's block of a row-sharded tensor, concatenated in
    shard order on every rank (this rank passes its own block; every
    block has the same shape): an ``all_gather`` over the data group, or
    over the chip group and then the pod group."""
    if _local(mesh):
        return x
    _record_gather(op, mesh, _local_nbytes(x))
    if is_hierarchical(mesh):
        return _all_gather(_all_gather(x, mesh, CHIP_AXIS), mesh, POD_AXIS)
    return _all_gather(x, mesh, DATA_AXIS)


# ---------------------------------------------------------------------------
# the feature-axis ("model") collective family
# ---------------------------------------------------------------------------


def _local_nbytes(x) -> int:
    return int(np.prod(tuple(x.shape), dtype=np.int64)) * _itemsize(x.dtype)


def mpsum(x, mesh: Mesh, *, op: str = "mpsum"):
    """All-reduce-sum over the ``model`` axis (feature-axis partials).
    The identity, with no ledger entry, when the model axis is absent or
    of size 1; else records ``(m-1)*B`` per data coordinate under the
    ``model`` axis."""
    if n_model_shards(mesh) <= 1:
        return x
    record_axis_collective(op, mesh, MODEL_AXIS, _local_nbytes(x))
    return _all_reduce(x, mesh, MODEL_AXIS)


def mpgather(x, mesh: Mesh, *, op: str = "mpgather", axis: int = 0):
    """All-gather of the model shards' slices, tiled along ``axis``.
    The identity when the model axis is absent or of size 1."""
    if n_model_shards(mesh) <= 1:
        return x
    record_axis_collective(op, mesh, MODEL_AXIS, _local_nbytes(x))
    return _all_gather(x.movedim(axis, 0), mesh, MODEL_AXIS).movedim(0, axis)


def mpsum_scatter(x, mesh: Mesh, *, op: str = "mpsum_scatter"):
    """Reduce-scatter over the ``model`` axis: each model shard keeps its
    ``1/m`` slice of the full sum (axis 0 tiled), as an ``all_reduce`` and
    a slice. The identity when the model axis is absent or of size 1."""
    m = n_model_shards(mesh)
    if m <= 1:
        return x
    record_axis_collective(op, mesh, MODEL_AXIS, _local_nbytes(x))
    return _scatter_slice(_all_reduce(x, mesh, MODEL_AXIS), m,
                          model_index(mesh), "mpsum_scatter")


# ---------------------------------------------------------------------------
# model-axis metering scope
# ---------------------------------------------------------------------------

_model_scope = threading.local()


@contextlib.contextmanager
def model_metered(mesh: Optional[Mesh]):
    """Meter the feature-axis collectives that a solver's contraction seams
    report through :func:`record_model_collective` in this dynamic scope,
    when ``mesh`` has a model axis of size > 1."""
    active = mesh if (mesh is not None and n_model_shards(mesh) > 1) else None
    prev = getattr(_model_scope, "mesh", None)
    _model_scope.mesh = active
    try:
        yield
    finally:
        _model_scope.mesh = prev


def model_metered_mesh() -> Optional[Mesh]:
    """The mesh of the innermost active :func:`model_metered` scope (None
    outside any scope, or when the scope's mesh has no model axis)."""
    return getattr(_model_scope, "mesh", None)


def record_model_collective(op: str, shape, dtype) -> None:
    """Record one feature-axis collective of a GLOBAL ``(shape, dtype)``
    operand under the active :func:`model_metered` scope: ``(m-1)*B`` on
    the ``model`` axis. No-op outside a scope."""
    mesh = model_metered_mesh()
    if mesh is None:
        return
    m = n_model_shards(mesh)
    nbytes = int(np.prod(tuple(shape), dtype=np.int64)) * _itemsize(dtype)
    _ledger.record(op, MODEL_AXIS, (m - 1) * nbytes)


__all__ += ["model_metered_mesh", "gather_blocks"]

# re-exported for consumers that already import hierarchy
__all__ += ["data_axes", "data_pspec", "is_hierarchical", "n_data_shards",
            "n_model_shards"]

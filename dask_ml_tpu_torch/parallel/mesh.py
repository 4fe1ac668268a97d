"""The multi-device layout of the PyTorch port (counterpart of
``dask_ml_tpu/parallel/mesh.py``).

The JAX package runs one process over every device and ``shard_map`` runs
a function's body once per device. The PyTorch idiom is one process per
device, so here **one rank = one process = one device = one mesh
coordinate**. A :class:`Mesh` holds the axis names and the shape, the
global ranks laid out on that grid, this rank's coordinate and device, and
one ``torch.distributed`` process group per axis through which the
collectives of :mod:`~dask_ml_tpu_torch.parallel.hierarchy` reduce.

Ranks fill the grid in row-major order of the axes (pod-major on a
``("pod", "chip")`` mesh, as ``make_mesh`` reshapes the JAX device list),
so data shard ``i`` is rank ``i`` in both the flat and the hierarchical
layout, and on a mesh with a ``"model"`` axis the data shard of rank ``r``
is ``r // n_model``.

A tensor that the JAX package holds sharded over the data axes is, in the
port, the block each rank holds: every function that takes ``mesh=`` reads
its row arguments as this rank's block. There is no ``shard_map``: the
code that JAX runs inside one is plain per-rank code here, and each
reduction across blocks is an explicit collective.

Without an initialised process group, :func:`default_mesh` is a world of
one rank on the configured device: every collective on it is the identity
and records nothing, and staging pads nothing. A mesh over more ranks than
one can be built without a process group as a layout (its shape, the
``*_pspec`` and ``*_sharding`` descriptors, ``collective_bytes``); its
collectives need the world that :func:`dask_ml_tpu_torch.parallel.runtime.
initialize` joins. The ``*_sharding`` helpers describe a rank's block (a
:class:`ShardLayout`): the port has no ``NamedSharding``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import threading
from typing import Optional, Sequence

import numpy as np

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: the two-level sample axes (:mod:`~dask_ml_tpu_torch.parallel.hierarchy`):
#: ``pod`` the slow outer dimension, ``chip`` the fast inner one; hot
#: reductions run chip first, so one reduced partial per pod crosses pods
POD_AXIS = "pod"
CHIP_AXIS = "chip"

__all__ = [
    "DATA_AXIS", "MODEL_AXIS", "POD_AXIS", "CHIP_AXIS", "Mesh",
    "ShardLayout", "make_mesh", "default_mesh", "use_mesh", "make_2d_mesh",
    "is_hierarchical", "data_axes", "data_pspec", "n_data_shards",
    "n_model_shards", "data_sharding", "has_model_axis", "feature_pspec",
    "is_sharded", "collective_mesh",
    "feature_sharding", "replicated_sharding",
]


class Mesh:
    """Global ranks on a named grid, this rank's place on it, and one
    process group per axis.

    ``devices`` is the grid of global ranks (the JAX mesh's device grid),
    ``shape`` maps each axis name to its size in axis order, ``rank`` is
    this process's global rank (``None`` when it is not on the grid or no
    world is joined), ``coords`` its index along each axis, ``device`` its
    ``torch.device`` (``None``: the configured one). ``groups`` maps an
    axis to the process group of the ranks that share every other
    coordinate with this one; it is empty for a layout-only mesh."""

    def __init__(self, devices: np.ndarray, axis_names: Sequence[str], *,
                 rank: Optional[int] = None, device=None,
                 groups: Optional[dict] = None):
        self.devices = np.asarray(devices, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, self.devices.shape))
        self.rank = rank
        self.device = device
        self.groups = dict(groups or {})
        self.coords = None
        if rank is not None:
            where = np.argwhere(self.devices == rank)
            if len(where):
                self.coords = dict(zip(self.axis_names,
                                       (int(i) for i in where[0])))

    @property
    def size(self) -> int:
        return int(self.devices.size)

    @property
    def distributed(self) -> bool:
        """Whether the mesh's collectives run over process groups (it was
        built over an initialised world)."""
        return bool(self.groups)

    def coord(self, axis: str) -> int:
        """This rank's index along ``axis`` (0 on a world of one)."""
        if self.coords is None:
            if self.size == 1:
                return 0
            raise RuntimeError(
                f"this process is not a rank of the {self.shape} mesh "
                "(join the world with runtime.initialize and build the mesh "
                "on every rank)")
        return self.coords[axis]

    def axis_ranks(self, axis: str) -> list:
        """The global ranks along ``axis`` that share every other
        coordinate with this rank, in coordinate order."""
        idx = tuple(slice(None) if a == axis else self.coord(a)
                    for a in self.axis_names)
        return [int(r) for r in self.devices[idx]]

    def __repr__(self) -> str:
        return (f"Mesh({self.shape}, rank={self.rank}, coords={self.coords},"
                f" device={self.device})")


@dataclasses.dataclass(frozen=True)
class ShardLayout:
    """Where a rank's block of a sharded array lies: block ``row_index``
    of ``n_row_blocks`` equal row blocks and, on a feature-sharded layout,
    block ``col_index`` of ``n_col_blocks`` column blocks (``spec`` is the
    JAX ``PartitionSpec``'s entries as a tuple)."""

    spec: tuple
    row_index: int = 0
    n_row_blocks: int = 1
    col_index: int = 0
    n_col_blocks: int = 1

    def rows(self, n_padded: int) -> slice:
        """This rank's rows of an axis of ``n_padded`` (a multiple of the
        block count)."""
        size = n_padded // self.n_row_blocks
        return slice(self.row_index * size, (self.row_index + 1) * size)

    def cols(self, d_padded: int) -> slice:
        size = d_padded // self.n_col_blocks
        return slice(self.col_index * size, (self.col_index + 1) * size)


_lock = threading.Lock()
_default_mesh: Optional[Mesh] = None
_default_world: Optional[int] = None
_mesh_stack: list = []


def _world():
    """(rank, world size, the default group) of the initialised process
    group, else None."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size(), dist.group.WORLD
    return None


def _axis_groups(devices: np.ndarray, axis_names, rank: int) -> dict:
    """One process group per axis: the ranks that share every other
    coordinate with ``rank``. ``torch.distributed.new_group`` is
    collective over the whole world, so every rank creates every group of
    every axis, in the same order, and keeps its own."""
    import torch.distributed as dist

    groups = {}
    for ax, name in enumerate(axis_names):
        moved = np.moveaxis(devices, ax, -1)
        for idx in itertools.product(*(range(s) for s in moved.shape[:-1])):
            ranks = [int(r) for r in moved[idx]]
            g = dist.new_group(ranks)
            if rank in ranks:
                groups[name] = g
    return groups


def make_mesh(
    n_devices: Optional[int] = None,
    devices: Optional[Sequence[int]] = None,
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (DATA_AXIS,),
) -> Mesh:
    """Build a mesh over ``devices``: global ranks, by default every rank
    of the initialised world (one rank, 0, without one). ``n_devices``
    keeps the first ones. One entry of ``shape`` may be None (or -1) to be
    solved from the rank count. Ranks fill the grid in row-major order.

    Inside an initialised world the process groups are created here, so
    every rank must build the same meshes in the same order (the SPMD
    rule of ``torch.distributed.new_group``)."""
    world = _world()
    if devices is None:
        devices = range(world[1]) if world is not None else [0]
    devices = [int(d) for d in devices]
    if n_devices is not None:
        devices = devices[:n_devices]
    if shape is None:
        if len(axis_names) != 1:
            raise ValueError(
                f"make_mesh needs a shape for the {len(axis_names)}-axis "
                f"mesh {tuple(axis_names)} over {len(devices)} devices; "
                "pass shape=... (one entry may be None to auto-factor it "
                "from the device count)")
        shape = (len(devices),)
    shape = list(shape)
    if len(shape) != len(axis_names):
        raise ValueError(
            f"mesh shape {tuple(shape)} has {len(shape)} entries but "
            f"axis_names {tuple(axis_names)} has {len(axis_names)}")
    free = [i for i, s in enumerate(shape) if s is None or s == -1]
    if len(free) > 1:
        raise ValueError(
            f"mesh shape {tuple(shape)} leaves more than one axis of "
            f"{tuple(axis_names)} unspecified; at most one entry may be "
            "None/-1")
    if free:
        known = int(np.prod([int(s) for i, s in enumerate(shape)
                             if i != free[0]])) if len(shape) > 1 else 1
        if known <= 0 or len(devices) % known:
            raise ValueError(
                f"cannot auto-factor axis {axis_names[free[0]]!r}: "
                f"{len(devices)} devices do not divide by the specified "
                f"sizes {tuple(shape)} of axes {tuple(axis_names)}")
        shape[free[0]] = len(devices) // known
    shape = tuple(int(s) for s in shape)
    if int(np.prod(shape)) != len(devices):
        raise ValueError(
            f"mesh shape {shape} for axes {tuple(axis_names)} needs "
            f"{int(np.prod(shape))} devices but {len(devices)} are "
            "available; pass devices=/n_devices= or adjust the shape "
            "(one entry may be None to auto-factor)")
    grid = np.asarray(devices, dtype=np.int64).reshape(shape)
    if world is None:
        return Mesh(grid, axis_names, rank=0 if grid.size == 1 else None)
    from dask_ml_tpu_torch.parallel import runtime

    if max(devices) >= world[1]:
        raise ValueError(
            f"mesh ranks {devices} exceed the world of {world[1]} ranks")
    return Mesh(grid, axis_names, rank=world[0], device=runtime.device(),
                groups=_axis_groups(grid, tuple(axis_names), world[0]))


def default_mesh() -> Mesh:
    """The active mesh: the innermost :func:`use_mesh` scope, else the
    process-wide ``set_config(mesh=...)``, else a flat mesh over every
    rank of the initialised world (built once, on first use, which every
    rank must reach), else a world of one rank on the configured
    device."""
    if _mesh_stack:
        return _mesh_stack[-1]
    from dask_ml_tpu_torch import config as config_lib

    configured = config_lib.get_config()["mesh"]
    if configured is not None:
        return configured
    global _default_mesh, _default_world
    world = _world()
    key = None if world is None else (world[1], id(world[2]))
    with _lock:
        if _default_mesh is None or _default_world != key:
            _default_mesh = make_mesh()
            _default_world = key
        return _default_mesh


def collective_mesh(mesh: Optional[Mesh] = None) -> Optional[Mesh]:
    """The mesh a computation that reduces across ranks runs over:
    ``mesh`` (default :func:`default_mesh`), or None for a world of one
    rank with no process group, whose callers then take the single-device
    path as it is."""
    mesh = mesh or default_mesh()
    return mesh if (mesh.groups or mesh.size > 1) else None


@contextlib.contextmanager
def use_mesh(mesh: Mesh):
    """Scoped override of the default mesh."""
    _mesh_stack.append(mesh)
    try:
        yield mesh
    finally:
        _mesh_stack.pop()


def make_2d_mesh(n_data: int, n_model: int,
                 devices: Optional[Sequence[int]] = None) -> Mesh:
    """An ``(n_data, n_model)`` mesh with axes ``('data', 'model')``: the
    sample axis shards over ``data``, the feature axis over ``model``."""
    return make_mesh(devices=devices, shape=(n_data, n_model),
                     axis_names=(DATA_AXIS, MODEL_AXIS))


def is_hierarchical(mesh: Optional[Mesh] = None) -> bool:
    """True for a mesh with the two-level ``('pod', 'chip')`` sample axes,
    the 3-axis ``('pod', 'chip', 'model')`` variant included."""
    mesh = mesh or default_mesh()
    return POD_AXIS in mesh.axis_names and CHIP_AXIS in mesh.axis_names


def data_axes(mesh: Optional[Mesh] = None) -> tuple:
    """The axes the sample axis shards over: ``('pod', 'chip')`` on a
    hierarchical mesh, ``('data',)`` otherwise."""
    mesh = mesh or default_mesh()
    if is_hierarchical(mesh):
        return (POD_AXIS, CHIP_AXIS)
    return (DATA_AXIS,)


def data_pspec(mesh: Optional[Mesh] = None, ndim: int = 2) -> tuple:
    """The row-sharded spec, as the entries of the JAX ``PartitionSpec``:
    ``('data', None, ...)`` flat, ``(('pod', 'chip'), None, ...)``
    hierarchical."""
    mesh = mesh or default_mesh()
    axes = data_axes(mesh)
    first = axes[0] if len(axes) == 1 else axes
    return (first,) + (None,) * (ndim - 1)


def n_data_shards(mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or default_mesh()
    return int(np.prod([mesh.shape[a] for a in data_axes(mesh)]))


def n_model_shards(mesh: Optional[Mesh] = None) -> int:
    """Size of the feature-parallel axis; 1 on a data-only mesh."""
    mesh = mesh or default_mesh()
    return mesh.shape.get(MODEL_AXIS, 1)


def is_sharded(mesh: Optional[Mesh]) -> bool:
    """Whether ``mesh`` splits the rows over more than one data shard
    (None, or a world of one, does not)."""
    return mesh is not None and n_data_shards(mesh) > 1


def has_model_axis(mesh: Optional[Mesh] = None) -> bool:
    """True when ``mesh`` carries a ``model`` axis of size > 1."""
    return n_model_shards(mesh) > 1


def data_index(mesh: Optional[Mesh] = None) -> int:
    """This rank's data shard: its index over the data axes, pod-major."""
    mesh = mesh or default_mesh()
    i = 0
    for a in data_axes(mesh):
        i = i * mesh.shape[a] + mesh.coord(a)
    return i


def model_index(mesh: Optional[Mesh] = None) -> int:
    mesh = mesh or default_mesh()
    return mesh.coord(MODEL_AXIS) if MODEL_AXIS in mesh.shape else 0


def feature_pspec(mesh: Optional[Mesh] = None, ndim: int = 2) -> tuple:
    """The feature-sharded spec: rows over the data axes, columns over
    ``'model'``; ``ndim=1`` is ``('model',)``."""
    mesh = mesh or default_mesh()
    if ndim == 1:
        return (MODEL_AXIS,)
    axes = data_axes(mesh)
    first = axes[0] if len(axes) == 1 else axes
    return (first, MODEL_AXIS) + (None,) * (ndim - 2)


def data_sharding(mesh: Optional[Mesh] = None, ndim: int = 2) -> ShardLayout:
    """This rank's block of a row-sharded array."""
    mesh = mesh or default_mesh()
    return ShardLayout(data_pspec(mesh, ndim), data_index(mesh),
                       n_data_shards(mesh))


def feature_sharding(mesh: Optional[Mesh] = None,
                     ndim: int = 2) -> ShardLayout:
    """This rank's block of an array sharded over rows and columns (or of
    a per-feature vector, ``ndim=1``)."""
    mesh = mesh or default_mesh()
    if ndim == 1:
        return ShardLayout(feature_pspec(mesh, 1), 0, 1, model_index(mesh),
                           n_model_shards(mesh))
    return ShardLayout(feature_pspec(mesh, ndim), data_index(mesh),
                       n_data_shards(mesh), model_index(mesh),
                       n_model_shards(mesh))


def replicated_sharding(mesh: Optional[Mesh] = None) -> ShardLayout:
    """Every rank holds the whole array."""
    return ShardLayout(())

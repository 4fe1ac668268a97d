"""Multi-process runtime of the PyTorch port (counterpart of
``dask_ml_tpu/parallel/runtime.py``).

The JAX package joins every host into one multi-controller runtime with
``jax.distributed.initialize``. The port's unit is one process per device:
:func:`initialize` joins this process, as one rank, into a
``torch.distributed`` world, and a mesh built over the world
(:func:`global_mesh`, or :func:`~dask_ml_tpu_torch.parallel.mesh.
default_mesh` once a world exists) runs the collectives of
:mod:`~dask_ml_tpu_torch.parallel.hierarchy` over its process groups.

The backend is the caller's choice and nothing here changes it:

- ``"nccl"`` when every rank has a card of its own. It needs CUDA, and
  :func:`initialize` checks, across the world, that no two ranks hold the
  same card (NCCL refuses two ranks on one card);
- ``"gloo"`` on the CPU, and for ranks that share one card: its
  collectives take CUDA tensors too.

Each process stages its own block of the sample axis
(:func:`~dask_ml_tpu_torch.parallel.sharding.prepare_data` with a mesh,
or :func:`process_rows` for a loader that reads only its rows).
"""

from __future__ import annotations

import logging
import os
from typing import Optional

import torch

from dask_ml_tpu_torch.parallel import mesh as mesh_lib

logger = logging.getLogger(__name__)

__all__ = ["initialize", "is_initialized", "shutdown", "device",
           "set_process_info", "process_rank", "process_count",
           "global_mesh", "process_rows"]

_initialized = False
_device: Optional[torch.device] = None

BACKENDS = ("nccl", "gloo")


def _init_method(coordinator_address, init_method) -> str:
    if init_method is not None:
        return str(init_method)
    if coordinator_address is None:
        raise ValueError(
            "runtime.initialize needs coordinator_address='host:port' of "
            "rank 0 or init_method= ('tcp://host:port' or 'file:///path')")
    addr = str(coordinator_address)
    return addr if "://" in addr else f"tcp://{addr}"


def _rank_device(backend: str, process_id: int, local_device_ids):
    """The device this rank computes on: the configured device type, on
    the card ``local_device_ids`` names (default: ``process_id`` modulo
    the visible cards)."""
    from dask_ml_tpu_torch.config import get_config

    kind = torch.device(get_config()["device"]).type
    if backend == "nccl" and kind != "cuda":
        raise ValueError(
            "backend='nccl' reduces CUDA tensors; the configured device is "
            f"{kind!r} (use backend='gloo' on the CPU)")
    if kind != "cuda":
        return torch.device(kind)
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"backend={backend!r} on the configured device 'cuda', but "
            "torch.cuda.is_available() is False"
            + ("; nccl needs a CUDA card for each rank" if backend == "nccl"
               else "; pass config device='cpu' for a CPU world"))
    if local_device_ids is None:
        index = process_id % torch.cuda.device_count()
    else:
        ids = ([local_device_ids] if isinstance(local_device_ids, int)
               else list(local_device_ids))
        index = int(ids[0])
    return torch.device("cuda", index)


def _check_distinct_cards(dev: torch.device) -> None:
    """Under NCCL every rank must hold a card of its own: gather each
    rank's (host, card bus id) over a gloo group and raise on a
    repeat."""
    import socket

    import torch.distributed as dist

    props = torch.cuda.get_device_properties(dev)
    mine = (socket.gethostname(), getattr(props, "pci_bus_id", None),
            str(getattr(props, "uuid", dev.index)))
    side = dist.new_group(backend="gloo")
    everyone = [None] * dist.get_world_size()
    dist.all_gather_object(everyone, mine, group=side)
    dist.destroy_process_group(side)
    seen = {}
    for r, key in enumerate(everyone):
        if key in seen:
            raise RuntimeError(
                f"backend='nccl' needs a distinct card for each rank: "
                f"ranks {seen[key]} and {r} both hold {key}; use "
                "backend='gloo' for ranks that share a card")
        seen[key] = r


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    local_device_ids=None,
    backend: Optional[str] = None,
    init_method: Optional[str] = None,
    timeout_s: float = 300.0,
) -> None:
    """Join this process, as rank ``process_id`` of ``num_processes``, into
    a ``torch.distributed`` world (idempotent).

    ``backend`` is required: ``"nccl"`` (a distinct card for each rank,
    checked) or ``"gloo"`` (the CPU, or ranks that share a card). The
    rendezvous is ``init_method`` (``"tcp://host:port"`` or
    ``"file:///path"``, a store file no other world uses) or
    ``coordinator_address`` (``"host:port"`` of rank 0). ``num_processes``
    and ``process_id`` default to the ``DASK_ML_TPU_NUM_PROCESSES`` /
    ``DASK_ML_TPU_PROCESS_ID`` environment variables. ``local_device_ids``
    names this rank's card (an int or a one-element list; default
    ``process_id`` modulo the visible cards), which becomes the current
    CUDA device; the configured device type (``config`` knob ``device``)
    decides between the card and the CPU."""
    global _initialized, _device
    if _initialized:
        logger.debug("runtime.initialize: already initialized, skipping")
        return
    if backend not in BACKENDS:
        raise ValueError(
            f"runtime.initialize needs backend='nccl' or 'gloo'; got "
            f"{backend!r} (nothing picks a backend on its own)")
    env = _env_process_info()
    if process_id is None or num_processes is None:
        if env is None:
            raise ValueError(
                "runtime.initialize needs process_id= and num_processes= "
                "(or DASK_ML_TPU_PROCESS_ID / DASK_ML_TPU_NUM_PROCESSES)")
        process_id = env[0] if process_id is None else process_id
        num_processes = env[1] if num_processes is None else num_processes
    process_id, num_processes = int(process_id), int(num_processes)
    if not 0 <= process_id < num_processes:
        raise ValueError(
            f"process_id {process_id} out of range [0, {num_processes})")
    dev = _rank_device(backend, process_id, local_device_ids)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    import datetime

    import torch.distributed as dist

    dist.init_process_group(
        backend=backend, init_method=_init_method(coordinator_address,
                                                  init_method),
        world_size=num_processes, rank=process_id,
        timeout=datetime.timedelta(seconds=timeout_s))
    try:
        if backend == "nccl":
            _check_distinct_cards(dev)
    except BaseException:
        dist.destroy_process_group()
        raise
    _device = dev
    _initialized = True
    logger.info("distributed runtime up: rank %d/%d, backend %s, device %s",
                process_id, num_processes, backend, dev)


def is_initialized() -> bool:
    return _initialized


def device() -> Optional[torch.device]:
    """This rank's device after :func:`initialize` (None before)."""
    return _device


def shutdown() -> None:
    """Leave the world: destroy the process groups (the default mesh over
    the world goes with them)."""
    global _initialized, _device
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
    _device = None


# ---------------------------------------------------------------------------
# process-rank plumbing (the elastic data plane reads it)
# ---------------------------------------------------------------------------

# Resolution order: explicit set_process_info() > DASK_ML_TPU_PROCESS_ID /
# DASK_ML_TPU_NUM_PROCESSES env > the torch.distributed world when this
# process joined one > single-process defaults (0 of 1).

_process_info: "Optional[tuple[int, int]]" = None


def set_process_info(rank: Optional[int], count: Optional[int]) -> None:
    """Pin this process's (rank, world-size) for the elastic data plane.
    Pass ``None, None`` to clear back to env/runtime resolution."""
    global _process_info
    if rank is None and count is None:
        _process_info = None
        return
    rank, count = int(rank), int(count)
    if not 0 <= rank < count:
        raise ValueError(f"process rank {rank} out of range [0, {count})")
    _process_info = (rank, count)


def _env_process_info() -> "Optional[tuple[int, int]]":
    r = os.environ.get("DASK_ML_TPU_PROCESS_ID")
    n = os.environ.get("DASK_ML_TPU_NUM_PROCESSES")
    if r is None or n is None:
        return None
    return int(r), int(n)


def process_rank() -> int:
    """This process's rank (see the resolution order above)."""
    if _process_info is not None:
        return _process_info[0]
    env = _env_process_info()
    if env is not None:
        return env[0]
    world = mesh_lib._world()
    return world[0] if world is not None else 0


def process_count() -> int:
    """The number of participating processes."""
    if _process_info is not None:
        return _process_info[1]
    env = _env_process_info()
    if env is not None:
        return env[1]
    world = mesh_lib._world()
    return world[1] if world is not None else 1


def global_mesh(axis_names=(mesh_lib.DATA_AXIS,), shape=None) -> mesh_lib.Mesh:
    """A mesh over every rank of the world, in rank order (one rank, 0,
    before :func:`initialize`). For ``('data', 'model')`` pass
    ``shape=(n_data, n_model)``. Every rank must call it, in the same
    order as its other meshes."""
    return mesh_lib.make_mesh(shape=shape, axis_names=axis_names)


def process_rows(n_rows: int) -> tuple:
    """This process's contiguous [start, stop) slice of a length-``n_rows``
    sample axis, by even split over the world's processes (the remainder
    to the front ones)."""
    world = mesh_lib._world()
    p, np_ = world[:2] if world is not None else (0, 1)
    base, rem = divmod(n_rows, np_)
    start = p * base + min(p, rem)
    stop = start + base + (1 if p < rem else 0)
    return start, stop

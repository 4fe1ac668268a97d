"""ReplicaHost: one out-of-process serving replica, the worker half of the
process fleet (the counterpart of ``dask_ml_tpu/parallel/replica.py``).

A replica is its own OS process, so a crash, an out-of-memory error or a
broken CUDA context stays inside it: the kernel contains the fault, and
the router (``parallel/procfleet.py``) sees a dead process, replays its
requests and spawns another.

One ``ReplicaHost`` process:

- serves on the device it is told (``--device``; the router pins each
  slot's card with ``CUDA_VISIBLE_DEVICES`` before the spawn). Told
  ``cuda`` without a card, it exits non-zero with the error in its log:
  it never serves on the CPU unless asked;
- loads its models from a registry snapshot the router wrote
  (:func:`save_registry_snapshot`: the shared frame codec under its own
  magic, atomic rename + sha256, as checkpoints are), read from a path on
  one box, or, on a machine of a cross-machine roster, fetched first from
  the router's :class:`~dask_ml_tpu_torch.parallel.snapshots.
  SnapshotServer` chunk by chunk through the machine's chunk cache
  (``--snapshot-server``), so a second replica or a respawn on a warm
  machine ships no snapshot byte. The snapshot holds
  no torch object: each tensor of a fitted estimator is pickled as a
  numpy array and made a tensor again on the child's own device at load,
  so a snapshot written beside the card loads in a CPU child;
- warms every (model, method, bucket) through the serving path before it
  announces itself, so it serves with no kernel build and no library
  load once in rotation (the ``stats`` op reports the counts);
- serves a :class:`~dask_ml_tpu_torch.parallel.serving.ServingLoop`
  behind a :class:`~dask_ml_tpu_torch.parallel.fleet.FleetServer`,
  announcing its address atomically in ``workdir/<name>.addr.json``;
- beats on :class:`~dask_ml_tpu_torch.parallel.elastic.FileHeartbeat`:
  SIGTERM drains (every queued request answered) and leaves a tombstone;
  SIGKILL leaves nothing, its beats just stop. A dispatch thread stalled
  past ``wedge_timeout_s`` stops the beats too, so a wedged replica is
  respawned rather than routed to;
- may carry deterministic chaos plans: a real ``SIGKILL`` of itself after
  N served requests (:meth:`~dask_ml_tpu_torch.parallel.faults.
  FaultInjector.kill_process`) and a real straggler
  (:meth:`~dask_ml_tpu_torch.parallel.faults.FaultInjector.
  straggle_replica`).

Its ``stats`` extras report the device (``str(device)`` and the card's
name), the launch counters of the port's kernels, and its library builds
and loads (``n_builds``, ``n_loads``, and how many of each came after the
warmup), so a caller can see that a child really ran the kernels.

Run as ``python -m dask_ml_tpu_torch.parallel.replica --name r0
--snapshot /path/snap.reg --workdir /path/fleet --device cuda`` (the
router does this); add ``--snapshot-server host:port --snapshot-cache DIR
--machine m0`` to fetch the snapshot into ``--snapshot`` first.

The first start phase, ``import_s``, is the process's age when
:meth:`ReplicaHost.run` begins: the interpreter's start and the imports of
torch and the port.
"""

from __future__ import annotations

import argparse
import io
import json
import os
import pickle
import signal
import tempfile
import threading
import time
from typing import Optional

__all__ = [
    "ReplicaHost",
    "REGISTRY_MAGIC",
    "save_registry_snapshot",
    "load_registry_snapshot",
    "main",
]

#: the registry snapshot's magic (the JAX package's): the shared frame
#: codec, sha256 tier. A snapshot is a trusted-disk file the router writes
#: for its own children; it never travels the socket (the wire is the
#: typed codec)
REGISTRY_MAGIC = b"DMLTFREG1\n"

_load_state = threading.local()


def _host_tensor(array, dtype: Optional[str] = None):
    """Unpickling hook of a snapshot tensor: the numpy array as a tensor on
    the device :func:`load_registry_snapshot` stages on (bf16 arrives as
    its uint16 bits)."""
    import torch

    t = torch.as_tensor(array)
    if dtype == "bfloat16":
        t = t.view(torch.bfloat16)
    return t.to(getattr(_load_state, "device", None) or "cpu")


def _torch_dtype(name: str):
    import torch

    return getattr(torch, name)


def _torch_device(name: str):
    import torch

    return torch.device(name)


class _SnapshotPickler(pickle.Pickler):
    """Pickles every tensor as a numpy array (and a torch dtype or device
    by its name), so the snapshot holds no torch object."""

    def reducer_override(self, obj):
        import torch

        if isinstance(obj, torch.Tensor):
            t = obj.detach().cpu()
            if t.dtype == torch.bfloat16:
                return _host_tensor, (t.view(torch.int16).numpy().view(
                    "uint16"), "bfloat16")
            return _host_tensor, (t.numpy(),)
        if isinstance(obj, torch.dtype):
            return _torch_dtype, (str(obj).rsplit(".", 1)[-1],)
        if isinstance(obj, torch.device):
            return _torch_device, (str(obj),)
        return NotImplemented


def save_registry_snapshot(path: str, models) -> None:
    """Atomically write the fleet's model registry: ``models`` is a list of
    ``(name, fitted_estimator, methods_or_None)``. Framed (length +
    sha256) and renamed into place, so a child never loads a torn
    snapshot."""
    from dask_ml_tpu_torch.parallel import framing

    buf = io.BytesIO()
    _SnapshotPickler(buf, protocol=pickle.HIGHEST_PROTOCOL).dump(
        {"models": list(models)})
    frame = framing.encode_frame(buf.getvalue(), magic=REGISTRY_MAGIC)
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".reg.tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(frame)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def load_registry_snapshot(path: str, device=None):
    """The ``(name, estimator, methods)`` list of
    :func:`save_registry_snapshot`, frame-checked first (corruption raises
    a ``FrameError``, never unpickles noise); the estimators' tensors are
    made on ``device`` (default the CPU)."""
    from dask_ml_tpu_torch.parallel import framing

    with open(path, "rb") as f:
        data = f.read()
    body = framing.decode_frame(data, magic=REGISTRY_MAGIC)
    prior = getattr(_load_state, "device", None)
    _load_state.device = device
    try:
        return pickle.loads(body)["models"]
    finally:
        _load_state.device = prior


def _process_age() -> Optional[float]:
    """Seconds since this process was created (Linux ``/proc``, 10 ms
    ticks), or ``None`` where that cannot be read."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - start
    except (OSError, ValueError, IndexError, AttributeError):
        return None


def _launches_now() -> dict:
    from dask_ml_tpu_torch import _kernels

    with _kernels._launches_lock:
        return {k: int(v) for k, v in _kernels.launches.items() if v}


def _builds_now() -> dict:
    from dask_ml_tpu_torch._kernels import build

    with build._builds_lock:
        return {"builds": build.builds["nvcc"] + build.builds["cc"],
                "loads": build.builds["loads"]}


class ReplicaHost:
    """One serving-replica process (the module docstring has the role).

    Parameters
    ----------
    name : str
        The replica's fleet-wide name: its heartbeat member, its address
        file's stem, its loop's name.
    snapshot_path : str
        The registry snapshot to serve (:func:`save_registry_snapshot`).
    workdir : str
        The shared coordination directory (heartbeats, tombstones, address
        files).
    device : str
        Where the loop serves: ``"cuda"`` (the default; raises without a
        card) or ``"cpu"``.
    max_batch_rows, max_queue
        Forwarded to the :class:`~dask_ml_tpu_torch.parallel.serving.
        ServingLoop`.
    heartbeat_interval_s : float
        Beat cadence (the router declares a death past its own timeout).
    wedge_timeout_s : float
        Seconds the dispatch thread may go without a beat before this
        process stops beating (a wedged batch reads as a death).
    kill_after_requests : int, optional
        Chaos: a real ``SIGKILL`` to this process once that many wire
        requests were served.
    straggle_s, straggle_every : float, int
        Chaos: every ``straggle_every``-th batch sleeps ``straggle_s``.
    snapshot_server : str, optional
        ``host:port`` of the router's :class:`~dask_ml_tpu_torch.parallel.
        snapshots.SnapshotServer`. When set, ``snapshot_path`` is the
        destination: the registry is fetched chunk by chunk through the
        machine's cache (:func:`~dask_ml_tpu_torch.parallel.snapshots.
        fetch_snapshot`) before it is loaded.
    snapshot_cache : str, optional
        The machine's chunk cache directory (default
        ``workdir/chunk-cache``).
    machine : str
        This replica's machine name: the label of its chunk requests
        (``slow_link`` plans, ``snapshot.bytes_fetched{machine=}``).
    """

    def __init__(self, name: str, snapshot_path: str, workdir: str, *,
                 device: str = "cuda",
                 max_batch_rows: int = 1024,
                 max_queue: int = 4096,
                 heartbeat_interval_s: float = 0.05,
                 wedge_timeout_s: float = 10.0,
                 kill_after_requests: Optional[int] = None,
                 straggle_s: float = 0.0,
                 straggle_every: int = 1,
                 snapshot_server: Optional[str] = None,
                 snapshot_cache: Optional[str] = None,
                 machine: str = ""):
        self.name = str(name)
        self.snapshot_path = str(snapshot_path)
        self.workdir = str(workdir)
        self.device = str(device)
        self.max_batch_rows = int(max_batch_rows)
        self.max_queue = int(max_queue)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.wedge_timeout_s = float(wedge_timeout_s)
        self.kill_after_requests = kill_after_requests
        self.straggle_s = float(straggle_s)
        self.straggle_every = int(straggle_every)
        self.snapshot_server = snapshot_server
        self.snapshot_cache = snapshot_cache
        self.machine = str(machine)
        #: the transfer accounting of the snapshot fetch (machines mode)
        self._fetch_stats: Optional[dict] = None
        #: seconds of each start phase: import, cuda_init, fetch (machines
        #: mode), snapshot, warmup (of which load: the kernel libraries'
        #: first loads)
        self.phases: dict = {}
        self._warm = {"builds": 0, "loads": 0}
        #: the launch counters when the warmup ended
        self._warm_launches: dict = {}
        self._dev = None
        self._device_name = ""
        self._loop = None
        self._server = None
        self._stop = threading.Event()

    # -- the wire `stats` op payload --------------------------------------

    def _extra_stats(self) -> dict:
        now = _builds_now()
        steady_builds = now["builds"] - self._warm["builds"]
        steady_loads = now["loads"] - self._warm["loads"]
        launches = _launches_now()
        steady = {k: v - self._warm_launches.get(k, 0)
                  for k, v in launches.items()}
        return {
            "replica": self.name,
            "device": str(self._dev),
            "device_name": self._device_name,
            # since this process started (the warmup's included), and
            # since the warmup ended (traffic only)
            "launches": launches,
            "steady_launches": {k: v for k, v in steady.items() if v},
            "n_builds": int(now["builds"]),
            "n_loads": int(now["loads"]),
            "steady_builds": int(steady_builds),
            "steady_loads": int(steady_loads),
            # a compile is a build or a first library load; the respawn
            # gate holds it at 0 once the warmup is done
            "steady_compiles": int(steady_builds + steady_loads),
            "warm_compiles": int(self._warm["builds"]
                                 + self._warm["loads"]),
            "phases": dict(self.phases),
            "snapshot_fetch": self._fetch_stats,
        }

    def _addr_path(self) -> str:
        return os.path.join(self.workdir, f"{self.name}.addr.json")

    def _announce(self, warm: dict) -> None:
        """Publish this replica's address, pid, device, warmup and start
        phases atomically: the router's readiness signal, written only
        after the warmup."""
        info = {"name": self.name, "host": self._server.address[0],
                "port": int(self._server.address[1]),
                "pid": os.getpid(), "device": str(self._dev),
                "device_name": self._device_name, "warmup": warm,
                "phases": dict(self.phases),
                "snapshot_fetch": self._fetch_stats}
        path = self._addr_path()
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(info, f)
        os.replace(tmp, path)

    def run(self) -> int:
        """Serve until SIGTERM (drain, tombstone, exit 0) or SIGKILL
        (nothing at all). Returns the exit code."""
        t0 = time.perf_counter()
        import torch

        from dask_ml_tpu_torch.config import config_context, resolve_device
        from dask_ml_tpu_torch.parallel import framing
        from dask_ml_tpu_torch.parallel.elastic import FileHeartbeat
        from dask_ml_tpu_torch.parallel.faults import (
            FaultInjector,
            GracefulDrain,
        )
        from dask_ml_tpu_torch.parallel.fleet import FleetServer
        from dask_ml_tpu_torch.parallel.serving import (
            ModelRegistry,
            ServingLoop,
        )
        from dask_ml_tpu_torch.parallel.shapes import track_compiles

        # the interpreter's start and every import, the package's own
        # (which ``python -m`` runs before this module) included
        age = _process_age()
        self.phases["import_s"] = (age if age is not None
                                   else time.perf_counter() - t0)

        os.makedirs(self.workdir, exist_ok=True)
        live = FileHeartbeat(self.workdir)
        live.beat(self.name)

        injector = FaultInjector()
        if self.straggle_s > 0.0:
            injector.straggle_replica(self.name, self.straggle_s,
                                      every=self.straggle_every)
        if self.kill_after_requests is not None:
            injector.kill_process(self.name, after_requests=int(
                self.kill_after_requests))

        with config_context(device=self.device):
            t0 = time.perf_counter()
            dev = resolve_device()  # raises when told cuda without a card
            if dev.type == "cuda":
                if dev.index is None:
                    dev = torch.device("cuda", torch.cuda.current_device())
                torch.empty(1, device=dev)
                torch.cuda.synchronize(dev)
                self._device_name = torch.cuda.get_device_name(dev)
            else:
                self._device_name = "cpu"
            self._dev = dev
            self.phases["cuda_init_s"] = time.perf_counter() - t0

            # the wire's host C library before the counts, so that only
            # the kernel libraries' loads land in the warmup
            framing.crc32c_engine()
            if self.snapshot_server is not None:
                # machines mode: the registry comes over the snapshot wire,
                # chunk by chunk through the machine's shared cache
                from dask_ml_tpu_torch.parallel.snapshots import (
                    fetch_snapshot,
                    parse_address,
                )

                t0 = time.perf_counter()
                self._fetch_stats = fetch_snapshot(
                    parse_address(self.snapshot_server), self.snapshot_path,
                    cache_dir=(self.snapshot_cache or os.path.join(
                        self.workdir, "chunk-cache")),
                    machine=self.machine)
                self.phases["fetch_s"] = time.perf_counter() - t0
            t0 = time.perf_counter()
            registry = ModelRegistry()
            for mname, est, methods in load_registry_snapshot(
                    self.snapshot_path, device=dev):
                registry.register(mname, est, methods=methods)
            self.phases["snapshot_s"] = time.perf_counter() - t0

            drain = GracefulDrain(signals=(signal.SIGTERM,))
            self._loop = ServingLoop(
                registry, max_batch_rows=self.max_batch_rows,
                max_queue=self.max_queue, drain=drain, device=dev,
                fault_injector=injector, name=self.name)
            with drain:
                self._loop.start()
                t0 = time.perf_counter()
                with track_compiles():
                    warm = self._loop.warmup()
                self.phases["warmup_s"] = time.perf_counter() - t0
                self.phases["load_s"] = warm["load_seconds"]
                self._warm = _builds_now()
                self._warm_launches = _launches_now()
                self._server = FleetServer(
                    self._loop, extra_stats=self._extra_stats).start()
                self._announce(warm)
                live.beat(self.name)
                # the main thread beats and polls the chaos plan until a
                # drain (SIGTERM) or a stop lands
                while not self._stop.is_set() and not drain.requested:
                    # a dispatch thread stalled past wedge_timeout_s
                    # silences the file beat too, so the router respawns
                    # a wedged replica
                    if self._loop.heartbeat_age() <= self.wedge_timeout_s:
                        live.beat(self.name)
                    injector.maybe_kill_process(self.name,
                                                self._server.n_requests)
                    if not self._loop.alive() \
                            and self._loop.fatal is not None:
                        break  # dispatch crashed: die visibly
                    self._stop.wait(self.heartbeat_interval_s)
                # graceful exit: answer the queue, then the tombstone
                self._loop.stop(drain=True)
                self._server.stop()
                live.tombstone(self.name)
        return 0 if self._loop.fatal is None else 1

    def stop(self) -> None:
        self._stop.set()


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m dask_ml_tpu_torch.parallel.replica",
        description="one out-of-process serving replica (spawned by the "
                    "process fleet's router)")
    parser.add_argument("--name", required=True)
    parser.add_argument("--snapshot", required=True)
    parser.add_argument("--workdir", required=True)
    parser.add_argument("--device", default="cuda")
    parser.add_argument("--max-batch-rows", type=int, default=1024)
    parser.add_argument("--max-queue", type=int, default=4096)
    parser.add_argument("--heartbeat-interval-s", type=float, default=0.05)
    parser.add_argument("--wedge-timeout-s", type=float, default=10.0)
    parser.add_argument("--kill-after-requests", type=int, default=None)
    parser.add_argument("--straggle-s", type=float, default=0.0)
    parser.add_argument("--straggle-every", type=int, default=1)
    parser.add_argument("--snapshot-server", default=None,
                        help="host:port: fetch the snapshot chunk by chunk "
                             "into --snapshot instead of reading it there")
    parser.add_argument("--snapshot-cache", default=None)
    parser.add_argument("--machine", default="")
    args = parser.parse_args(argv)
    host = ReplicaHost(
        args.name, args.snapshot, args.workdir,
        device=args.device,
        max_batch_rows=args.max_batch_rows,
        max_queue=args.max_queue,
        heartbeat_interval_s=args.heartbeat_interval_s,
        wedge_timeout_s=args.wedge_timeout_s,
        kill_after_requests=args.kill_after_requests,
        straggle_s=args.straggle_s,
        straggle_every=args.straggle_every,
        snapshot_server=args.snapshot_server,
        snapshot_cache=args.snapshot_cache,
        machine=args.machine)
    return host.run()


if __name__ == "__main__":
    raise SystemExit(main())

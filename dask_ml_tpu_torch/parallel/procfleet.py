"""ProcessFleet: serving replicas as OS processes behind one router, with
hedging and respawn (the single-box part of
``dask_ml_tpu/parallel/procfleet.py``).

The in-process :class:`~dask_ml_tpu_torch.parallel.fleet.ServingFleet`
routes over replica threads: one interpreter, one CUDA context, one fault
domain. This module is the same router over real processes:

- **Replicas are processes.** :meth:`ProcessFleet.start` writes the
  registered models to a registry snapshot
  (:func:`~dask_ml_tpu_torch.parallel.replica.save_registry_snapshot`:
  tensors as numpy arrays, no torch object), then spawns one
  :class:`~dask_ml_tpu_torch.parallel.replica.ReplicaHost` per slot with
  ``subprocess.Popen`` (fork and exec: the child never inherits the
  parent's CUDA context), each told ``--device`` and, on the card, given
  its ``CUDA_VISIBLE_DEVICES`` (with one card every child gets card 0,
  and each has its own context on it). The router holds nothing but
  :class:`~dask_ml_tpu_torch.parallel.fleet.FleetClient` connections, so
  a replica's crash, out-of-memory error or broken context cannot take the
  router or a sibling down.
- **Liveness is fused.** A replica's health combines the
  :class:`~dask_ml_tpu_torch.parallel.elastic.FileHeartbeat` beats and
  tombstones (a SIGKILL leaves silence, a SIGTERM a tombstone) with the
  process exit code (``poll()``), the wire connection dying, and request
  deadlines.
- **Re-route, replay, respawn.** A dead replica's requests replay on
  survivors from the router's host copy, idempotent by request id: the
  first resolution wins, so a false death costs duplicate compute, never
  a lost or doubled answer. The slot then respawns: a fresh process loads
  the snapshot, warms every program through the serving path, and only
  then rejoins rotation (its address file appears after the warmup), so it
  serves with no kernel build and no library load.
- **Hedging.** A request waiting past ``hedge_factor`` times a quantile of
  its replica's recent latencies (floored at ``hedge_min_s``) is sent once
  more to the next-best replica; the first answer wins.
- **Machines.** Given a ``machines=`` roster (``parallel/launcher.py``),
  slots are placed across machines weighted by their device inventory,
  each machine's workdir carries its own heartbeats, and the registry
  ships chunk-addressed over the snapshot wire (``parallel/snapshots.py``)
  through one chunk cache a machine, so a second replica or a respawn on a
  warm machine fetches no snapshot byte. A machine all of whose replicas
  die at once is marked down: its requests replay on survivors and its
  slots respawn on the surviving machines. Without a roster the fleet runs
  on one implicit local machine and the children read the snapshot from
  disk.

Several processes on one card time-slice it (without MPS their kernels
never overlap), so on one H100 the fleet buys fault isolation, not
throughput.

Telemetry, at the increment sites: ``serving.hedged{replica=}``,
``serving.hedge_wins{replica=}``, ``fleet.respawns{replica=,pid=}``,
``fleet.replica_deaths{replica=,pid=}``, ``fleet.reroutes{replica=}``,
``fleet.spillover{replica=}``, ``fleet.shed{model=}``, ``fleet.drains``,
``fleet.scale_ups``, ``fleet.machine_deaths{machine=}`` and the
``fleet.replica_up`` gauge.
"""

from __future__ import annotations

import dataclasses
import json
import os
import signal as signal_mod
import subprocess
import sys
import tempfile
import threading
import time
import uuid
from collections import deque
from concurrent.futures import Future
from typing import Optional

import numpy as np

from dask_ml_tpu_torch.parallel import framing
from dask_ml_tpu_torch.parallel.fleet import (
    FleetClient,
    FleetTimeoutError,
    _set_future,
)
from dask_ml_tpu_torch.parallel.launcher import (
    LocalLauncher,
    MachineSpec,
    plan_placement,
)
from dask_ml_tpu_torch.parallel.replica import save_registry_snapshot
from dask_ml_tpu_torch.parallel.serving import (
    DeadlineExceeded,
    ServingClosed,
    ServingError,
    ServingQueueFull,
    ServingStopped,
    _fail_future,
)

__all__ = ["ProcessFleet"]


@dataclasses.dataclass(eq=False)
class _ProcReplica:
    """The router's record of one replica process slot."""

    slot: int
    name: str
    #: the roster row the slot runs on (placed at start, scale-up and
    #: respawn)
    machine: Optional[MachineSpec] = None
    proc: Optional[subprocess.Popen] = None
    pid: Optional[int] = None
    address: Optional[tuple] = None
    client: Optional[FleetClient] = None
    warmup: Optional[dict] = None
    #: the incarnation's announce: its device and start phases
    announce: Optional[dict] = None
    #: the incarnation's snapshot transfer (machines mode): bytes_fetched,
    #: chunks_cached, ...
    fetch: Optional[dict] = None
    #: seconds from this incarnation's spawn to its readiness
    start_s: Optional[float] = None
    t_spawn: float = 0.0
    #: (pid, exit code) of every earlier incarnation, reaped at respawn
    past_exits: list = dataclasses.field(default_factory=list)
    gen: int = 0
    dead: bool = False
    #: a retirement in progress (drain_slot): out of rotation, SIGTERM
    #: sent, awaiting the tombstone
    draining: bool = False
    #: a slot that will never respawn (its corpse stays for the exit code)
    retired: bool = False
    inflight: int = 0
    ewma_s: float = 0.0
    lat: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=128))


@dataclasses.dataclass(eq=False)
class _PRequest:
    """The router's host copy of one request: what a replay on a survivor
    or a hedge onto a sibling needs."""

    rid: str
    model: str
    method: str
    X: np.ndarray
    priority: int
    deadline_abs: Optional[float]
    future: Future
    attempts: int = 0
    hedges: int = 0
    #: the success path claims (and counts) under the router lock before
    #: it resolves the future, so the exactly-once count is visible when a
    #: caller's ``result()`` returns
    claimed: bool = False
    #: replica name -> dispatch instant of every attempt still awaiting a
    #: response (the hedge scan reads waits off it; each completion pops
    #: its own entry)
    outstanding: dict = dataclasses.field(default_factory=dict)

    def remaining(self) -> Optional[float]:
        if self.deadline_abs is None:
            return None
        return self.deadline_abs - time.perf_counter()


class ProcessFleet:
    """N replica processes behind a hedging, respawning router (the module
    docstring has the design).

    Register models before :meth:`start`: they reach the replicas as a
    registry snapshot, and each replica stages and warms them on its own
    device before it takes traffic.

    Parameters
    ----------
    n_replicas : int
        Replica process count.
    device : str
        Where every replica serves: ``"cuda"`` (the default; each child is
        pinned to a card with ``CUDA_VISIBLE_DEVICES``, round robin over
        the cards this process sees) or ``"cpu"``.
    max_batch_rows, max_queue
        Forwarded to every replica's serving loop.
    heartbeat_interval_s, heartbeat_timeout_s
        The children's beat cadence; the router's staleness threshold.
    request_timeout_s : float, optional
        Deadline of one wire attempt: an attempt with no answer in time
        fails as :class:`~dask_ml_tpu_torch.parallel.fleet.
        FleetTimeoutError` and re-routes (the backstop for a process that
        died with its socket open).
    hedge : bool
        Speculative re-submission (the module docstring).
    hedge_quantile, hedge_factor, hedge_min_s, hedge_cold_s
        Threshold = ``max(hedge_min_s, hedge_factor * quantile)`` of the
        target replica's recent latencies (the EWMA while the window is
        short, ``hedge_cold_s`` before any sample).
    respawn : bool
        Respawn dead slots (warm before they rejoin rotation).
    max_replays : int, optional
        Re-route budget of a request (default: the replica count).
    straggle : dict, optional
        Chaos: ``{slot: (seconds, every)}``, the replica sleeps
        ``seconds`` every ``every``-th batch.
    kill_after_requests : dict, optional
        Chaos: ``{slot: n}``, the replica SIGKILLs itself after ``n`` wire
        requests. One-shot: only the slot's first incarnation carries it.
    launcher : Launcher, optional
        The spawn hook (default
        :class:`~dask_ml_tpu_torch.parallel.launcher.LocalLauncher`; a
        deployment over SSH passes an :class:`~dask_ml_tpu_torch.parallel.
        launcher.ExecLauncher`).
    machines : list of MachineSpec, optional
        The cross-machine roster (the module docstring). On the card each
        child still gets its ``CUDA_VISIBLE_DEVICES`` round robin over the
        cards the router sees; a machine's ``env`` overrides it. Default:
        one implicit local machine.
    fault_injector : FaultInjector, optional
        Router-side chaos: ``kill_machine`` plans, polled by the monitor
        (SIGKILL to every replica of the machine at a count of resolved
        requests), and ``slow_link`` plans, which delay the snapshot
        server's chunks to one machine.
    snapshot_chunk_bytes : int, optional
        The snapshot wire's chunk size (default
        :data:`~dask_ml_tpu_torch.parallel.snapshots.DEFAULT_CHUNK_BYTES`).
    """

    #: routing quantum: EWMA differences below it are jitter, not signal
    LATENCY_QUANTUM_S = 0.1

    def __init__(self, *, n_replicas: int = 2,
                 name: str = "pfleet",
                 device: str = "cuda",
                 workdir: Optional[str] = None,
                 max_batch_rows: int = 2048,
                 max_queue: int = 4096,
                 heartbeat_interval_s: float = 0.05,
                 heartbeat_timeout_s: float = 2.0,
                 monitor_interval_s: float = 0.01,
                 spawn_timeout_s: float = 300.0,
                 request_timeout_s: Optional[float] = None,
                 hedge: bool = True,
                 hedge_quantile: float = 0.5,
                 hedge_factor: float = 3.0,
                 hedge_min_s: float = 0.05,
                 hedge_cold_s: float = 0.5,
                 respawn: bool = True,
                 max_replays: Optional[int] = None,
                 straggle: Optional[dict] = None,
                 kill_after_requests: Optional[dict] = None,
                 launcher=None,
                 machines: Optional[list] = None,
                 fault_injector=None,
                 snapshot_chunk_bytes: Optional[int] = None):
        if int(n_replicas) < 1:
            raise ValueError("n_replicas must be >= 1")
        self.n_replicas = int(n_replicas)
        self.name = str(name)
        self.device = str(device)
        self.workdir = workdir
        self.max_batch_rows = int(max_batch_rows)
        self.max_queue = int(max_queue)
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.monitor_interval_s = float(monitor_interval_s)
        self.spawn_timeout_s = float(spawn_timeout_s)
        self.request_timeout_s = request_timeout_s
        self.hedge = bool(hedge)
        self.hedge_quantile = float(hedge_quantile)
        self.hedge_factor = float(hedge_factor)
        self.hedge_min_s = float(hedge_min_s)
        self.hedge_cold_s = float(hedge_cold_s)
        self.respawn = bool(respawn)
        self.max_replays = max_replays
        self._straggle = dict(straggle or {})
        self._kill_after = dict(kill_after_requests or {})
        self._launcher = launcher if launcher is not None else LocalLauncher()
        self._machines_spec = list(machines) if machines else None
        self._fault_injector = fault_injector
        self.snapshot_chunk_bytes = snapshot_chunk_bytes

        self._models: list = []  # (name, estimator, methods)
        self._lock = threading.Lock()
        self._procs: list = []
        self._inflight: dict = {}  # rid -> _PRequest
        self._live = None  # the first machine's FileHeartbeat, at start
        self._machines: list = []  # the MachineSpec roster, set at start
        self._live_by_machine: dict = {}  # machine name -> FileHeartbeat
        self._machine_down: dict = {}  # machine name -> monotonic instant
        self._snap_server = None  # SnapshotServer, machines mode only
        self._next_slot = self.n_replicas  # scale_up slot numbering
        self._closing = False
        self._started = False
        self._monitor_stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._respawners: list = []
        self._rr = 0
        self._snapshot_path: Optional[str] = None
        # operational counts (telemetry mirrors at the increment sites)
        self.n_reroutes = 0
        self.n_spillovers = 0
        self.n_shed = 0
        self.n_replica_deaths = 0
        self.n_respawns = 0
        self.n_machine_deaths = 0
        self.n_drains = 0
        self.n_scale_ups = 0
        self.n_hedged = 0
        self.n_hedge_wins = 0
        self.n_results = 0  # futures this router resolved, once each
        self._timeouts_base = 0  # timeouts of replaced (dead) clients

    # -- lifecycle ---------------------------------------------------------

    def register(self, name: str, estimator, *, methods=None) -> None:
        """Record a fitted model for the registry snapshot (before
        :meth:`start`; the replica processes build the runners)."""
        if self._started:
            raise ServingError(
                "register models before start(): replicas load the "
                "registry snapshot at spawn")
        self._models.append((str(name), estimator, methods))

    def _cuda_ids(self) -> list:
        """The card ids a child may be pinned to: the parent's own
        ``CUDA_VISIBLE_DEVICES`` entries where it has them, else
        ``0 .. device_count - 1``."""
        import torch

        n = torch.cuda.device_count()
        if n < 1:
            raise RuntimeError(
                f"ProcessFleet(device={self.device!r}) needs a CUDA card, "
                "and torch.cuda.device_count() is 0; pass device='cpu' to "
                "serve on the CPU")
        seen = os.environ.get("CUDA_VISIBLE_DEVICES")
        if seen:
            ids = [d.strip() for d in seen.split(",") if d.strip()]
            return ids[:n]
        return [str(i) for i in range(n)]

    def _child_env(self, rep: _ProcReplica) -> dict:
        """The child's environment: the package root first on
        ``PYTHONPATH`` (it runs ``-m dask_ml_tpu_torch.parallel.replica``
        whatever the parent's cwd), and on the card the slot's
        ``CUDA_VISIBLE_DEVICES``, round robin over the cards this process
        sees (one card: every child gets it). The launcher lays the
        machine's own ``env`` over this."""
        env = dict(os.environ)
        pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        env["PYTHONPATH"] = (pkg_root + os.pathsep
                             + env.get("PYTHONPATH", "")).rstrip(os.pathsep)
        if self.device.split(":")[0] == "cuda":
            ids = self._cuda_ids()
            env["CUDA_VISIBLE_DEVICES"] = ids[rep.slot % len(ids)]
        return env

    def _hb(self, rep: _ProcReplica):
        """The heartbeat fabric ``rep`` beats on: its machine's
        workdir's."""
        return self._live_by_machine[rep.machine.name]

    def _spawn(self, rep: _ProcReplica) -> None:
        """Launch ``rep``'s process on its machine (does not wait for
        readiness)."""
        wd = rep.machine.workdir
        self._hb(rep).clear(rep.name)  # a respawn inherits no death
        addr_path = os.path.join(wd, f"{rep.name}.addr.json")
        try:
            os.unlink(addr_path)
        except OSError:
            pass
        device = ("cuda" if self.device.split(":")[0] == "cuda"
                  else self.device)
        cmd = [sys.executable, "-m", "dask_ml_tpu_torch.parallel.replica",
               "--name", rep.name,
               "--workdir", wd,
               "--device", device,
               "--max-batch-rows", str(self.max_batch_rows),
               "--max-queue", str(self.max_queue),
               "--heartbeat-interval-s", str(self.heartbeat_interval_s)]
        if self._snap_server is not None:
            # machines mode: the replica fetches the snapshot over the
            # chunk wire through its machine's cache, then loads that copy
            host, port = self._snap_server.address
            cmd += ["--snapshot", os.path.join(wd, f"{rep.name}.reg"),
                    "--snapshot-server", f"{host}:{port}",
                    "--snapshot-cache", os.path.join(wd, "chunk-cache"),
                    "--machine", rep.machine.name]
        else:
            cmd += ["--snapshot", self._snapshot_path]
        if rep.slot in self._straggle:
            seconds, every = self._straggle[rep.slot]
            cmd += ["--straggle-s", str(float(seconds)),
                    "--straggle-every", str(int(every))]
        if rep.slot in self._kill_after:
            # one-shot, like the plan it arms: a respawn comes back clean
            cmd += ["--kill-after-requests",
                    str(int(self._kill_after.pop(rep.slot)))]
        rep.proc = self._launcher.spawn(
            rep.machine, cmd, env=self._child_env(rep),
            log_path=os.path.join(wd, f"{rep.name}.log"))
        rep.pid = rep.proc.pid
        rep.gen += 1
        rep.start_s = None
        rep.t_spawn = time.perf_counter()

    def _wait_ready(self, rep: _ProcReplica,
                    timeout: Optional[float] = None) -> None:
        """Block until ``rep``'s process announced its warmed server (its
        address file), then connect. Raises, naming the exit code, when
        the process exits first, and on timeout."""
        timeout = self.spawn_timeout_s if timeout is None else timeout
        wd = rep.machine.workdir
        addr_path = os.path.join(wd, f"{rep.name}.addr.json")
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self._closing:
                raise ServingStopped(
                    f"process fleet {self.name!r} is stopping")
            rc = rep.proc.poll()
            if rc is not None:
                raise ServingStopped(
                    f"replica process {rep.name!r} exited with {rc} "
                    "before becoming ready (see its .log in the "
                    f"workdir {wd})")
            if os.path.exists(addr_path):
                with open(addr_path) as f:
                    info = json.load(f)
                if info.get("pid") == rep.pid:
                    rep.address = (info["host"], int(info["port"]))
                    rep.warmup = info.get("warmup")
                    rep.announce = info
                    rep.fetch = info.get("snapshot_fetch")
                    if rep.client is not None:
                        # the dead incarnation's timeouts stay counted
                        with self._lock:
                            self._timeouts_base += rep.client.n_timeouts
                    rep.client = FleetClient(
                        rep.address, timeout=10.0,
                        request_timeout=self.request_timeout_s,
                        shm=rep.machine.shm)
                    rep.client.ping(timeout=30.0)
                    rep.lat.clear()
                    rep.ewma_s = 0.0
                    rep.inflight = 0
                    rep.start_s = time.perf_counter() - rep.t_spawn
                    return
            time.sleep(0.01)
        raise FleetTimeoutError(
            f"replica process {rep.name!r} (pid {rep.pid}) not ready "
            f"within {timeout}s")

    def start(self) -> "ProcessFleet":
        from dask_ml_tpu_torch.parallel import telemetry
        from dask_ml_tpu_torch.parallel.elastic import FileHeartbeat

        if self._started:
            return self
        if not self._models:
            raise ServingError(
                "register at least one model before start()")
        if self.workdir is None:
            self.workdir = tempfile.mkdtemp(
                prefix=f"dask_ml_tpu_torch_{self.name}_")
        os.makedirs(self.workdir, exist_ok=True)
        # the roster: the given machines, or one implicit local machine
        # (the same workdir, one heartbeat fabric, the snapshot read from
        # disk)
        self._machines = (list(self._machines_spec) if self._machines_spec
                          else [MachineSpec(name="local",
                                            workdir=self.workdir)])
        names = [m.name for m in self._machines]
        if len(set(names)) != len(names):
            raise ValueError(f"machine names must be unique: {names}")
        self._live_by_machine = {}
        for m in self._machines:
            os.makedirs(m.workdir, exist_ok=True)
            self._live_by_machine[m.name] = FileHeartbeat(m.workdir)
        self._live = self._live_by_machine[self._machines[0].name]
        self._machine_down = {}
        self._snapshot_path = os.path.join(self.workdir, "registry.reg")
        save_registry_snapshot(self._snapshot_path, self._models)
        # the wire's host C library is built here, once: the children
        # only load it (a build in a child would count as its own)
        framing.crc32c_engine()
        if self._machines_spec:
            # machines mode: the registry ships chunk-addressed over the
            # snapshot wire, not by path
            from dask_ml_tpu_torch.parallel.snapshots import (
                DEFAULT_CHUNK_BYTES,
                SnapshotServer,
            )

            self._snap_server = SnapshotServer(
                self._snapshot_path,
                chunk_bytes=(self.snapshot_chunk_bytes
                             or DEFAULT_CHUNK_BYTES),
                fault_injector=self._fault_injector).start()
        placement = plan_placement(self.n_replicas, self._machines)
        self._procs = [_ProcReplica(slot=i, name=f"{self.name}-p{i}",
                                    machine=placement[i])
                       for i in range(self.n_replicas)]
        self._next_slot = self.n_replicas
        try:
            for rep in self._procs:
                self._spawn(rep)
            for rep in self._procs:
                self._wait_ready(rep)
        except BaseException:
            # replicas are independent processes: a failed start must not
            # leave the ones that came up serving
            for rep in self._procs:
                self._reap_slot(rep)
            if self._snap_server is not None:
                self._snap_server.stop()
            raise
        self._closing = False
        self._started = True
        self._telemetry_inherit = telemetry.enabled()
        self._monitor_stop.clear()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name=f"{self.name}-monitor",
            daemon=True)
        self._monitor.start()
        self._set_replica_up()
        return self

    def __enter__(self) -> "ProcessFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def _reap_slot(self, rep: _ProcReplica) -> None:
        """Tear one slot down: close the wire, SIGTERM the process, SIGKILL
        it if it lingers."""
        if rep.client is not None:
            rep.client.close()
        if rep.proc is None:
            return
        if rep.proc.poll() is None:
            rep.proc.terminate()
        try:
            rep.proc.wait(10.0)
        except subprocess.TimeoutExpired:
            rep.proc.kill()
            try:
                rep.proc.wait(10.0)
            except subprocess.TimeoutExpired:
                pass

    def stop(self, timeout: Optional[float] = 30.0) -> None:
        """Stop the fleet: SIGTERM every replica (each drains, tombstones
        and exits 0), reap them (SIGKILL past ``timeout``), and fail
        whatever the router still holds."""
        with self._lock:
            self._closing = True
        self._monitor_stop.set()
        m = self._monitor
        if m is not None and m.is_alive() \
                and m is not threading.current_thread():
            m.join(timeout)
        # a respawn racing this stop re-checks _closing after readiness
        # and reaps its own child; give it a bounded chance to finish
        for t in list(self._respawners):
            t.join(15.0)
        for rep in self._procs:
            if rep.proc is not None and rep.proc.poll() is None:
                rep.proc.terminate()
        deadline = time.monotonic() + (timeout or 30.0)
        for rep in self._procs:
            if rep.proc is None:
                continue
            try:
                rep.proc.wait(max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                rep.proc.kill()
                rep.proc.wait(10.0)
        for rep in self._procs:
            if rep.client is not None:
                rep.client.close()
        if self._snap_server is not None:
            self._snap_server.stop()
        with self._lock:
            leftovers = list(self._inflight.values())
            self._inflight.clear()
        for freq in leftovers:
            _fail_future(freq.future, ServingStopped(
                f"process fleet {self.name!r} stopped"))

    # -- telemetry helpers -------------------------------------------------

    def _telemetry_on(self) -> bool:
        """Telemetry knob for the router's mirror sites. Completion
        callbacks and respawn threads run on wire-reader/worker threads
        that never saw the creating thread's thread-local scope — like
        the loops' dispatch threads, they inherit the scope that was
        effective at :meth:`start` (so ``config_context(telemetry=True)``
        around ``start()`` behaves the way it reads)."""
        from dask_ml_tpu_torch.parallel import telemetry

        return telemetry.enabled() or getattr(
            self, "_telemetry_inherit", False)

    def _set_replica_up(self) -> None:
        from dask_ml_tpu_torch.parallel import telemetry

        if self._telemetry_on():
            telemetry.metrics().gauge("fleet.replica_up").set(
                self.replicas_up())

    def _count(self, attr: str, counter: str, **labels) -> None:
        """Bump an operational counter AND its registry mirror at this
        increment site."""
        from dask_ml_tpu_torch.parallel import telemetry

        with self._lock:
            setattr(self, attr, getattr(self, attr) + 1)
        if self._telemetry_on():
            telemetry.metrics().counter(counter, **labels).inc()

    # -- routing -----------------------------------------------------------

    @property
    def max_request_rows(self) -> int:
        return self.max_batch_rows

    def replicas_up(self) -> int:
        return sum(1 for rep in self._procs
                   if not rep.dead and not rep.draining
                   and rep.client is not None)

    def _eligible(self, exclude) -> list:
        return [rep for rep in self._procs
                if rep.name not in exclude and not rep.dead
                and not rep.draining and rep.client is not None]

    def _pick(self, exclude) -> Optional[_ProcReplica]:
        """Least-loaded routing on (in-flight attempts, quantized
        client-observed latency EWMA, round-robin) — the same shape as
        the in-process router, but every signal is client-side: the
        router holds no loop references, only wires."""
        live = self._eligible(exclude)
        if not live:
            return None
        with self._lock:
            self._rr += 1
            rr = self._rr
        return min(
            live,
            key=lambda rep: (rep.inflight,
                             int(rep.ewma_s / self.LATENCY_QUANTUM_S),
                             (rep.slot + rr) % max(len(self._procs), 1)))

    def submit(self, model: str, X, method: str = "predict", *,
               priority: int = 0, deadline: Optional[float] = None,
               request_id: Optional[str] = None) -> Future:
        """Route one request to the least-loaded live replica process;
        returns a router-level Future that survives replica-process
        death (re-route + replay + hedge, idempotent by request id)."""
        if self._closing or not self._started:
            raise ServingStopped(
                f"process fleet {self.name!r} is not accepting requests")
        rid = str(request_id) if request_id is not None else uuid.uuid4().hex
        with self._lock:
            existing = self._inflight.get(rid)
            if existing is not None:
                return existing.future
        now = time.perf_counter()
        if deadline is not None and float(deadline) <= 0.0:
            self._count("n_shed", "fleet.shed", model=str(model))
            raise DeadlineExceeded(
                f"request deadline {float(deadline):.3f}s is already "
                "past at fleet admission")
        freq = _PRequest(
            rid=rid, model=str(model), method=str(method),
            X=np.asarray(X), priority=int(priority),
            deadline_abs=None if deadline is None else now + float(deadline),
            future=Future())
        self._route(freq, sync=True)
        return freq.future

    def call(self, model: str, X, method: str = "predict", *,
             priority: int = 0, deadline: Optional[float] = None,
             timeout: Optional[float] = None) -> np.ndarray:
        from dask_ml_tpu_torch.parallel import telemetry

        with telemetry.span("fleet.request", model=str(model),
                            method=str(method)):
            return self.submit(model, X, method=method, priority=priority,
                               deadline=deadline).result(timeout)

    def _replay_budget(self) -> int:
        return (self.max_replays if self.max_replays is not None
                else max(len(self._procs), 1))

    def _terminal(self, freq: _PRequest, exc: BaseException,
                  sync: bool) -> None:
        with self._lock:
            self._inflight.pop(freq.rid, None)
        if sync:
            raise exc
        _fail_future(freq.future, exc)

    def _route(self, freq: _PRequest, *, sync: bool,
               exclude: Optional[set] = None,
               cause: Optional[BaseException] = None) -> None:
        """Place ``freq`` on a replica process. ``sync=True`` (first
        admission) propagates terminal errors to the caller;
        ``sync=False`` (replay/hedge-failure path) sets them on the
        router future. ``cause`` is the failure that triggered a replay
        — surfaced instead of a generic no-live-replica error when the
        route dead-ends (the replica that timed a request out may be
        perfectly alive)."""
        exclude = set() if exclude is None else set(exclude)
        while True:
            if self._closing:
                self._terminal(freq, ServingStopped(
                    f"process fleet {self.name!r} is stopping"), sync)
                return
            rep = self._pick(exclude)
            if rep is None:
                self._terminal(freq, cause if cause is not None
                               else ServingStopped(
                                   f"process fleet {self.name!r} has no "
                                   "live replica"),
                               sync)
                return
            remaining = freq.remaining()
            if remaining is not None and remaining <= 0.0:
                self._count("n_shed", "fleet.shed", model=freq.model)
                self._terminal(freq, DeadlineExceeded(
                    f"request {freq.rid} deadline passed during routing"),
                    sync)
                return
            if self._dispatch(freq, rep, hedge=False):
                return
            exclude.add(rep.name)

    def _dispatch(self, freq: _PRequest, rep: _ProcReplica, *,
                  hedge: bool) -> bool:
        """One wire attempt of ``freq`` on ``rep``; False when the send
        itself failed (caller excludes the replica and retries)."""
        remaining = freq.remaining()
        t0 = time.perf_counter()
        try:
            cfut = rep.client.submit(
                freq.model, freq.X, method=freq.method,
                priority=freq.priority, deadline=remaining,
                timeout=self.request_timeout_s)
        except Exception:  # noqa: BLE001 — transport refusal, not request
            return False
        with self._lock:
            freq.attempts += 1
            rep.inflight += 1
            freq.outstanding[rep.name] = t0
            self._inflight[freq.rid] = freq
        cfut.add_done_callback(
            lambda f, freq=freq, rep=rep, t0=t0, hedge=hedge:
            self._on_client_done(freq, rep, t0, hedge, f))
        return True

    def _observe_latency(self, rep: _ProcReplica, dt: float) -> None:
        with self._lock:
            rep.lat.append(dt)
            rep.ewma_s = (dt if rep.ewma_s == 0.0
                          else 0.7 * rep.ewma_s + 0.3 * dt)

    def _maybe_retire(self, freq: _PRequest) -> None:
        """Drop ``freq`` from the in-flight table once its future is
        resolved and no attempt is still outstanding."""
        with self._lock:
            if freq.future.done() and not freq.outstanding:
                self._inflight.pop(freq.rid, None)

    def _on_client_done(self, freq: _PRequest, rep: _ProcReplica,
                        t0: float, hedge: bool, cfut) -> None:
        """One wire attempt completed (on the client's reader/reaper
        thread). Success resolves the router future (first resolution
        wins); transport-class failures re-route; request-class failures
        are terminal.

        Replay ownership: popping the attempt's ``outstanding`` entry IS
        the replay ticket. When a replica dies, this callback (fired by
        the client close) and ``_declare_dead``'s victim sweep both see
        the same failed attempt — whoever pops the entry first owns the
        reroute; the other path skips it, so one failed attempt never
        burns two units of replay budget."""
        with self._lock:
            rep.inflight = max(rep.inflight - 1, 0)
            owned = freq.outstanding.get(rep.name) == t0
            if owned:
                freq.outstanding.pop(rep.name, None)
        try:
            result = cfut.result()
        except ServingQueueFull:
            # remote backpressure: spill over to a sibling — same replay
            # ticket as the transport branch (a racing _declare_dead may
            # already have claimed this attempt)
            if owned:
                self._count("n_spillovers", "fleet.spillover",
                            replica=rep.name)
                self._reroute_or_fail(freq, rep, ServingQueueFull(
                    f"replica {rep.name!r} queue full"))
            else:
                self._maybe_retire(freq)
        except framing.PayloadError as e:
            # request-class, deterministic (e.g. the model's output is
            # not wire-encodable): replaying it on a sibling would just
            # fail n_replicas times — fail THIS caller once, like the
            # in-process tier does. Must precede the transport branch:
            # PayloadError subclasses FrameError.
            self._terminal(freq, e, sync=False)
        except (ServingStopped, ServingClosed, FleetTimeoutError,
                OSError, framing.FrameError) as e:
            # the REPLICA (or its wire) went away, not the request —
            # reroute only if this callback owns the attempt (see
            # docstring; _declare_dead may have claimed it already)
            if owned:
                self._reroute_or_fail(freq, rep, e)
            else:
                self._maybe_retire(freq)
        except DeadlineExceeded as e:
            if not freq.future.done():
                self._count("n_shed", "fleet.shed", model=freq.model)
            self._terminal(freq, e, sync=False)
        except BaseException as e:  # noqa: BLE001 — the request's error
            self._terminal(freq, e, sync=False)
        else:
            self._observe_latency(rep, time.perf_counter() - t0)
            with self._lock:
                won = not freq.claimed and not freq.future.done()
                if won:
                    freq.claimed = True
                    self.n_results += 1  # counted BEFORE the resolve:
                    #                      see _PRequest.claimed
            if won:
                if _set_future(freq.future, result):
                    if hedge:
                        self._count("n_hedge_wins", "serving.hedge_wins",
                                    replica=rep.name)
                else:
                    with self._lock:  # client cancelled under us
                        self.n_results -= 1
            self._maybe_retire(freq)

    def _reroute_or_fail(self, freq: _PRequest, rep: _ProcReplica,
                         cause: BaseException) -> None:
        if freq.future.done():
            self._maybe_retire(freq)
            return
        if freq.attempts > self._replay_budget():
            with self._lock:
                outstanding = bool(freq.outstanding)
            if outstanding:
                # another attempt (a hedge, an earlier dispatch on a
                # slow-but-healthy replica) may still resolve this
                # request — failing it now would hand the caller an
                # error for work the fleet is about to finish. If that
                # attempt fails too, ITS failure path lands here with
                # nothing outstanding and terminates.
                return
            self._terminal(freq, cause, sync=False)
            return
        if not self._eligible({rep.name}):
            # nowhere to replay: surface the REAL cause, and don't count
            # a reroute that never went out
            self._terminal(freq, cause, sync=False)
            return
        self._count("n_reroutes", "fleet.reroutes", replica=rep.name)
        self._route(freq, sync=False, exclude={rep.name}, cause=cause)

    # -- hedging -----------------------------------------------------------

    def _hedge_threshold(self, rep: _ProcReplica) -> float:
        """Adaptive hedge trigger for requests outstanding on ``rep``:
        ``hedge_factor`` × the ``hedge_quantile`` of its recent observed
        latencies (EWMA while the window is short, ``hedge_cold_s``
        before any), floored at ``hedge_min_s``. Adaptive means a
        uniformly-slow replica raises its own bar — hedging targets the
        TAIL, not the mean the router already balances on."""
        with self._lock:
            samples = list(rep.lat)
            ewma = rep.ewma_s
        if len(samples) >= 8:
            base = float(np.quantile(samples, self.hedge_quantile))
        elif ewma > 0.0:
            base = ewma
        else:
            return self.hedge_cold_s
        return max(self.hedge_min_s, self.hedge_factor * base)

    def _hedge_scan(self) -> None:
        now = time.perf_counter()
        with self._lock:
            candidates = [freq for freq in self._inflight.values()
                          if not freq.future.done() and freq.hedges < 1
                          and freq.outstanding]
        by_name = {rep.name: rep for rep in self._procs}
        # one threshold per replica per scan — recomputing the quantile
        # per outstanding attempt would put O(candidates) redundant
        # np.quantile calls on the monitor thread every tick
        thresholds: dict = {}
        for freq in candidates:
            with self._lock:
                waits = list(freq.outstanding.items())
            for rep_name, t0 in waits:
                rep = by_name.get(rep_name)
                if rep is None:
                    continue
                thr = thresholds.get(rep_name)
                if thr is None:
                    thr = thresholds[rep_name] = \
                        self._hedge_threshold(rep)
                if now - t0 > thr:
                    # exclude from the locked snapshot (`waits`), not the
                    # live dict a reader callback may be mutating
                    target = self._pick(
                        exclude={n for n, _ in waits} | {rep_name})
                    if target is None:
                        break
                    # consume the budget only when the hedge actually
                    # went out — a failed send (target died under us)
                    # leaves the request eligible for a later scan
                    freq.hedges += 1
                    if self._dispatch(freq, target, hedge=True):
                        self._count("n_hedged", "serving.hedged",
                                    replica=target.name)
                    else:
                        freq.hedges -= 1
                    break

    # -- health monitoring + respawn ---------------------------------------

    def _monitor_loop(self) -> None:
        import contextlib

        from dask_ml_tpu_torch import config as config_lib

        ctx = (config_lib.config_context(telemetry=True)
               if getattr(self, "_telemetry_inherit", False)
               else contextlib.nullcontext())
        with ctx:
            while not self._monitor_stop.wait(self.monitor_interval_s):
                # the monitor is the fleet's ONLY death detector and
                # respawner: one surprised tick must never kill it
                try:
                    self._monitor_tick()
                except Exception:  # noqa: BLE001
                    import logging

                    logging.getLogger(__name__).exception(
                        "process fleet %r: monitor tick failed "
                        "(continuing)", self.name)

    def _maybe_kill_machines(self) -> None:
        """Deliver armed ``kill_machine`` plans: SIGKILL every live
        replica pid on the plan's machine once the fleet has resolved the
        plan's request count, so all of the machine's heartbeats stop at
        once, which is what machine-death detection keys on."""
        inj = self._fault_injector
        if inj is None:
            return
        with self._lock:
            n = self.n_results
        for m in self._machines:
            if not inj.should_kill_machine(m.name, n):
                continue
            for rep in self._procs:
                if rep.machine is m and not rep.dead and not rep.retired \
                        and rep.pid is not None:
                    try:
                        os.kill(rep.pid, signal_mod.SIGKILL)
                    except OSError:
                        pass

    def _monitor_tick(self) -> None:
        if self.hedge:
            self._hedge_scan()
        self._maybe_kill_machines()
        # observe first: each live replica's death verdict with its current
        # generation (the guard in _declare_dead makes a stale verdict, read
        # from a process a racing respawn already replaced, a no-op)
        pending = []
        for rep in self._procs:
            if rep.dead or rep.client is None:
                continue
            gen = rep.gen
            reason = None
            rc = rep.proc.poll() if rep.proc is not None else None
            hb = self._hb(rep)
            if rc is not None:
                reason = f"process exited with {rc}"
            elif hb.has_tombstone(rep.name):
                reason = "tombstone (graceful leave)"
            else:
                age = hb.age(rep.name)
                if age is not None and age > self.heartbeat_timeout_s:
                    reason = f"heartbeat stale {age:.2f}s"
            if reason is not None and not self._closing:
                pending.append((rep, reason, gen))
        if not pending:
            return
        # mark machine deaths before any slot is declared, so that the
        # respawns this tick starts already see the machine down and place
        # elsewhere
        self._mark_machine_deaths(pending)
        for rep, reason, gen in pending:
            self._declare_dead(rep, reason, gen=gen)

    def _mark_machine_deaths(self, pending: list) -> None:
        """A machine is dead when every slot on it that is not retired is
        dying or dead at once, none of them gracefully."""
        if len(self._machines) < 2:
            return
        dying = {rep.name for rep, reason, _gen in pending
                 if "tombstone" not in reason}
        for m in self._machines:
            if m.name in self._machine_down:
                continue
            slots = [rep for rep in self._procs
                     if rep.machine is m and not rep.retired]
            now_dying = [rep for rep in slots if rep.name in dying]
            if not now_dying:
                continue
            if all(rep.dead or rep.name in dying for rep in slots):
                self._machine_down[m.name] = time.monotonic()
                import logging

                logging.getLogger(__name__).warning(
                    "process fleet %r: MACHINE %s declared dead "
                    "(%d replicas down at once)",
                    self.name, m.name, len(now_dying))
                self._count("n_machine_deaths", "fleet.machine_deaths",
                            machine=m.name)

    def _declare_dead(self, rep: _ProcReplica, reason: str, *,
                      gen: Optional[int] = None) -> None:
        """Terminal for this incarnation of the replica: out of
        rotation, in-flight attempts replayed on survivors, then (if
        enabled) the slot respawns — warm first, rotation after.

        ``gen`` is the incarnation the caller OBSERVED dying; if the
        slot respawned in between (gen moved on), the verdict is stale
        and this is a no-op — without the guard, a monitor thread
        descheduled between poll() and here could declare a freshly
        respawned healthy process dead (double-respawn race)."""
        import logging

        if rep.dead:
            return
        if gen is not None and gen != rep.gen:
            return
        if rep.draining:
            # autoscaler retirement completing (tombstone after graceful
            # drain): retire the slot — never respawn, never count a
            # death; the drain finished every queued request first
            rep.dead = True
            rep.retired = True
            self._set_replica_up()
            if rep.client is not None:
                rep.client.close()
            with self._lock:
                victims = [freq for freq in self._inflight.values()
                           if rep.name in freq.outstanding
                           and not freq.future.done()]
            cause = ServingStopped(
                f"replica process {rep.name!r} drained ({reason})")
            for freq in victims:
                with self._lock:
                    owned = freq.outstanding.pop(rep.name, None) \
                        is not None
                if owned:
                    self._reroute_or_fail(freq, rep, cause)
            self._count("n_drains", "fleet.drains", replica=rep.name)
            logging.getLogger(__name__).info(
                "process fleet %r: replica %s (pid %s) drained and "
                "retired: %s", self.name, rep.name, rep.pid, reason)
            return
        rep.dead = True
        self._set_replica_up()
        logging.getLogger(__name__).warning(
            "process fleet %r: replica %s (pid %s) declared dead: %s",
            self.name, rep.name, rep.pid, reason)
        self._count("n_replica_deaths", "fleet.replica_deaths",
                    replica=rep.name, pid=rep.pid)
        # close the wire: its pending futures fail over via their
        # completion callbacks (idempotent with the replay below)
        if rep.client is not None:
            rep.client.close()
        with self._lock:
            victims = [freq for freq in self._inflight.values()
                       if rep.name in freq.outstanding
                       and not freq.future.done()]
        cause = ServingStopped(
            f"replica process {rep.name!r} died ({reason})")
        for freq in victims:
            # popping the outstanding entry claims the replay ticket —
            # the close-triggered completion callback checks the same
            # entry, so each failed attempt reroutes exactly once
            # (rep.inflight is left to the callback's own decrement; a
            # respawn resets it anyway)
            with self._lock:
                owned = freq.outstanding.pop(rep.name, None) is not None
            if owned:
                self._reroute_or_fail(freq, rep, cause)
        if self.respawn and not self._closing:
            t = threading.Thread(
                target=self._respawn, args=(rep,),
                name=f"{rep.name}-respawn", daemon=True)
            # prune finished respawners so a death-looping fleet does
            # not grow this list (and stop()'s join) without bound
            self._respawners = [r for r in self._respawners
                                if r.is_alive()]
            self._respawners.append(t)
            t.start()

    def _pick_spawn_machine(self, exclude_rep=None) -> MachineSpec:
        """The machine a (re)spawn lands on: surviving machines only (all
        of them when every one is marked down, so a one-machine fleet
        still respawns), the least loaded by live slots weighted by device
        inventory."""
        candidates = [m for m in self._machines
                      if m.name not in self._machine_down]
        if not candidates:
            candidates = list(self._machines)
        loads: dict = {m.name: 0 for m in candidates}
        for r in self._procs:
            if r is exclude_rep or r.retired:
                continue
            if r.machine.name in loads:
                loads[r.machine.name] += 1
        return plan_placement(1, candidates, loads=loads)[0]

    def _respawn(self, rep: _ProcReplica) -> None:
        """Bring a dead slot back: a fresh process placed on a surviving
        machine, the snapshot (only the missing chunks, in machines mode),
        the warmup, then rotation (the address file appears after the
        warmup). A stop() racing this re-checks ``_closing`` on both sides
        of the spawn: an incarnation born after the terminate loop ran is
        reaped here, never orphaned."""
        import logging

        old_client = rep.client
        try:
            if rep.proc is not None:
                try:
                    rep.proc.wait(5.0)  # reap the corpse
                except subprocess.TimeoutExpired:
                    rep.proc.kill()
                    rep.proc.wait(5.0)
                rep.past_exits.append((rep.pid, rep.proc.returncode))
            if self._closing:
                return
            target = self._pick_spawn_machine(exclude_rep=rep)
            if target is not rep.machine:
                logging.getLogger(__name__).warning(
                    "process fleet %r: respawning %s on machine %s (was "
                    "%s)", self.name, rep.name, target.name,
                    rep.machine.name)
            rep.machine = target
            self._spawn(rep)
            self._wait_ready(rep)
        except Exception as e:  # noqa: BLE001 — the slot stays dead, visibly
            logging.getLogger(__name__).warning(
                "process fleet %r: respawn of %s failed: %r",
                self.name, rep.name, e)
            self._reap_slot(rep)
            return
        finally:
            if old_client is not None:
                old_client.close()
        if self._closing:
            # stop() ran while the child was warming: it is ours to drain
            self._reap_slot(rep)
            return
        rep.dead = False
        # a machine a slot came up on is alive: clear a stale down mark so
        # later placements may use it again
        self._machine_down.pop(rep.machine.name, None)
        self._count("n_respawns", "fleet.respawns",
                    replica=rep.name, pid=rep.pid)
        self._set_replica_up()

    # -- scale -------------------------------------------------------------

    def scale_up(self, k: int = 1) -> list:
        """Add ``k`` replica slots on the least loaded surviving
        machines, each warmed before it joins rotation: the autoscaler's
        answer to a breach. Returns the new replica names; blocks until
        they are ready (a control loop that does not tick meanwhile has a
        cooldown for free)."""
        if not self._started or self._closing:
            raise ServingStopped(
                f"process fleet {self.name!r} is not running")
        names = []
        for _ in range(int(k)):
            with self._lock:
                slot = self._next_slot
                self._next_slot += 1
            rep = _ProcReplica(slot=slot, name=f"{self.name}-p{slot}",
                               machine=self._pick_spawn_machine(),
                               dead=True)
            # in the roster while warming; dead=True keeps it out of
            # rotation until _wait_ready connects it
            self._procs.append(rep)
            try:
                self._spawn(rep)
                self._wait_ready(rep)
            except BaseException:
                rep.retired = True
                self._reap_slot(rep)
                raise
            rep.dead = False
            names.append(rep.name)
            self._count("n_scale_ups", "fleet.scale_ups",
                        replica=rep.name)
            self._set_replica_up()
        return names

    def drain_slot(self, name: Optional[str] = None) -> Optional[str]:
        """Retire one replica gracefully — the autoscaler's quiet
        response: TOMBSTONE, not kill. The slot leaves rotation
        immediately, gets SIGTERM (graceful drain: it finishes its
        queue, resolves every future, tombstones, exits 0), and the
        monitor retires it when the tombstone lands — no respawn, no
        death counter. Returns the draining replica's name, or None when
        draining would leave the fleet empty."""
        live = self._eligible(set())
        if len(live) <= 1:
            return None
        if name is not None:
            picked = [rep for rep in live if rep.name == name]
            if not picked:
                return None
            rep = picked[0]
        else:
            # least-loaded, newest slot first: scale-down unwinds
            # scale-up
            rep = min(live, key=lambda r: (r.inflight, -r.slot))
        rep.draining = True
        self._set_replica_up()
        if rep.proc is not None and rep.proc.poll() is None:
            rep.proc.terminate()
        return rep.name

    def reset_latency_history(self) -> None:
        """Forget every replica's observed latencies (the routing EWMA and
        the hedge window), as at a replica's readiness: an A/B of routing
        policies starts each arm from here."""
        with self._lock:
            for rep in self._procs:
                rep.lat.clear()
                rep.ewma_s = 0.0

    def signals(self) -> dict:
        """The :class:`~dask_ml_tpu_torch.parallel.autoscaler.Autoscaler`'s
        input: pooled p99 of router-observed request latencies, total
        in-flight depth, cumulative shed count, live replica count — all
        signals the fleet already exports, read without touching a
        replica."""
        with self._lock:
            lats = [dt for rep in self._procs if not rep.retired
                    for dt in rep.lat]
            queue = sum(rep.inflight for rep in self._procs
                        if not rep.dead)
            shed = self.n_shed
        p99 = float(np.quantile(lats, 0.99)) if lats else 0.0
        return {"p99_s": p99, "queue_depth": float(queue),
                "shed_total": float(shed),
                "replicas_up": self.replicas_up()}

    # -- observability -----------------------------------------------------

    def remote_stats(self, timeout: float = 10.0) -> dict:
        """Per-replica ``op="stats"`` snapshots (pid, queue depth,
        latency EWMA, steady-state compile count) from every live
        replica process."""
        out = {}
        for rep in self._procs:
            if rep.dead or rep.client is None:
                continue
            try:
                out[rep.name] = rep.client.stats(timeout=timeout)
            except (ServingError, OSError) as e:
                out[rep.name] = {"error": repr(e)}
        return out

    def stats(self) -> dict:
        with self._lock:
            counters = {
                "reroutes": self.n_reroutes,
                "spillovers": self.n_spillovers,
                "shed": self.n_shed,
                "replica_deaths": self.n_replica_deaths,
                "respawns": self.n_respawns,
                "machine_deaths": self.n_machine_deaths,
                "drains": self.n_drains,
                "scale_ups": self.n_scale_ups,
                "hedged": self.n_hedged,
                "hedge_wins": self.n_hedge_wins,
                "results": self.n_results,
                "inflight": len(self._inflight),
            }
        counters["timeouts"] = self._timeouts_base + sum(
            rep.client.n_timeouts for rep in self._procs
            if rep.client is not None)
        snap = self._snap_server
        return {
            "name": self.name,
            "device": self.device,
            "replicas_up": self.replicas_up(),
            "machines": {m.name: {
                "workdir": m.workdir,
                "devices": m.devices,
                "down": m.name in self._machine_down,
                "replicas": [rep.name for rep in self._procs
                             if rep.machine is m and not rep.retired],
            } for m in self._machines},
            "snapshot_server": None if snap is None else {
                "address": list(snap.address),
                "manifests": snap.n_manifests,
                "chunks": snap.n_chunks,
                "bytes_sent": snap.n_bytes_sent,
            },
            "replicas": {rep.name: {
                "pid": rep.pid,
                "gen": rep.gen,
                "dead": rep.dead,
                "draining": rep.draining,
                "retired": rep.retired,
                "machine": rep.machine.name,
                "inflight": rep.inflight,
                "latency_ewma_s": round(rep.ewma_s, 6),
                "warmup": rep.warmup,
                "start_s": rep.start_s,
                "phases": (rep.announce or {}).get("phases"),
                "snapshot_fetch": rep.fetch,
                # poll(): a drained slot's exit lands after its tombstone
                "returncode": (rep.proc.poll()
                               if rep.proc is not None else None),
                "past_exits": [list(e) for e in rep.past_exits],
                # the router's link to this incarnation: its shm segment,
                # or None on TCP
                "segment": (rep.client.shm_segment
                            if rep.client is not None else None),
            } for rep in self._procs},
            **counters,
        }

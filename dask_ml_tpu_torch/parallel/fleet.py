"""A fault-tolerant fleet of serving loops, and the wire in front of it
(the counterpart of ``dask_ml_tpu/parallel/fleet.py``).

- :class:`ServingFleet` runs N :class:`~dask_ml_tpu_torch.parallel.
  serving.ServingLoop` replicas behind a host-side router. Each replica
  gets a device of its own while there are enough (``devices=`` names
  them); with more replicas than devices they take single devices round
  robin, so on one card every replica shares it, each with its own queue,
  dispatch thread and CUDA stream. The router sends a request to the
  least-loaded replica (queue depth, then the latency EWMA in quanta) and
  spills over to a sibling when a queue is full.
- **Health**: a replica's dispatch thread beats at every collect; a
  monitor thread declares it dead when the beat stalls past
  ``heartbeat_timeout_s`` or the thread is gone, and revives it when the
  beat returns. A circuit breaker takes a replica that failed
  ``max_consecutive_failures`` requests in a row out of rotation for
  ``breaker_cooldown_s``, then lets one probe through.
- **Re-route and replay**: the requests of a replica that died or stopped
  are replayed on a survivor from the fleet's own host copy. A request
  resolves once, by request id: the first resolution of its future wins,
  so a false death costs duplicate compute, never a lost or doubled
  answer.
- **Admission**: ``submit(priority=, deadline=)`` feeds the replicas'
  earliest-deadline-first queues; an expired request is shed with
  :class:`~dask_ml_tpu_torch.parallel.serving.DeadlineExceeded`.
- **Hot-swap**: :meth:`ServingFleet.swap` builds the new version, warms it
  on every live replica, then installs it; batches in flight finish on
  the old one.
- **Hedging** (off by default): a request waiting past ``hedge_factor``
  times a quantile of its replica's recent latencies is sent once more to
  the next-best replica; the first answer wins.

Telemetry, at the increment sites: the ``fleet.reroutes``,
``fleet.spillover``, ``fleet.shed``, ``fleet.swaps``,
``fleet.replica_deaths``, ``serving.hedged`` and ``serving.hedge_wins``
counters, the ``fleet.replica_up`` gauge and the ``fleet.request`` span.

**The wire.** :class:`FleetServer` fronts a :class:`ServingFleet` or one
:class:`~dask_ml_tpu_torch.parallel.serving.ServingLoop` on a socket
speaking the frames of :mod:`~dask_ml_tpu_torch.parallel.framing` (the
JAX package's ``DMLTWIRE3`` frames, CRC-32C, the typed payload: a JSON
control envelope and dtype/shape-tagged buffers, no object deserialized
anywhere, so a JAX package client talks to a port server and back). One
frame is one request; responses return out of order, tagged by id; a
request that fails validation fails its caller's frame only. On one
machine a connection upgrades to the shared-memory ring of
:mod:`~dask_ml_tpu_torch.parallel.shm` (``op="shm_hello"``), the socket
staying open as the doorbell and the liveness channel. :class:`FleetClient`
adds per-request deadlines (:class:`FleetTimeoutError`), one reconnect
after a clean server close, and retries spent from a :class:`RetryBudget`.
The process fleet (``parallel/procfleet.py``) runs each replica as an OS
process behind this wire, on one box or across a roster of machines
(``ProcessFleet(machines=)``, whose registry ships over the snapshot wire
of ``parallel/snapshots.py``). The wire mirrors ``wire.bytes{transport=}``
and ``wire.hash_seconds{algo=}`` (at the framing's hash site) into the
telemetry registry.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import os
import socket
import threading
import time
import uuid
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as _FutureTimeout
from typing import Optional

import numpy as np
import torch

from dask_ml_tpu_torch.parallel import framing
from dask_ml_tpu_torch.parallel.serving import (
    DeadlineExceeded,
    ModelRegistry,
    ServedModel,
    ServingClosed,
    ServingError,
    ServingLoop,
    ServingQueueFull,
    ServingStopped,
    _fail_future,
)

__all__ = [
    "ServingFleet",
    "FleetServer",
    "FleetClient",
    "FleetTimeoutError",
    "RetryBudget",
]


class FleetTimeoutError(ServingError):
    """A request or a ping outlived its deadline without an answer: typed,
    so a caller tells "no answer in time" from a served error."""


def _set_future(fut: Future, result) -> bool:
    """Resolve ``fut`` with ``result`` unless a racing path (a duplicate
    completion after a false death) got there first; True when this call
    did."""
    if fut.done():
        return False
    try:
        if not fut.set_running_or_notify_cancel():
            return False  # the client cancelled it
    except RuntimeError:
        pass  # already claimed (a replay in flight)
    try:
        fut.set_result(result)
        return True
    except Exception:
        return False  # resolved already: duplicate compute, not an error


@dataclasses.dataclass(eq=False)
class _Replica:
    name: str
    loop: ServingLoop
    device: torch.device
    consecutive_failures: int = 0
    breaker_open_until: float = 0.0  # monotonic instant
    dead: bool = False
    #: the fleet-observed latencies of recent requests (the hedge
    #: threshold's quantile)
    lat: deque = dataclasses.field(
        default_factory=lambda: deque(maxlen=128))

    def breaker_open(self) -> bool:
        return time.monotonic() < self.breaker_open_until


@dataclasses.dataclass(eq=False)
class _FleetRequest:
    """The fleet's host copy of one request: what a replay on a survivor
    needs."""

    rid: str
    model: str
    method: str
    X: np.ndarray
    priority: int
    deadline_abs: Optional[float]  # absolute perf_counter instant
    future: Future
    attempts: int = 0
    replica: Optional[str] = None
    hedges: int = 0
    #: replica name -> dispatch instant of each attempt still awaiting its
    #: completion (each completion pops its own entry)
    outstanding: dict = dataclasses.field(default_factory=dict)

    def remaining(self) -> Optional[float]:
        if self.deadline_abs is None:
            return None
        return self.deadline_abs - time.perf_counter()


class ServingFleet:
    """N serving replicas behind a health-checked router (the module
    docstring has the design).

    Parameters
    ----------
    registry : ModelRegistry, optional
        One registry shared by every replica; a private one by default.
    n_replicas : int
        Replica count.
    devices : sequence of torch.device or str, optional
        The replicas' devices, one each (overrides ``n_replicas``);
        default: the configured device's type, replica ``i`` on device
        ``i`` while there are enough, else round robin.
    meshes : sequence of Mesh, optional
        One :class:`~dask_ml_tpu_torch.parallel.mesh.Mesh` of ranks a
        replica (overrides ``n_replicas`` and ``devices``), in a
        ``torch.distributed`` world: every rank of the world builds the
        fleet and calls :meth:`start` in the same order. The router, the
        monitor and every replica's queue stay in the leader's process
        (the lowest rank of all the meshes); replica ``i``'s batches run
        on the ranks of ``meshes[i]``, each its row block
        (``ServingLoop(mesh=)``), over a process group of that mesh's
        ranks plus the leader. Only the leader accepts ``submit``; the
        other ranks' ``stop()`` waits for the leader's.
    policy, max_batch_rows, max_queue, coalesce_window_s, retry_policy
        Handed to every :class:`ServingLoop`.
    heartbeat_interval_s, heartbeat_timeout_s
        The monitor's period and the stall after which a replica is
        declared dead.
    max_consecutive_failures, breaker_cooldown_s
        The circuit breaker.
    max_replays : int, optional
        Re-routes a request may take (default: the replica count).
    hedge, hedge_quantile, hedge_factor, hedge_min_s, hedge_cold_s
        Request hedging (default off) and its threshold:
        ``hedge_factor`` × the ``hedge_quantile`` of the replica's recent
        latencies (its loop's EWMA until 8 samples, ``hedge_cold_s``
        before any), at least ``hedge_min_s``.
    drain : GracefulDrain, optional
        Shared by the fleet and every replica.
    fault_injector : FaultInjector, optional
        Handed to every replica; its plans name replicas
        ``"{name}-r{i}"``.
    """

    def __init__(self, registry: Optional[ModelRegistry] = None, *,
                 n_replicas: int = 2,
                 devices=None,
                 meshes=None,
                 policy=None,
                 max_batch_rows: int = 2048,
                 max_queue: int = 4096,
                 coalesce_window_s="adaptive",
                 heartbeat_interval_s: float = 0.05,
                 heartbeat_timeout_s: float = 2.0,
                 max_consecutive_failures: int = 3,
                 breaker_cooldown_s: float = 1.0,
                 max_replays: Optional[int] = None,
                 hedge: bool = False,
                 hedge_quantile: float = 0.5,
                 hedge_factor: float = 3.0,
                 hedge_min_s: float = 0.05,
                 hedge_cold_s: float = 0.5,
                 drain=None,
                 retry_policy=None,
                 fault_injector=None,
                 name: str = "fleet"):
        self.registry = registry if registry is not None else ModelRegistry()
        self.n_replicas = int(n_replicas)
        self._devices = list(devices) if devices is not None else None
        self._meshes = list(meshes) if meshes is not None else None
        #: over ``meshes``: whether this process routes (the leader)
        self.leads = True
        #: the loops this rank runs blocks for under another's router
        self._follower_loops: list = []
        self.policy = policy
        self.max_batch_rows = int(max_batch_rows)
        self.max_queue = int(max_queue)
        self.coalesce_window_s = (
            coalesce_window_s if isinstance(coalesce_window_s, str)
            else float(coalesce_window_s))
        self.heartbeat_interval_s = float(heartbeat_interval_s)
        self.heartbeat_timeout_s = float(heartbeat_timeout_s)
        self.max_consecutive_failures = int(max_consecutive_failures)
        self.breaker_cooldown_s = float(breaker_cooldown_s)
        self.max_replays = max_replays
        self.hedge = bool(hedge)
        self.hedge_quantile = float(hedge_quantile)
        self.hedge_factor = float(hedge_factor)
        self.hedge_min_s = float(hedge_min_s)
        self.hedge_cold_s = float(hedge_cold_s)
        self.name = str(name)
        self._drain = drain
        self._retry_policy = retry_policy
        self._fault_injector = fault_injector

        self._lock = threading.Lock()
        self._replicas: list = []
        self._inflight: dict = {}  # rid -> _FleetRequest
        self._closing = False
        self._started = False
        self._telemetry_inherit = False
        self._monitor_stop = threading.Event()
        self._monitor: Optional[threading.Thread] = None
        self._rr = 0  # round-robin tiebreak cursor
        # operational counts (telemetry mirrors at the increment sites)
        self.n_reroutes = 0
        self.n_spillovers = 0
        self.n_shed = 0
        self.n_swaps = 0
        self.n_replica_deaths = 0
        self.n_hedged = 0
        self.n_hedge_wins = 0

    # -- lifecycle ---------------------------------------------------------

    def _build_devices(self) -> list:
        """One device per replica: ``devices=`` as given, else replica
        ``i`` on device ``i`` of the configured type while there are
        enough, else round robin over the devices there are (on one card,
        every replica on it)."""
        from dask_ml_tpu_torch.config import resolve_device

        if self._devices is not None:
            if len(self._devices) < 1:
                raise ValueError("devices must name at least one device")
            return [resolve_device(d) for d in self._devices]
        n = self.n_replicas
        if n < 1:
            raise ValueError("n_replicas must be >= 1")
        base = resolve_device()
        if base.type != "cuda":
            return [base] * n
        count = torch.cuda.device_count()
        return [torch.device("cuda", i % count) for i in range(n)]

    def start(self) -> "ServingFleet":
        if self._started:
            return self
        if self._meshes is not None:
            self._start_meshes()
            return self
        devices = self._build_devices()
        self._replicas = []
        for i, dev in enumerate(devices):
            rname = f"{self.name}-r{i}"
            loop = ServingLoop(
                self.registry, policy=self.policy,
                max_batch_rows=self.max_batch_rows,
                max_queue=self.max_queue,
                coalesce_window_s=self.coalesce_window_s,
                device=dev, drain=self._drain,
                retry_policy=self._retry_policy,
                fault_injector=self._fault_injector,
                name=rname)
            loop.start()
            self._replicas.append(_Replica(name=rname, loop=loop,
                                           device=loop.device))
        self._closing = False
        self._started = True
        self._start_monitor()
        return self

    def _start_meshes(self) -> None:
        """``start()`` over ``meshes``: make every replica's group and
        loop on every rank, in replica order; only the leader routes and
        monitors."""
        import torch.distributed as dist

        from dask_ml_tpu_torch.parallel.serving import _FOLLOW_TIMEOUT

        if len(self._meshes) < 1:
            raise ValueError("meshes must name at least one mesh")
        if not (dist.is_available() and dist.is_initialized()):
            raise ServingError(
                "ServingFleet(meshes=) runs in a torch.distributed world: "
                "runtime.initialize on every rank first")
        leader = min(int(r) for m in self._meshes
                     for r in m.devices.reshape(-1))
        self.leads = dist.get_rank() == leader
        self._replicas, self._follower_loops = [], []
        for i, m in enumerate(self._meshes):
            members = sorted({int(r) for r in m.devices.reshape(-1)}
                             | {leader})
            group = dist.new_group(members, timeout=_FOLLOW_TIMEOUT)
            rname = f"{self.name}-r{i}"
            loop = ServingLoop(
                self.registry, policy=self.policy,
                max_batch_rows=self.max_batch_rows,
                max_queue=self.max_queue,
                coalesce_window_s=self.coalesce_window_s,
                mesh=m, drain=self._drain,
                retry_policy=self._retry_policy,
                fault_injector=self._fault_injector,
                name=rname, _group=group, _leader=leader)
            loop.start()
            if self.leads:
                self._replicas.append(_Replica(name=rname, loop=loop,
                                               device=loop.device))
            elif loop.role == "follower":
                self._follower_loops.append(loop)
        self._closing = False
        self._started = True
        if self.leads:
            self._start_monitor()

    def _start_monitor(self) -> None:
        from dask_ml_tpu_torch.parallel import telemetry

        # as in ServingLoop.start: the monitor thread inherits an enabled
        # telemetry scope, so its increment sites mirror under
        # config_context(telemetry=True) around start()
        self._telemetry_inherit = telemetry.enabled()
        self._monitor_stop.clear()
        self._monitor = threading.Thread(
            target=self._monitor_loop, name=f"{self.name}-monitor",
            daemon=True)
        self._monitor.start()
        self._set_replica_up()

    def __enter__(self) -> "ServingFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self, drain: bool = True,
             timeout: Optional[float] = 30.0) -> None:
        """Stop admitting, stop every replica (``drain=True`` flushes their
        queues and resolves their futures), then fail whatever replay
        bookkeeping remains, so nothing is left pending. A rank that does
        not lead a ``meshes=`` fleet waits for the leader's stop."""
        for loop in self._follower_loops:
            loop.stop(timeout=timeout)
        with self._lock:
            self._closing = True
        self._monitor_stop.set()
        m = self._monitor
        if m is not None and m.is_alive() \
                and m is not threading.current_thread():
            m.join(timeout)
        for rep in self._replicas:
            rep.loop.stop(drain=drain, timeout=timeout)
        # a request still in flight lost its completion's replay path
        # (closing: no re-route); fail it rather than leak it
        with self._lock:
            leftovers = list(self._inflight.values())
            self._inflight.clear()
        for freq in leftovers:
            _fail_future(freq.future, ServingStopped(
                f"fleet {self.name!r} stopped"))

    def warmup(self, buckets=None, models=None) -> dict:
        """Warm every (replica, model, method, bucket); summed counts."""
        out = {"n_programs": 0, "n_compiles": 0, "compile_seconds": 0.0,
               "n_loads": 0, "load_seconds": 0.0}
        for rep in self._replicas:
            w = rep.loop.warmup(buckets=buckets, models=models)
            for k in out:
                out[k] += w[k]
        out["compile_seconds"] = round(out["compile_seconds"], 3)
        out["load_seconds"] = round(out["load_seconds"], 3)
        return out

    # -- registry ----------------------------------------------------------

    def register(self, name: str, estimator, *, methods=None) -> ServedModel:
        return self.registry.register(name, estimator, methods=methods)

    def swap(self, name: str, estimator, *, methods=None,
             warmup: bool = True) -> int:
        """Hot-swap: build the new ServedModel, warm it on every live
        replica, then install it with the next version. Batches in flight
        finish on the old one. Returns the new version."""
        from dask_ml_tpu_torch.parallel import telemetry

        model = self.registry.build(name, estimator, methods=methods)
        if warmup:
            for rep in self._replicas:
                if not rep.dead and rep.loop.alive():
                    rep.loop.warmup_model(model)
        self.registry.install(model)
        with self._lock:
            self.n_swaps += 1
        if telemetry.enabled():
            telemetry.metrics().counter("fleet.swaps", model=name).inc()
        return model.version

    # -- routing -----------------------------------------------------------

    @property
    def max_request_rows(self) -> int:
        """The per-request row cap (the replicas' batch budget), so
        ``ParallelPostFit(serving=fleet)`` chunks as against one loop."""
        return self.max_batch_rows

    def replicas_up(self) -> int:
        return sum(1 for rep in self._replicas
                   if not rep.dead and rep.loop.alive())

    def _set_replica_up(self) -> None:
        from dask_ml_tpu_torch.parallel import telemetry

        if telemetry.enabled():
            telemetry.metrics().gauge("fleet.replica_up").set(
                self.replicas_up())

    def _eligible(self, exclude) -> list:
        return [rep for rep in self._replicas
                if rep.name not in exclude and not rep.dead
                and rep.loop.alive()]

    #: the routing quantum of the latency EWMA (seconds): differences
    #: below it are noise and the round-robin tiebreak spreads the load;
    #: a real straggler exceeds it and is routed around
    LATENCY_QUANTUM_S = 0.1

    def _pick(self, exclude) -> Optional[_Replica]:
        """The least-loaded live replica on (queue depth plus a batch in
        flight, quantized latency EWMA), round robin among equals. A
        breaker-open replica is taken only when nothing else is live (the
        half-open probe of the soonest-expiring breaker)."""
        live = self._eligible(exclude)
        if not live:
            return None
        closed = [rep for rep in live if not rep.breaker_open()]
        if not closed:
            return min(live, key=lambda rep: rep.breaker_open_until)
        with self._lock:
            self._rr += 1
            rr = self._rr
        return min(
            closed,
            key=lambda rep: (rep.loop.queue_depth()
                             + (1 if rep.loop.busy else 0),
                             int(rep.loop.latency_s()
                                 / self.LATENCY_QUANTUM_S),
                             (self._replicas.index(rep) + rr)
                             % max(len(self._replicas), 1)))

    def _note_failure(self, rep: _Replica) -> None:
        rep.consecutive_failures += 1
        if rep.consecutive_failures >= self.max_consecutive_failures \
                and not rep.breaker_open():
            rep.breaker_open_until = (time.monotonic()
                                      + self.breaker_cooldown_s)

    def _note_success(self, rep: _Replica) -> None:
        rep.consecutive_failures = 0
        rep.breaker_open_until = 0.0

    def submit(self, model: str, X, method: str = "predict", *,
               priority: int = 0, deadline: Optional[float] = None,
               request_id: Optional[str] = None) -> Future:
        """Route one request to the least-loaded live replica; returns a
        fleet Future that survives a replica's death (re-route and
        replay, once by ``request_id``). A validation error, an expired
        ``deadline`` and backpressure from every live replica raise here.
        Submitting an id already in flight returns its future."""
        if not self.leads:
            raise ServingError(
                f"fleet {self.name!r}: submit on the leader rank, which "
                "routes every replica's requests")
        if self._drain is not None and self._drain.requested:
            self._closing = True
        if self._closing or not self._started:
            raise ServingStopped(
                f"fleet {self.name!r} is not accepting requests")
        rid = str(request_id) if request_id is not None else uuid.uuid4().hex
        with self._lock:
            existing = self._inflight.get(rid)
            if existing is not None:
                return existing.future
        now = time.perf_counter()
        if deadline is not None and float(deadline) <= 0.0:
            self._count_shed(model)
            raise DeadlineExceeded(
                f"request deadline {float(deadline):.3f}s is already past "
                "at fleet admission")
        freq = _FleetRequest(
            rid=rid, model=str(model), method=str(method), X=X,
            priority=int(priority),
            deadline_abs=None if deadline is None else now + float(deadline),
            future=Future())
        self._route(freq, sync=True)
        return freq.future

    def call(self, model: str, X, method: str = "predict", *,
             priority: int = 0, deadline: Optional[float] = None,
             timeout: Optional[float] = None) -> np.ndarray:
        """``submit`` and wait, inside a ``fleet.request`` span."""
        from dask_ml_tpu_torch.parallel import telemetry

        with telemetry.span("fleet.request", model=str(model),
                            method=str(method)):
            return self.submit(model, X, method=method, priority=priority,
                               deadline=deadline).result(timeout)

    def _count_shed(self, model: str) -> None:
        from dask_ml_tpu_torch.parallel import telemetry

        with self._lock:
            self.n_shed += 1
        if telemetry.enabled():
            telemetry.metrics().counter("fleet.shed", model=model).inc()

    def _route(self, freq: _FleetRequest, *, sync: bool,
               exclude: Optional[set] = None) -> None:
        """Place ``freq`` on a replica. ``sync=True`` (first admission)
        raises terminal errors to the caller; ``sync=False`` (a replay)
        sets them on the fleet future. A full queue excludes its replica
        and the next one is tried before backpressure surfaces."""
        from dask_ml_tpu_torch.parallel import telemetry

        exclude = set() if exclude is None else set(exclude)
        queue_full_seen = False
        while True:
            if self._closing:
                self._terminal(freq, ServingStopped(
                    f"fleet {self.name!r} is stopping"), sync)
                return
            rep = self._pick(exclude)
            if rep is None:
                if queue_full_seen:
                    exc: ServingError = ServingQueueFull(
                        "every live replica's queue is at capacity "
                        f"({self.max_queue} requests each)")
                else:
                    exc = ServingStopped(
                        f"fleet {self.name!r} has no live replica")
                self._terminal(freq, exc, sync)
                return
            remaining = freq.remaining()
            if remaining is not None and remaining <= 0.0:
                self._count_shed(freq.model)
                self._terminal(freq, DeadlineExceeded(
                    f"request {freq.rid} deadline passed during routing"),
                    sync)
                return
            t0 = time.perf_counter()
            try:
                rfut = rep.loop.submit(
                    freq.model, freq.X, method=freq.method,
                    priority=freq.priority, deadline=remaining)
            except ServingQueueFull:
                queue_full_seen = True
                exclude.add(rep.name)
                with self._lock:
                    self.n_spillovers += 1
                if telemetry.enabled():
                    telemetry.metrics().counter(
                        "fleet.spillover", replica=rep.name).inc()
                continue
            except ServingClosed:
                # a draining or stopped replica: out of this route, and
                # the monitor decides its fate
                exclude.add(rep.name)
                continue
            except DeadlineExceeded as e:
                self._count_shed(freq.model)
                self._terminal(freq, e, sync)
                return
            except Exception as e:  # noqa: BLE001 — validation errors etc.
                self._terminal(freq, e, sync)
                return
            freq.attempts += 1
            freq.replica = rep.name
            with self._lock:
                freq.outstanding[rep.name] = t0
                self._inflight[freq.rid] = freq
            rfut.add_done_callback(
                lambda f, freq=freq, rep=rep, t0=t0:
                self._on_done(freq, rep, t0, False, f))
            return

    def _terminal(self, freq: _FleetRequest, exc: BaseException,
                  sync: bool) -> None:
        with self._lock:
            self._inflight.pop(freq.rid, None)
        if sync:
            raise exc
        _fail_future(freq.future, exc)

    def _replay_budget(self) -> int:
        return (self.max_replays if self.max_replays is not None
                else max(len(self._replicas), 1))

    def _on_done(self, freq: _FleetRequest, rep: _Replica, t0: float,
                 hedge: bool, rfut) -> None:
        """A replica future's completion (on that replica's dispatch
        thread, or the failing path's). A result or the request's own
        error resolves the fleet future; a replica's death re-routes and
        replays. With hedging a request may have several attempts out:
        each completion pops its own entry, the first result wins, and a
        losing attempt's failure never ends a request a sibling attempt
        can still answer."""
        from dask_ml_tpu_torch.parallel import telemetry
        from dask_ml_tpu_torch.parallel.faults import SimulatedReplicaDeath

        with self._lock:
            owned = freq.outstanding.get(rep.name) == t0
            if owned:
                freq.outstanding.pop(rep.name, None)
        try:
            result = rfut.result()
        except (ServingStopped, ServingClosed, SimulatedReplicaDeath) as e:
            # the replica went away, not the request: re-route and replay
            self._note_failure(rep)
            if freq.future.done() or not owned:
                return  # a sibling attempt resolved it (or will)
            with self._lock:
                still_out = bool(freq.outstanding)
            if freq.attempts > self._replay_budget():
                if still_out:
                    return  # a hedge may still answer; its failure lands here
                self._terminal(freq, e, sync=False)
                return
            with self._lock:
                self.n_reroutes += 1
            if telemetry.enabled():
                telemetry.metrics().counter(
                    "fleet.reroutes", replica=rep.name).inc()
            self._route(freq, sync=False, exclude={rep.name})
        except DeadlineExceeded as e:
            if freq.future.done():
                return
            self._count_shed(freq.model)
            self._terminal(freq, e, sync=False)
        except BaseException as e:  # noqa: BLE001 — the request's own error
            self._note_failure(rep)
            if freq.future.done():
                return
            self._terminal(freq, e, sync=False)
        else:
            self._note_success(rep)
            dt = time.perf_counter() - t0
            with self._lock:
                rep.lat.append(dt)
                self._inflight.pop(freq.rid, None)
            if _set_future(freq.future, result) and hedge:
                with self._lock:
                    self.n_hedge_wins += 1
                if telemetry.enabled():
                    telemetry.metrics().counter(
                        "serving.hedge_wins", replica=rep.name).inc()

    # -- hedging -----------------------------------------------------------

    def _hedge_threshold(self, rep: _Replica) -> float:
        """``hedge_factor`` × the ``hedge_quantile`` of ``rep``'s recent
        latencies (its loop's EWMA while fewer than 8, ``hedge_cold_s``
        before any), at least ``hedge_min_s``."""
        with self._lock:
            samples = list(rep.lat)
        if len(samples) >= 8:
            base = float(np.quantile(samples, self.hedge_quantile))
        else:
            base = float(rep.loop.latency_s())
            if base <= 0.0:
                return self.hedge_cold_s
        return max(self.hedge_min_s, self.hedge_factor * base)

    def _hedge_scan(self) -> None:
        """One monitor tick over the requests in flight: an attempt
        waiting past its replica's threshold gets one more submission on
        the next-best replica."""
        from dask_ml_tpu_torch.parallel import telemetry

        now = time.perf_counter()
        with self._lock:
            candidates = [freq for freq in self._inflight.values()
                          if not freq.future.done() and freq.hedges < 1
                          and freq.outstanding]
        by_name = {rep.name: rep for rep in self._replicas}
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
                if now - t0 <= thr:
                    continue
                target = self._pick(
                    exclude={n for n, _ in waits} | {rep_name})
                if target is None:
                    break
                remaining = freq.remaining()
                if remaining is not None and remaining <= 0.0:
                    break
                ht0 = time.perf_counter()
                try:
                    rfut = target.loop.submit(
                        freq.model, freq.X, method=freq.method,
                        priority=freq.priority, deadline=remaining)
                except Exception:  # noqa: BLE001 — the target refused; a
                    break  # later scan may try again
                freq.hedges += 1
                with self._lock:
                    freq.attempts += 1
                    freq.outstanding[target.name] = ht0
                    self.n_hedged += 1
                if telemetry.enabled():
                    telemetry.metrics().counter(
                        "serving.hedged", replica=target.name).inc()
                rfut.add_done_callback(
                    lambda f, freq=freq, rep=target, t0=ht0:
                    self._on_done(freq, rep, t0, True, f))
                break

    # -- health monitoring -------------------------------------------------

    def _monitor_loop(self) -> None:
        from dask_ml_tpu_torch.config import config_context

        ctx = (config_context(telemetry=True) if self._telemetry_inherit
               else contextlib.nullcontext())
        interval = self.heartbeat_interval_s
        with ctx:
            while not self._monitor_stop.wait(interval):
                if self._drain is not None and self._drain.requested:
                    with self._lock:
                        self._closing = True
                if self.hedge and not self._closing:
                    try:
                        self._hedge_scan()
                    except Exception:  # noqa: BLE001 — the monitor survives
                        logging.getLogger(__name__).exception(
                            "fleet %r: hedge scan failed (continuing)",
                            self.name)
                for rep in self._replicas:
                    loop = rep.loop
                    if rep.dead:
                        # a false death (a long batch stalled the beat)
                        # heals once the beat returns; a crashed or
                        # stopped loop stays dead
                        if loop.alive() and loop.heartbeat_age() \
                                <= self.heartbeat_timeout_s:
                            rep.dead = False
                            rep.consecutive_failures = 0
                            rep.breaker_open_until = 0.0
                            self._set_replica_up()
                        continue
                    if not loop.alive():
                        if loop.fatal is not None or loop.stopped:
                            self._declare_dead(rep)
                        continue
                    if loop.heartbeat_age() > self.heartbeat_timeout_s:
                        self._declare_dead(rep)

    def _declare_dead(self, rep: _Replica) -> None:
        """Take the replica out of rotation and replay its requests in
        flight on survivors. A false declaration (a stalled beat, the loop
        alive) is safe: both completions race to the same fleet future
        and the first one wins."""
        from dask_ml_tpu_torch.parallel import telemetry

        if rep.dead:
            return
        rep.dead = True
        self._set_replica_up()
        if self._closing:
            # a fleet-wide drain or stop: replicas stopping cleanly are
            # not deaths (stop() fails what is left)
            return
        with self._lock:
            self.n_replica_deaths += 1
            victims = [freq for freq in self._inflight.values()
                       if freq.replica == rep.name
                       or rep.name in freq.outstanding]
        if telemetry.enabled():
            telemetry.metrics().counter(
                "fleet.replica_deaths", replica=rep.name).inc()
        cause = ServingStopped(
            f"replica {rep.name!r} declared dead "
            f"(heartbeat {rep.loop.heartbeat_age():.2f}s"
            + (f", fatal {rep.loop.fatal!r}" if rep.loop.fatal is not None
               else "") + ")")
        for freq in victims:
            if freq.attempts > self._replay_budget():
                self._terminal(freq, cause, sync=False)
                continue
            with self._lock:
                self.n_reroutes += 1
            if telemetry.enabled():
                telemetry.metrics().counter(
                    "fleet.reroutes", replica=rep.name).inc()
            self._route(freq, sync=False, exclude={rep.name})

    # -- observability -----------------------------------------------------

    def stats(self) -> dict:
        with self._lock:
            counters = {
                "reroutes": self.n_reroutes,
                "spillovers": self.n_spillovers,
                "shed": self.n_shed,
                "swaps": self.n_swaps,
                "replica_deaths": self.n_replica_deaths,
                "hedged": self.n_hedged,
                "hedge_wins": self.n_hedge_wins,
                "inflight": len(self._inflight),
            }
        return {
            "name": self.name,
            "replicas_up": self.replicas_up(),
            "replicas": {rep.name: {
                "device": str(rep.device),
                "alive": rep.loop.alive(),
                "dead": rep.dead,
                "breaker_open": rep.breaker_open(),
                "queue_depth": rep.loop.queue_depth(),
                "latency_ewma_s": round(rep.loop.latency_s(), 6),
                **{k: v for k, v in rep.loop.stats().items()
                   if k in ("submitted", "completed", "errors", "batches",
                            "rows_served", "shed")},
            } for rep in self._replicas},
            **counters,
        }


# ---------------------------------------------------------------------------
# the wire: FleetServer, RetryBudget, FleetClient
# ---------------------------------------------------------------------------
#: errors the wire protocol maps by name so a remote caller can catch the
#: same classes a local one would
_WIRE_ERRORS = {
    "DeadlineExceeded": DeadlineExceeded,
    "ServingQueueFull": ServingQueueFull,
    "ServingStopped": ServingStopped,
    "ServingClosed": ServingClosed,
    "FleetTimeoutError": FleetTimeoutError,
    "PayloadError": framing.PayloadError,
    "ValueError": ValueError,
    "KeyError": KeyError,
}


class _ShmSwitch:
    """Writer-queue marker: every response enqueued after it leaves over
    the negotiated shm ring instead of the TCP frame wire (FIFO order
    guarantees the hello ACK, enqueued just before, went out on TCP)."""

    __slots__ = ("ep",)

    def __init__(self, ep):
        self.ep = ep


#: one byte on the retained TCP socket after every shm ring write: the
#: peer blocks in the kernel (cheap, instant wakeup) instead of polling
#: the ring, and the byte stream doubles as the liveness/EOF channel
_DOORBELL = b"\x01"


class FleetServer:
    """Socket front-end for a :class:`ServingFleet` (or a single
    :class:`ServingLoop`): out-of-process clients submit inference
    requests as frames of the shared codec
    (:data:`~dask_ml_tpu_torch.parallel.framing.WIRE_MAGIC`).

    One frame carries one TYPED request payload
    (:func:`~dask_ml_tpu_torch.parallel.framing.encode_payload`: a JSON
    control envelope — ``op="submit"``, id, model, method, priority,
    deadline — plus the row array as one dtype/shape-tagged buffer);
    responses are frames tagged with the request id and return OUT OF
    ORDER as futures resolve, so one slow request never convoys a
    connection. ``op="ping"`` answers with the serving pid;
    ``op="stats"`` returns the routing-signal snapshot (queue depth,
    latency EWMA, batch count — plus whatever ``extra_stats`` adds; the
    process fleet's replicas report their device, launch counts and
    library builds and loads through it). A request that fails validation
    (or sheds on its deadline) gets an error response naming the
    exception class — that caller only, never a shared batch. A
    payload that fails its typed decode fails ITS frame only (the frame
    boundary was intact); a frame that fails its checksum gets an error
    response and the connection is closed (the stream's byte alignment
    can no longer be trusted).

    Nothing received on this socket is ever deserialized as an object —
    control is JSON under a size cap, buffers are (dtype, shape, bytes)
    against an allowlist — so the surface is safe for untrusted clients
    (the remaining exposure is load, which ``max_payload`` and the
    serving layer's admission control bound).
    """

    def __init__(self, fleet, host: str = "127.0.0.1", port: int = 0, *,
                 max_payload: int = 256 * 1024 * 1024,
                 extra_stats=None, shm: bool = True):
        # the CRC-32C engine is built and loaded here, not at the first
        # request: a failure surfaces at start, and no library load lands
        # inside a serving window
        framing.crc32c_engine()
        self.fleet = fleet
        self.max_payload = int(max_payload)
        self._extra_stats = extra_stats
        self.shm = bool(shm)
        self.n_shm_conns = 0
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(64)
        self.address = self._sock.getsockname()
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: list = []
        self.n_requests = 0
        self.n_frame_errors = 0

    def start(self) -> "FleetServer":
        if self._accept_thread is not None:
            return self
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="fleet-server-accept",
            daemon=True)
        self._accept_thread.start()
        return self

    def __enter__(self) -> "FleetServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        for conn in list(self._conns):
            try:
                conn.close()
            except OSError:
                pass

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # listener closed
            self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="fleet-server-conn", daemon=True).start()

    #: response-queue depth per connection; a client that stops READING
    #: while responses pile up is broken — the connection is closed
    #: rather than buffering unboundedly
    MAX_PENDING_RESPONSES = 1024

    def _send(self, conn, out_q, control: dict, arrays=(),
              release=None) -> None:
        """Enqueue one response for the connection's writer thread. The
        write itself happens OFF the caller's thread: responses are
        delivered from future callbacks that run on replica dispatch
        threads, and a blocking ``sendall`` to a stalled client there
        would freeze the replica's dispatch loop (and read as a death to
        the health monitor). ``release`` (the shm record hold of the
        request this response answers) runs after the response bytes
        left — the response may alias the request's in-ring buffers, so
        the record cannot be recycled a moment earlier."""
        import queue as queue_mod

        try:
            out_q.put_nowait((control, tuple(arrays), release))
        except queue_mod.Full:
            if release is not None:
                release()
            try:
                conn.close()  # reader+writer unwind on the closed socket
            except OSError:
                pass

    def _write_loop(self, conn, out_q) -> None:
        from dask_ml_tpu_torch.parallel import telemetry

        shm_ep = None
        while True:
            msg = out_q.get()
            if msg is None:
                return
            if msg.__class__ is _ShmSwitch:
                # everything enqueued after this marker leaves over the
                # negotiated shm ring; the hello ACK sits BEFORE it in
                # this FIFO, so the client reads the ACK on TCP and only
                # then arms its ring reader
                shm_ep = msg.ep
                continue
            control, arrays, release = msg
            try:
                try:
                    if shm_ep is not None:
                        shm_ep.send(control, arrays,
                                    timeout=self.SEND_TIMEOUT_S)
                        conn.sendall(_DOORBELL)
                    else:
                        # encode ONCE and write from the retained
                        # buffers: a single digest pass over the parts,
                        # no payload concatenation copy per response
                        n = framing.write_frame_parts(
                            conn,
                            framing.encode_payload_parts(control, arrays),
                            magic=framing.WIRE_MAGIC,
                            checksum=framing.WIRE_CHECKSUM)
                        if telemetry.enabled():
                            telemetry.metrics().counter(
                                "wire.bytes", transport="tcp").inc(n)
                except framing.PayloadError as e:
                    # an un-encodable RESPONSE (e.g. a host-fallback
                    # model returning string labels — a dtype the typed
                    # wire refuses) fails ITS caller with an error
                    # frame; the writer must survive, or every later
                    # response on this connection silently wedges
                    err = {"id": control.get("id"), "ok": False,
                           "error": "PayloadError",
                           "message": f"response not wire-encodable: "
                                      f"{str(e)[:512]}"}
                    if shm_ep is not None:
                        shm_ep.send(err, timeout=self.SEND_TIMEOUT_S)
                        conn.sendall(_DOORBELL)
                    else:
                        framing.write_frame(
                            conn, framing.encode_payload(err),
                            magic=framing.WIRE_MAGIC,
                            checksum=framing.WIRE_CHECKSUM)
            except OSError:
                return  # peer went away; nothing to deliver to
            finally:
                if release is not None:
                    release()

    #: writer-side bound on one shm ring send — a client that stopped
    #: draining its response ring for this long is treated as gone
    SEND_TIMEOUT_S = 30.0

    def _serve_conn(self, conn) -> None:
        import queue as queue_mod

        out_q: "queue_mod.Queue" = queue_mod.Queue(
            maxsize=self.MAX_PENDING_RESPONSES)
        state: dict = {"shm": None}
        writer = threading.Thread(target=self._write_loop,
                                  args=(conn, out_q),
                                  name="fleet-server-writer", daemon=True)
        writer.start()
        try:
            while not self._stop.is_set():
                ep = state["shm"]
                if ep is not None:
                    if not self._serve_shm_step(conn, out_q, ep):
                        return
                    continue
                try:
                    payload = framing.read_frame(
                        conn, magic=framing.WIRE_MAGIC,
                        max_payload=self.max_payload,
                        checksum=framing.WIRE_CHECKSUM)
                except framing.FrameError as e:
                    # a torn/corrupt frame fails ITS caller and ends the
                    # stream: byte alignment is gone, so nothing later on
                    # this connection can be attributed safely
                    self.n_frame_errors += 1
                    self._send(conn, out_q, {
                        "id": None, "ok": False,
                        "error": type(e).__name__, "message": str(e)})
                    return
                except OSError:
                    return  # reset by the peer, or closed by stop()
                if payload is None:
                    return  # clean EOF
                self._handle(conn, out_q, payload, state)
        finally:
            # let queued responses flush, then stop the writer; closing
            # the socket afterwards unblocks a writer stalled mid-send
            try:
                out_q.put_nowait(None)
            except queue_mod.Full:
                pass
            writer.join(5.0)
            ep = state.get("shm")
            if ep is not None:
                ep.close()
            try:
                conn.close()
            except OSError:
                pass
            if conn in self._conns:
                self._conns.remove(conn)

    def _serve_shm_step(self, conn, out_q, ep) -> bool:
        """One step of a negotiated shm connection: drain the request
        ring, then BLOCK on the TCP socket for the client's doorbell
        byte — a kernel wakeup instead of a poll loop, so an idle (or
        GIL-contended) link costs nothing. Every ring record is paired
        with one doorbell byte sent after its READY publish, so a
        drain-to-empty after every wakeup can never strand a record;
        stale coalesced bytes just buy a benign extra drain pass. False
        ends the connection. A ``kill -9``'d client surfaces here
        exactly the way it does on the framed wire: as EOF/reset on the
        socket."""
        import select

        try:
            rec = ep.recv(timeout=0.0)
        except framing.PayloadError as e:
            # typed decode failed but the record frame was intact: fails
            # its request only (record already released), the ring and
            # the connection survive — same contract as the TCP wire
            self._send(conn, out_q, {
                "id": None, "ok": False,
                "error": type(e).__name__, "message": str(e)})
            return True
        except (framing.FrameError, ConnectionError) as e:
            self.n_frame_errors += 1
            self._send(conn, out_q, {
                "id": None, "ok": False,
                "error": type(e).__name__, "message": str(e)})
            return False
        if rec is None:
            try:
                ready, _, _ = select.select([conn], [], [], 0.25)
                if not ready:
                    return True  # idle: loop to re-check server stop
                b = conn.recv(4096)
                if b == b"":
                    return False  # client closed cleanly
            except (OSError, ValueError):
                return False  # reset/abort/closed-fd: client died
            return True
        msg, arrays, token = rec

        def release(t=token):
            ep.release(t)

        self._handle_msg(conn, out_q, msg, arrays, release)
        return True

    def _handle_hello(self, conn, out_q, msg: dict, state: dict) -> None:
        """``op="shm_hello"``: the client created a shared-memory
        segment and asks this server to attach. Attach can only succeed
        when both ends share a kernel — that IS the same-machine test —
        so any failure just answers ``shm: false`` and the connection
        stays on the framed TCP wire, byte-identical semantics."""
        rid = msg.get("id") if isinstance(msg.get("id"), str) else None
        if not self.shm or state.get("shm") is not None:
            self._send(conn, out_q, {
                "id": rid, "ok": True, "shm": False,
                "reason": ("shm disabled on this server" if not self.shm
                           else "shm already negotiated")})
            return
        try:
            from dask_ml_tpu_torch.parallel import shm as shm_lib

            ep = shm_lib.ShmServer(
                str(msg.get("segment")),
                ring_bytes=msg.get("ring_bytes"),
                checksum=msg.get("checksum"))
        except Exception as e:  # noqa: BLE001 — any attach/validate
            # failure means "this link stays on TCP", never an error
            self._send(conn, out_q, {
                "id": rid, "ok": True, "shm": False,
                "reason": f"{type(e).__name__}: {str(e)[:256]}"})
            return
        import queue as queue_mod

        self._send(conn, out_q, {"id": rid, "ok": True, "shm": True})
        try:
            out_q.put_nowait(_ShmSwitch(ep))
        except queue_mod.Full:
            ep.close()
            try:
                conn.close()
            except OSError:
                pass
            return
        state["shm"] = ep
        self.n_shm_conns += 1

    def _stats_snapshot(self) -> dict:
        """The routing-signal summary ``op="stats"`` answers with —
        loop-side queue depth + latency EWMA (the same surfaces the
        in-process router balances on) plus the serving pid, so a
        process-fleet router can label its telemetry per replica
        process."""
        target = self.fleet
        out = {"pid": os.getpid(), "n_requests": self.n_requests}
        qd = getattr(target, "queue_depth", None)
        if callable(qd):
            out["queue_depth"] = int(qd())
        lat = getattr(target, "latency_s", None)
        if callable(lat):
            out["latency_ewma_s"] = float(lat())
        out["batches"] = int(getattr(target, "n_batches", 0))
        if self._extra_stats is not None:
            out.update(self._extra_stats())
        return out

    def _handle(self, conn, out_q, payload, state=None) -> None:
        """One framed TCP request: typed decode, then either the
        shm negotiation op or the shared dispatch."""
        try:
            msg, arrays = framing.decode_payload(payload)
        except Exception as e:  # noqa: BLE001 — per-frame error delivery
            self._send(conn, out_q, {
                "id": None, "ok": False,
                "error": type(e).__name__, "message": str(e)})
            return
        if msg.get("op") == "shm_hello" and state is not None:
            self._handle_hello(conn, out_q, msg, state)
            return
        self._handle_msg(conn, out_q, msg, arrays, None)

    def _handle_msg(self, conn, out_q, msg: dict, arrays,
                    release) -> None:
        """Dispatch one decoded request, transport-agnostic. ``release``
        (shm only) is handed to exactly one ``_send`` — the writer runs
        it after the response leaves, which is when the request's
        in-ring buffers (possibly aliased by the response) are last
        read."""
        rid = None
        try:
            op = msg.get("op")
            rid = msg.get("id")
            if rid is not None and not isinstance(rid, str):
                raise framing.PayloadError(
                    f"request id must be a string, got "
                    f"{type(rid).__name__}")
            if op == "ping":
                self._send(conn, out_q, {"id": rid, "ok": True,
                                         "pong": True,
                                         "pid": os.getpid()},
                           release=release)
                return
            if op == "stats":
                self._send(conn, out_q, {"id": rid, "ok": True,
                                         "stats": self._stats_snapshot()},
                           release=release)
                return
            if op != "submit":
                raise ValueError(f"unknown wire op {op!r}")
            if len(arrays) != 1:
                raise framing.PayloadError(
                    f"submit expects exactly one array buffer, got "
                    f"{len(arrays)}")
            X = arrays[0]
            deadline = msg.get("deadline")
            if deadline is not None and not isinstance(
                    deadline, (int, float)):
                raise framing.PayloadError(
                    "deadline must be a number or null")
            self.n_requests += 1
            kwargs = {}
            if rid is not None and isinstance(self.fleet, ServingFleet):
                kwargs["request_id"] = rid  # client retry = same request
            fut = self.fleet.submit(
                str(msg.get("model")), X,
                method=str(msg.get("method", "predict")),
                priority=int(msg.get("priority", 0)),
                deadline=deadline, **kwargs)
        except Exception as e:  # noqa: BLE001 — per-frame error delivery
            self._send(conn, out_q, {
                "id": rid, "ok": False,
                "error": type(e).__name__, "message": str(e)},
                release=release)
            return

        def deliver(f, rid=rid):
            try:
                out = f.result()
            except Exception as e:  # noqa: BLE001
                self._send(conn, out_q, {
                    "id": rid, "ok": False,
                    "error": type(e).__name__, "message": str(e)},
                    release=release)
            else:
                self._send(conn, out_q, {"id": rid, "ok": True},
                           arrays=(np.asarray(out),), release=release)

        fut.add_done_callback(deliver)


class RetryBudget:
    """Client-side load-aware retry budget: a token bucket that couples
    the RIGHT to retry to observed success. Every success deposits
    ``ratio`` tokens (capped at ``cap``); every retry spends one whole
    token. Healthy service → budget stays full and transient blips
    retry freely; degraded service → successes dry up, the bucket
    drains, and retries STOP instead of multiplying the load that is
    causing the failures (the retry-storm amplification a fixed
    retry count cannot prevent). Share one instance across the clients
    of a service so the bound is per-service, not per-caller."""

    def __init__(self, ratio: float = 0.1, *, initial: float = 10.0,
                 cap: float = 100.0):
        if float(ratio) < 0.0:
            raise ValueError("ratio must be >= 0")
        self.ratio = float(ratio)
        self.cap = float(cap)
        self._lock = threading.Lock()
        self._tokens = min(float(initial), self.cap)
        self.n_spent = 0
        self.n_denied = 0

    def tokens(self) -> float:
        with self._lock:
            return self._tokens

    def on_success(self) -> None:
        with self._lock:
            self._tokens = min(self._tokens + self.ratio, self.cap)

    def try_spend(self) -> bool:
        """Claim one retry token; False (and counted) when the budget
        is exhausted — the caller must surface the original failure."""
        with self._lock:
            if self._tokens >= 1.0:
                self._tokens -= 1.0
                self.n_spent += 1
                return True
            self.n_denied += 1
            return False


class FleetClient:
    """Out-of-process client of a :class:`FleetServer`: frames typed
    requests over one socket, demultiplexes out-of-order responses by id
    on a reader thread. ``submit`` returns a Future; ``call`` blocks.
    Error responses re-raise as the same exception classes a local
    caller would see (:data:`_WIRE_ERRORS`; anything unmapped surfaces
    as ``RuntimeError`` naming the remote class).

    Retries: ``call`` re-attempts :class:`FleetTimeoutError` /
    :class:`ServingStopped` failures up to ``retries`` times, but only
    while the :class:`RetryBudget` has tokens — retries are earned by
    successes (deposit ``ratio``) and spent one token each, so a
    degraded server sees the retry load FALL with its success rate
    instead of multiplying (mirrored as ``fleet.retries`` and
    ``fleet.retry_budget_exhausted`` at the increment sites).

    Deadlines: ``request_timeout`` (and the per-call ``timeout=`` on
    ``submit``) arms a reaper that fails the future with the typed
    :class:`FleetTimeoutError` when no response arrived in time — a
    wedged or silently-dead server can never block a caller forever
    (``ping`` has the same contract). Timeouts mirror to the
    ``fleet.timeouts`` counter at the increment site.

    Reconnect: when the server closed the previous connection CLEANLY
    between frames (EOF, not an error), the next ``submit``/``ping``
    transparently reconnects once. In-flight requests of the closed
    connection were already failed with ``ServingStopped`` — reconnect
    never resurrects them; a torn connection (reset, frame corruption)
    stays down so the failure is visible.
    """

    def __init__(self, address, *, timeout: Optional[float] = None,
                 request_timeout: Optional[float] = None,
                 send_timeout: Optional[float] = 30.0,
                 retries: int = 0,
                 retry_budget: Optional[RetryBudget] = None,
                 shm: bool = True,
                 shm_ring_bytes: Optional[int] = None):
        framing.crc32c_engine()  # built and loaded now, or raise
        self.address = (address[0], int(address[1]))
        self._connect_timeout = timeout
        self.request_timeout = request_timeout
        self.send_timeout = send_timeout
        self.retries = int(retries)
        self._shm_enabled = bool(shm)
        self._shm_ring_bytes = shm_ring_bytes
        self._shm = None  # negotiated ShmClient endpoint, else None
        # (rid, endpoint) of an in-flight shm offer: the READ LOOP arms
        # the ring when the matching ACK arrives, so no framed read can
        # race the server's first doorbell byte
        self._shm_pending = None
        self.n_shm_connects = 0
        # retries without a budget would be exactly the retry-storm
        # amplifier the budget exists to prevent: default one in
        self.retry_budget = (retry_budget if retry_budget is not None
                             else (RetryBudget() if self.retries > 0
                                   else None))
        self._wlock = threading.Lock()
        self._lock = threading.Lock()
        self._pending: dict = {}  # id -> Future
        self._deadlines: dict = {}  # id -> absolute monotonic instant
        # globally-unique id prefix: rids reach the FLEET's dedup table,
        # where two clients colliding (id() reuse across processes or
        # after GC) would silently hand one client the other's result
        self._rid_prefix = uuid.uuid4().hex[:16]
        self._seq = 0
        self._closed = False
        self._clean_eof = False
        self._reconnected = False
        self._reaper: Optional[threading.Thread] = None
        self.n_timeouts = 0
        self.n_reconnects = 0
        self.n_retries = 0
        self.n_budget_exhausted = 0
        from dask_ml_tpu_torch.parallel import telemetry

        self._telemetry_inherit = telemetry.enabled()
        self._sock = self._connect()
        self._negotiate_shm()

    def _connect(self):
        import struct as struct_mod

        sock = socket.create_connection(self.address,
                                        timeout=self._connect_timeout)
        # the connect timeout must not leak into the reader's blocking
        # recv (an idle connection would look like a dead one)
        sock.settimeout(None)
        if self.send_timeout is not None:
            # kernel-level SEND timeout only (SO_SNDTIMEO): a wedged
            # server whose recv buffer filled must fail the sender's
            # sendall instead of blocking it forever under the write
            # lock — socket.settimeout would also arm recv and kill the
            # reader on every idle connection
            try:
                t = float(self.send_timeout)
                sock.setsockopt(
                    socket.SOL_SOCKET, socket.SO_SNDTIMEO,
                    struct_mod.pack("ll", int(t),
                                    int((t - int(t)) * 1e6)))
            except (OSError, AttributeError):
                pass  # platform without SO_SNDTIMEO: keep blocking sends
        threading.Thread(target=self._read_loop, args=(sock,),
                         name="fleet-client-reader", daemon=True).start()
        return sock

    @property
    def shm_segment(self) -> Optional[str]:
        """The shared-memory segment this client's requests ride (its
        name without the leading ``/``), or ``None`` on the TCP wire."""
        ep = self._shm
        return None if ep is None else ep.segment.lstrip("/")

    def close(self) -> None:
        self._closed = True
        ep, self._shm = self._shm, None
        if ep is not None:
            ep.close()
        try:
            self._sock.close()
        except OSError:
            pass

    def __enter__(self) -> "FleetClient":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def _negotiate_shm(self) -> None:
        """Offer the server a shared-memory ring for this connection
        (``op="shm_hello"`` over the just-established TCP wire). Create
        the segment, name it, wait for the attach verdict: yes → both
        directions move to the ring and the socket stays open as the
        doorbell + liveness/EOF channel; no (cross-machine, disabled,
        old server) → unlink the segment and keep the framed wire.
        Never raises — TCP is always the safe landing."""
        if not self._shm_enabled or self._closed:
            return
        try:
            from dask_ml_tpu_torch.parallel import shm as shm_lib

            kwargs = ({} if self._shm_ring_bytes is None
                      else {"ring_bytes": int(self._shm_ring_bytes)})
            ep = shm_lib.ShmClient(**kwargs)
        except Exception:  # noqa: BLE001 — no shm on this platform
            return
        with self._lock:
            self._seq += 1
            rid = f"{self._rid_prefix}-{self._seq}"
            fut: Future = Future()
            self._pending[rid] = fut
        ok = False
        try:
            hello = dict(ep.hello())
            hello["id"] = rid
            # the READ LOOP arms the ring the moment it decodes the ACK
            # (before delivering this future): the very next byte the
            # server sends after a yes is a doorbell, not a frame, so
            # the switch cannot be left to this thread — the reader
            # would already be blocked inside read_frame misparsing it
            self._shm_pending = (rid, ep)
            # written directly (the caller already holds _wlock on the
            # reconnect path; _send_msg would deadlock on it)
            framing.write_frame_parts(
                self._sock, framing.encode_payload_parts(hello),
                magic=framing.WIRE_MAGIC,
                checksum=framing.WIRE_CHECKSUM)
            msg = fut.result(10.0)
            ok = isinstance(msg, dict) and msg.get("shm") is True
        except Exception:  # noqa: BLE001 — any failure → TCP fallback
            ok = False
        finally:
            self._shm_pending = None
            with self._lock:
                self._pending.pop(rid, None)
                self._deadlines.pop(rid, None)
        if not ok:
            with self._lock:
                armed = self._shm is ep
                if armed:  # ACK raced the 10s verdict timeout: keep it
                    ok = True
            if not ok:
                ep.close(unlink=True)

    def _drain_shm(self, ep) -> None:
        """Deliver every response currently in the ring. Responses are
        small (one result array): copy out and release the record
        immediately — the hold-until-done discipline matters on the
        server's request side, not here."""
        while True:
            try:
                rec = ep.recv(timeout=0.0)
            except framing.PayloadError:
                continue  # malformed response fails its frame only
            if rec is None:
                return
            msg, arrays, token = rec
            try:
                copies = [np.array(a) for a in arrays]
            finally:
                ep.release(token)
            self._dispatch_msg(msg, copies)

    def _shm_doorbell_loop(self, ep, sock) -> bool:
        """The read loop's shm mode: block on the TCP socket for the
        server's doorbell byte, then drain the response ring. Every ring
        record is paired with one byte sent after its READY publish, so
        drain-to-empty per wakeup never strands a response. Returns True
        on clean server EOF (mirrors ``read_frame`` returning None);
        ring corruption raises FrameError, socket death OSError — both
        unwind through the read loop's one pending-failure path."""
        while not self._closed and not ep.closed:
            self._drain_shm(ep)
            b = sock.recv(4096)
            if b == b"":
                return True
        return False

    def _dispatch_msg(self, msg: dict, arrays) -> None:
        """Demultiplex one response (either transport) to its future."""
        rid = msg.get("id")
        with self._lock:
            fut = self._pending.pop(rid, None)
            self._deadlines.pop(rid, None)
        if fut is None:
            return  # response to a caller that went away
        if msg.get("ok"):
            _set_future(fut, arrays[0] if arrays else msg)
        else:
            cls = _WIRE_ERRORS.get(msg.get("error"), RuntimeError)
            _fail_future(fut, cls(
                f"[remote {msg.get('error')}] {msg.get('message')}"))

    def _read_loop(self, sock) -> None:
        exc: BaseException = ServingStopped("wire connection closed")
        clean = False
        try:
            while True:
                payload = framing.read_frame(
                    sock, magic=framing.WIRE_MAGIC,
                    checksum=framing.WIRE_CHECKSUM)
                if payload is None:
                    clean = True
                    break
                msg, arrays = framing.decode_payload(payload)
                pend = self._shm_pending
                if (pend is not None and msg.get("id") == pend[0]
                        and msg.get("ok") and msg.get("shm") is True):
                    # the server attached: arm the ring BEFORE waking
                    # the negotiator, then leave framed mode for good —
                    # everything after this frame is doorbell bytes
                    with self._lock:
                        self._shm = pend[1]
                    self.n_shm_connects += 1
                    self._dispatch_msg(msg, arrays)
                    clean = self._shm_doorbell_loop(pend[1], sock)
                    break
                self._dispatch_msg(msg, arrays)
        except (OSError, framing.FrameError) as e:
            exc = e
        finally:
            with self._lock:
                if sock is self._sock:
                    # a cleanly-closed connection arms the one-shot
                    # reconnect; a torn one stays down
                    self._clean_eof = clean and not self._closed
                    ep, self._shm = self._shm, None
                else:
                    ep = None
                pending = list(self._pending.values())
                self._pending.clear()
                self._deadlines.clear()
            if ep is not None:
                ep.close()  # unlink: this connection's segment dies here
            cause = (ServingStopped("wire connection closed by server")
                     if clean else ServingStopped(
                         f"wire connection lost: {exc!r}"))
            for fut in pending:
                _fail_future(fut, cause)

    def _ensure_connected(self) -> None:
        """Reconnect ONCE after a clean server-side close (under the
        write lock's caller)."""
        with self._lock:
            if not self._clean_eof or self._closed:
                return
            if self._reconnected:
                raise ServingStopped(
                    "wire connection closed by server (already "
                    "reconnected once)")
            self._clean_eof = False
            self._reconnected = True
            self.n_reconnects += 1
        ep, self._shm = self._shm, None
        if ep is not None:
            ep.close()  # a fresh connection negotiates a fresh segment
        try:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = self._connect()
        except OSError as e:
            raise ServingStopped(f"wire reconnect failed: {e!r}")
        self._negotiate_shm()

    def _count_timeout(self) -> None:
        from dask_ml_tpu_torch.parallel import telemetry

        with self._lock:
            self.n_timeouts += 1
        if telemetry.enabled():
            telemetry.metrics().counter("fleet.timeouts").inc()

    def _reap_loop(self) -> None:
        import contextlib

        from dask_ml_tpu_torch import config as config_lib

        ctx = (config_lib.config_context(telemetry=True)
               if self._telemetry_inherit else contextlib.nullcontext())
        with ctx:
            while not self._closed:
                now = time.monotonic()
                expired = []
                with self._lock:
                    for rid, t in list(self._deadlines.items()):
                        if t <= now:
                            self._deadlines.pop(rid, None)
                            fut = self._pending.pop(rid, None)
                            if fut is not None:
                                expired.append((rid, fut))
                    if not self._deadlines and not expired:
                        # nothing armed: exit instead of idle-polling;
                        # _arm_deadline restarts the thread (same lock)
                        self._reaper = None
                        return
                for rid, fut in expired:
                    if _fail_future(fut, FleetTimeoutError(
                            f"request {rid} got no wire response within "
                            "its deadline")):
                        self._count_timeout()
                time.sleep(0.02)

    def _arm_deadline(self, rid: str, timeout: Optional[float]) -> None:
        if timeout is None:
            return
        with self._lock:
            self._deadlines[rid] = time.monotonic() + float(timeout)
            if self._reaper is None or not self._reaper.is_alive():
                self._reaper = threading.Thread(
                    target=self._reap_loop, name="fleet-client-reaper",
                    daemon=True)
                self._reaper.start()

    def _send_msg(self, control: dict, arrays=()) -> None:
        from dask_ml_tpu_torch.parallel import telemetry

        with self._wlock:
            self._ensure_connected()
            ep = self._shm
            if ep is not None:
                # negotiated ring: one encode pass straight into shared
                # memory (its own wire.bytes{transport="shm"} mirror),
                # then the doorbell byte that wakes the server's
                # kernel-blocked reader
                ep.send(control, arrays, timeout=self.send_timeout)
                self._sock.sendall(_DOORBELL)
                return
            parts = framing.encode_payload_parts(control, arrays)
            try:
                n = framing.write_frame_parts(
                    self._sock, parts, magic=framing.WIRE_MAGIC,
                    checksum=framing.WIRE_CHECKSUM)
            except OSError:
                # the close may have raced the write; one clean-EOF
                # reconnect attempt, then give up loudly
                self._ensure_connected()
                ep = self._shm
                if ep is not None:
                    ep.send(control, arrays, timeout=self.send_timeout)
                    self._sock.sendall(_DOORBELL)
                    return
                n = framing.write_frame_parts(
                    self._sock, parts, magic=framing.WIRE_MAGIC,
                    checksum=framing.WIRE_CHECKSUM)
            if telemetry.enabled():
                telemetry.metrics().counter(
                    "wire.bytes", transport="tcp").inc(n)

    def _new_request(self) -> tuple:
        with self._lock:
            if self._closed:
                raise ServingStopped("client is closed")
            self._seq += 1
            rid = f"{self._rid_prefix}-{self._seq}"
            fut: Future = Future()
            self._pending[rid] = fut
        return rid, fut

    def _send_or_unregister(self, rid: str, fut: Future,
                            control: dict, arrays=()) -> None:
        """``_send_msg`` that never leaks: a failed send pops the
        pending entry and fails the future before re-raising (a polling
        caller — ping() on a downed server — must not grow
        ``_pending`` by one dead future per attempt)."""
        try:
            self._send_msg(control, arrays)
        except BaseException as e:
            with self._lock:
                self._pending.pop(rid, None)
                self._deadlines.pop(rid, None)
            _fail_future(fut, e if isinstance(e, ServingError)
                         else ServingStopped(f"wire send failed: {e!r}"))
            raise

    def submit(self, model: str, X, method: str = "predict", *,
               priority: int = 0,
               deadline: Optional[float] = None,
               timeout: Optional[float] = None) -> Future:
        """Send one request; the Future resolves to the result array,
        a remote error, or — when ``timeout`` (default: the client's
        ``request_timeout``) passes with no response —
        :class:`FleetTimeoutError`."""
        rid, fut = self._new_request()
        self._send_or_unregister(
            rid, fut,
            {"op": "submit", "id": rid, "model": str(model),
             "method": str(method), "priority": int(priority),
             "deadline": deadline}, arrays=(np.asarray(X),))
        self._arm_deadline(
            rid, timeout if timeout is not None else self.request_timeout)
        return fut

    def _call_once(self, model: str, X, method: str = "predict", *,
                   priority: int = 0, deadline: Optional[float] = None,
                   timeout: Optional[float] = None) -> np.ndarray:
        fut = self.submit(model, X, method=method, priority=priority,
                          deadline=deadline, timeout=timeout)
        try:
            return fut.result(timeout if timeout is not None
                              else self.request_timeout)
        except _FutureTimeout:
            # the reaper holds the same deadline and is the ONE counting
            # site (it fails the still-pending future moments after this
            # raise) — counting here too would double fleet.timeouts
            raise FleetTimeoutError(
                f"no wire response for {model!r}.{method} within "
                f"{timeout if timeout is not None else self.request_timeout}"
                "s")

    def call(self, model: str, X, method: str = "predict", *,
             priority: int = 0, deadline: Optional[float] = None,
             timeout: Optional[float] = None) -> np.ndarray:
        """One blocking request, retried (transient failures only: wire
        timeout, server gone) up to ``retries`` times UNDER the retry
        budget — when the budget is dry, the original failure surfaces
        immediately (class docstring has the policy)."""
        from dask_ml_tpu_torch.parallel import telemetry

        attempts = 0
        while True:
            try:
                out = self._call_once(
                    model, X, method=method, priority=priority,
                    deadline=deadline, timeout=timeout)
            except (FleetTimeoutError, ServingStopped):
                if attempts >= self.retries or self._closed:
                    raise
                if self.retry_budget is not None \
                        and not self.retry_budget.try_spend():
                    with self._lock:
                        self.n_budget_exhausted += 1
                    if telemetry.enabled():
                        telemetry.metrics().counter(
                            "fleet.retry_budget_exhausted").inc()
                    raise
                attempts += 1
                with self._lock:
                    self.n_retries += 1
                if telemetry.enabled():
                    telemetry.metrics().counter("fleet.retries").inc()
                continue
            if self.retry_budget is not None:
                self.retry_budget.on_success()
            return out

    def stats(self, timeout: float = 10.0) -> dict:
        """The server's ``op="stats"`` snapshot (queue depth, latency
        EWMA, pid, …) — :class:`FleetTimeoutError` past ``timeout``."""
        rid, fut = self._new_request()
        self._send_or_unregister(rid, fut, {"op": "stats", "id": rid})
        self._arm_deadline(rid, timeout)
        try:
            return dict(fut.result(timeout).get("stats") or {})
        except _FutureTimeout:
            raise FleetTimeoutError(  # the reaper counts (see call())
                f"no stats response within {timeout}s")

    def ping(self, timeout: float = 10.0) -> bool:
        """Round-trip liveness probe with a hard deadline: True on pong,
        :class:`FleetTimeoutError` when the server never answers —
        never an eternal block on a wedged socket."""
        rid, fut = self._new_request()
        self._send_or_unregister(rid, fut, {"op": "ping", "id": rid})
        self._arm_deadline(rid, timeout)
        try:
            return bool(fut.result(timeout).get("pong"))
        except _FutureTimeout:
            raise FleetTimeoutError(  # the reaper counts (see call())
                f"no pong within {timeout}s")

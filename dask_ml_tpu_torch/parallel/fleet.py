"""A fault-tolerant fleet of serving loops in one process (the in-process
part of ``dask_ml_tpu/parallel/fleet.py``).

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

The wire tier above this (``FleetServer``, ``FleetClient``,
``RetryBudget``, the process fleet) is ROADMAP Queue A item 11b.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
import uuid
from collections import deque
from concurrent.futures import Future
from typing import Optional

import numpy as np
import torch

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

__all__ = ["ServingFleet", "FleetTimeoutError"]


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
        from dask_ml_tpu_torch.parallel import telemetry

        if self._started:
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
        return self

    def __enter__(self) -> "ServingFleet":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self, drain: bool = True,
             timeout: Optional[float] = 30.0) -> None:
        """Stop admitting, stop every replica (``drain=True`` flushes their
        queues and resolves their futures), then fail whatever replay
        bookkeeping remains, so nothing is left pending."""
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

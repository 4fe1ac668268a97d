"""Fault tolerance for the host-driven streamed loops of the PyTorch port
(the streaming half of ``dask_ml_tpu/parallel/faults.py``).

- :class:`RetryPolicy` — classifies transient host-I/O and transfer
  failures, backs off exponentially with seeded jitter, within a per
  operation retry budget and a total backoff deadline, and counts what it
  did. :class:`~dask_ml_tpu_torch.parallel.stream.HostBlockSource` runs
  its block reads and host→device copies under one.
- :class:`GracefulDrain` — a SIGTERM/SIGINT trap: the in-flight block
  finishes, the scan state is saved, and :class:`Preempted` is raised.
- :class:`ScanCheckpoint` — the ``(carry, outs, next_block, epoch)``
  snapshot that ``prefetched_scan`` saves and loads, bound to its problem
  by a ``bind`` dict, so a snapshot of another problem is an error.
- :class:`FaultInjector` — deterministic, planned faults for the streamed
  pipeline (fail a block's read or its copy, delay a read, preempt after a
  block) and for the in-process serving tier (delay a dispatch, a
  synthetic or a real straggler replica, kill a replica's dispatch
  thread), which drive the same hooks as real failures. The process
  fleet's plans (``kill_process``, ``kill_machine``, ``slow_link``) belong
  to the wire and process tier, which the port does not have yet; they
  raise.

What may be retried on the card: ``torch.cuda.OutOfMemoryError`` only. A
``RuntimeError`` that reports a CUDA error (an illegal address, a failed
launch) leaves the context broken; retrying it would hide a kernel fault,
so it propagates at once.

The snapshot format is the JAX package's, so a ``ScanCheckpoint`` snapshot
written by either package loads in the other (their bind dicts match).
"""

from __future__ import annotations

import logging
import os
import random
import signal
import threading
import time
from contextlib import contextmanager
from typing import Callable, Optional

logger = logging.getLogger(__name__)

__all__ = [
    "RetryPolicy", "FaultInjector", "GracefulDrain", "ScanCheckpoint",
    "Preempted", "BlockFetchError", "InjectedFault", "InjectedLoaderError",
    "InjectedTransferError", "SimulatedReplicaDeath",
    "scan_checkpoint_scope",
]


# ---------------------------------------------------------------------------
# exceptions
# ---------------------------------------------------------------------------


class Preempted(RuntimeError):
    """A graceful drain completed: the in-flight block finished, the scan
    state was saved (to ``path``, when a checkpoint was configured) and the
    run stopped. The same call with the same checkpoint path resumes from
    the snapshot on a bit-identical trajectory."""

    def __init__(self, message: str, path: Optional[str] = None):
        super().__init__(message)
        self.path = path


class BlockFetchError(RuntimeError):
    """Terminal (after retries) failure to fetch one block, naming it."""


class InjectedFault:
    """Marker mixin of injected exceptions (always transient, so drills
    run the retry machinery end to end)."""


class InjectedLoaderError(InjectedFault, OSError):
    """Simulated host-I/O failure reading a block."""


class InjectedTransferError(InjectedFault, RuntimeError):
    """Simulated failure of a block's host→device copy."""


class SimulatedReplicaDeath(RuntimeError):
    """A :meth:`FaultInjector.kill_replica` plan fired: the serving
    replica's dispatch thread dies at once, with no drain and no flush —
    the in-process stand-in for killing a replica. Not an
    :class:`InjectedFault`: a dead replica is terminal for that replica,
    never something its own retry policy should hide; the fleet survives
    it by re-routing and replaying (``parallel/fleet.py``)."""


_WIRE_TIER = ("{} belongs to the wire and process fleet, ROADMAP Queue A "
              "item 11b, which the port does not have yet")


# ---------------------------------------------------------------------------
# retry policy
# ---------------------------------------------------------------------------

#: exception types retried by default: host I/O (OSError covers IOError,
#: ConnectionError and friends) and timeouts
_DEFAULT_TRANSIENT = (OSError, TimeoutError, InjectedFault)


def _is_device_runtime_error(exc: BaseException) -> bool:
    """True for the one device error worth a retry: the caching
    allocator's out-of-memory, which a later attempt may get past once
    other work frees memory. A ``RuntimeError`` naming a CUDA error is not
    one of them: the context is broken and the error must surface."""
    import torch

    return isinstance(exc, torch.cuda.OutOfMemoryError)


class RetryPolicy:
    """Retry transient failures with exponential backoff and seeded jitter.

    ``max_retries`` is the per-operation budget; ``deadline`` caps the
    total seconds the policy may spend in backoff over its life (a streamed
    fit shares one policy, so a loader that stays down exhausts the
    deadline instead of multiplying per-block budgets). Attempt ``a``
    waits ``min(base_delay·multiplier^a, max_delay)`` plus uniform jitter
    in ``[0, jitter·delay]`` from a seeded RNG: the same waits for the same
    seed and call order.

    An exception is transient when ``classify`` (if given) says so, when
    it is an instance of ``transient_types`` (default: ``OSError``,
    ``TimeoutError`` and injected faults), or when it is
    ``torch.cuda.OutOfMemoryError`` and ``retry_device_errors`` is True.
    Everything else propagates at once.

    Counters (``retries``, ``giveups``, ``by_kind``, ``delay_spent``) are
    thread-safe and read through :meth:`stats`."""

    def __init__(self, max_retries: int = 3, *, base_delay: float = 0.05,
                 max_delay: float = 2.0, multiplier: float = 2.0,
                 jitter: float = 0.5, deadline: Optional[float] = None,
                 seed: int = 0, transient_types: Optional[tuple] = None,
                 classify: Optional[Callable[[BaseException], bool]] = None,
                 retry_device_errors: bool = True,
                 sleep: Callable[[float], None] = time.sleep):
        self.max_retries = int(max_retries)
        self.base_delay = float(base_delay)
        self.max_delay = float(max_delay)
        self.multiplier = float(multiplier)
        self.jitter = float(jitter)
        self.deadline = deadline
        self.transient_types = (_DEFAULT_TRANSIENT if transient_types is None
                                else tuple(transient_types))
        self.classify = classify
        self.retry_device_errors = bool(retry_device_errors)
        self._sleep = sleep
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self.retries = 0
        self.giveups = 0
        self.delay_spent = 0.0
        self.by_kind: dict = {}

    def is_transient(self, exc: BaseException) -> bool:
        if self.classify is not None and self.classify(exc):
            return True
        if isinstance(exc, self.transient_types):
            return True
        return self.retry_device_errors and _is_device_runtime_error(exc)

    def backoff_delay(self, attempt: int) -> float:
        d = min(self.base_delay * self.multiplier ** attempt, self.max_delay)
        with self._lock:
            j = self._rng.uniform(0.0, self.jitter * d)
        return d + j

    def run(self, fn: Callable, *, kind: str = "op", detail: str = ""):
        """Call ``fn()``; on a transient failure back off and retry, up to
        ``max_retries`` times and within the deadline. The last attempt's
        error propagates (the caller adds context, such as the block)."""
        attempt = 0
        while True:
            try:
                return fn()
            except Exception as e:
                if not self.is_transient(e):
                    raise
                with self._lock:
                    exhausted = (
                        attempt >= self.max_retries
                        or (self.deadline is not None
                            and self.delay_spent >= self.deadline))
                    if exhausted:
                        self.giveups += 1
                if exhausted:
                    raise
                d = self.backoff_delay(attempt)
                with self._lock:
                    self.retries += 1
                    self.by_kind[kind] = self.by_kind.get(kind, 0) + 1
                    self.delay_spent += d
                logger.warning(
                    "transient %s failure%s — retry %d/%d in %.3fs: %r",
                    kind, f" ({detail})" if detail else "", attempt + 1,
                    self.max_retries, d, e)
                self._sleep(d)
                attempt += 1

    def stats(self) -> dict:
        with self._lock:
            return {"retries": self.retries, "giveups": self.giveups,
                    "delay_spent_seconds": round(self.delay_spent, 4),
                    "by_kind": dict(self.by_kind)}

    def reset_stats(self) -> None:
        with self._lock:
            self.retries = 0
            self.giveups = 0
            self.delay_spent = 0.0
            self.by_kind = {}


# ---------------------------------------------------------------------------
# graceful drain (preemption signals)
# ---------------------------------------------------------------------------


class GracefulDrain:
    """SIGTERM/SIGINT → "finish the in-flight block, save, stop".

    A context manager around a checkpointed streamed fit: on entry it
    installs handlers that set a flag (the previous handlers come back on
    exit); ``prefetched_scan`` polls the flag after every block and, when
    set, saves and raises :class:`Preempted`. :meth:`request` sets the
    flag from code, which the scan cannot tell from a signal.

    Entering the same drain again only counts depth: handlers install once
    and are restored when the outermost scope exits. Entering a distinct
    drain while another is installed chains: the inner handler sets its
    own flag and forwards the signal to the outer drain's handler, so
    every active scope sees one SIGTERM. Handlers install only on the main
    thread (``signal.signal`` works only there); elsewhere the drain works
    through :meth:`request`."""

    def __init__(self, signals=(signal.SIGTERM, signal.SIGINT)):
        self._signals = tuple(signals)
        self._event = threading.Event()
        self._prev: dict = {}
        self._depth = 0
        self.installed = False

    def request(self, *_args) -> None:
        self._event.set()

    def _on_signal(self, signum, frame) -> None:
        """Set this drain's flag, then forward to the previous handler if
        it belongs to another drain. Foreign handlers (the default
        KeyboardInterrupt one, an application's trap) are not called: the
        signal means "finish the block and save", not "raise mid-solve"."""
        self._event.set()
        prev = self._prev.get(signum)
        if isinstance(getattr(prev, "__self__", None), GracefulDrain):
            prev(signum, frame)

    @property
    def requested(self) -> bool:
        return self._event.is_set()

    def clear(self) -> None:
        self._event.clear()

    def __enter__(self) -> "GracefulDrain":
        self._depth += 1
        if self._depth > 1:
            # re-entered: saving the current handler again would record
            # this drain as "previous" and leak the trap on exit
            return self
        try:
            for s in self._signals:
                self._prev[s] = signal.signal(s, self._on_signal)
            self.installed = True
        except ValueError:  # not the main thread: request()-only mode
            for s, prev in self._prev.items():
                signal.signal(s, prev)
            self._prev.clear()
            self.installed = False
        return self

    def __exit__(self, *exc) -> None:
        self._depth = max(self._depth - 1, 0)
        if self._depth > 0:
            return None
        for s, prev in self._prev.items():
            signal.signal(s, prev)
        self._prev.clear()
        self.installed = False
        return None


# ---------------------------------------------------------------------------
# scan checkpoint
# ---------------------------------------------------------------------------


class ScanCheckpoint:
    """Snapshot and restore of ``prefetched_scan``.

    A snapshot is ``(carry, outs so far)`` with ``(next_block, epoch)`` in
    its metadata: all a scan needs to replay from the first incomplete
    block. The per-block work is deterministic, so the resumed trajectory
    is bit-identical to an uninterrupted run.

    ``every`` is the interval in completed blocks (each save reads the
    carry to the host); ``bind`` holds the problem's identity, and a
    snapshot whose binding differs is an error; ``drain`` is the
    :class:`GracefulDrain` the scan polls. Saves are atomic
    (:func:`dask_ml_tpu_torch.checkpoint.save_pytree`): a kill mid-save
    leaves the previous snapshot intact."""

    KIND = "prefetched_scan"

    def __init__(self, path: str, *, every: int = 1,
                 drain: Optional[GracefulDrain] = None,
                 bind: Optional[dict] = None):
        self.path = path
        self.every = max(int(every), 1)
        self.drain = drain
        self.bind = dict(bind or {})
        self._since = 0
        self.saves = 0

    def load(self):
        """``(carry, outs, next_block, epoch)`` with numpy leaves, or
        ``None`` when there is no snapshot. Raises on a snapshot of
        another kind or problem."""
        from dask_ml_tpu_torch.checkpoint import load_pytree

        snap = load_pytree(self.path)
        if snap is None:
            return None
        tree, meta = snap
        if meta.get("kind") != self.KIND:
            raise ValueError(
                f"checkpoint {self.path} is not a {self.KIND} snapshot "
                f"(kind={meta.get('kind')!r})")
        stored = meta.get("bind", {})
        for k, v in self.bind.items():
            if stored.get(k) != v:
                raise ValueError(
                    f"checkpoint {self.path} was written for a different "
                    f"problem ({k}={stored.get(k)!r}, this run has {v!r}); "
                    "delete it or use a distinct path per fit")
        return (tree["carry"], list(tree["outs"]),
                int(meta["next_block"]), int(meta["epoch"]))

    def save(self, carry, outs, next_block: int, epoch: int,
             reason: str = "interval") -> None:
        from dask_ml_tpu_torch.checkpoint import save_pytree

        meta = {"kind": self.KIND, "next_block": int(next_block),
                "epoch": int(epoch), "bind": self.bind, "reason": reason}
        save_pytree(self.path, {"carry": carry, "outs": list(outs)},
                    meta=meta)
        self._since = 0
        self.saves += 1

    def tick(self, carry, outs, next_block: int, epoch: int) -> bool:
        """Called once per completed block: saves when ``every`` blocks
        have completed since the last save."""
        self._since += 1
        if self._since >= self.every:
            self.save(carry, outs, next_block, epoch, reason="interval")
            return True
        return False

    def delete(self) -> None:
        """Remove the snapshot once the run has completed (a stale one
        would hijack the next run at the same path)."""
        try:
            os.unlink(self.path)
        except FileNotFoundError:
            pass


@contextmanager
def scan_checkpoint_scope(path: Optional[str], *, every: int, bind: dict):
    """The checkpointed-scan setup every streamed consumer shares: a
    :class:`GracefulDrain` and a :class:`ScanCheckpoint`, the handlers
    installed for the scope, the checkpoint yielded (``None`` when
    ``path`` is ``None``). The caller loads the snapshot and deletes it on
    completion."""
    if path is None:
        yield None
        return
    drain = GracefulDrain()
    ckpt = ScanCheckpoint(path, every=every, drain=drain, bind=bind)
    with drain:
        yield ckpt


# ---------------------------------------------------------------------------
# deterministic fault injection
# ---------------------------------------------------------------------------


class FaultInjector:
    """Deterministic, planned fault injection for streamed pipelines.

    Attach to a :class:`~dask_ml_tpu_torch.parallel.stream.HostBlockSource`
    (``fault_injector=``): the source calls :meth:`on_load` before reading
    a block and :meth:`on_transfer` in each copy attempt, and
    ``prefetched_scan`` calls :meth:`should_preempt` after each completed
    block. Plans are exact (fail block 3's read twice, preempt after block
    1 of epoch 2); :meth:`random_load_failures` adds seeded random
    failures, reproducible for a fixed seed and call order.

    A :class:`~dask_ml_tpu_torch.parallel.serving.ServingLoop` (or every
    replica of a :class:`~dask_ml_tpu_torch.parallel.fleet.ServingFleet`)
    calls :meth:`on_transfer` in each batch's copy to the card,
    :meth:`should_kill_replica`, :meth:`on_dispatch` and
    :meth:`dispatch_sleep` before each dispatch and
    :meth:`dispatch_penalty` after it; plans name replicas as the fleet
    does (``"{fleet}-r{i}"``).

    ``injected`` counts the delivered faults by kind; with the
    ``telemetry`` knob on, each serving fault also adds to the
    ``faults.injected{kind=...}`` counter."""

    def __init__(self, seed: int = 0):
        self._rng = random.Random(seed)
        self._lock = threading.Lock()
        self._load_fail: dict = {}       # block -> [times_left, exc_type]
        self._transfer_fail: dict = {}   # block -> times_left
        self._load_delay: dict = {}      # block -> [times_left, seconds]
        self._preempt: set = set()       # {(epoch, block)}
        self._dispatch_delay: dict = {}  # batch -> [times_left, seconds]
        self._slow_replica: dict = {}    # replica -> [batches_left, seconds]
        self._kill_replica: dict = {}    # replica -> after_batches
        self._straggle: dict = {}        # replica -> [count, every, s, left]
        self._p_load = 0.0
        self._p_exc = InjectedLoaderError
        self.injected = {"load": 0, "transfer": 0, "delay": 0, "preempt": 0,
                         "dispatch_delay": 0, "slow_replica": 0,
                         "replica_kill": 0, "straggle": 0}

    # -- planning ----------------------------------------------------------

    def fail_load(self, block: int, *, times: int = 1,
                  exc_type=InjectedLoaderError) -> "FaultInjector":
        """Fail the next ``times`` reads of ``block`` (re-reads across
        retries and epochs count down the same budget)."""
        self._load_fail[int(block)] = [int(times), exc_type]
        return self

    def fail_transfer(self, block: int, *, times: int = 1) -> "FaultInjector":
        """Fail the next ``times`` host→device copy attempts of ``block``."""
        self._transfer_fail[int(block)] = int(times)
        return self

    def delay_load(self, block: int, seconds: float, *,
                   times: int = 1) -> "FaultInjector":
        """Sleep ``seconds`` before the next ``times`` reads of ``block``
        (a storage stall)."""
        self._load_delay[int(block)] = [int(times), float(seconds)]
        return self

    def preempt_at(self, block: int, *, epoch: int = 0) -> "FaultInjector":
        """Deliver a preemption after block ``block`` of epoch ``epoch``
        completes: a SIGTERM landing there, without the race."""
        self._preempt.add((int(epoch), int(block)))
        return self

    def delay_dispatch(self, batch: int, seconds: float, *,
                       times: int = 1) -> "FaultInjector":
        """Sleep ``seconds`` before the serving loop dispatches batch
        number ``batch`` (its sequence number on that loop): a real
        wall-clock straggler. For router tests prefer
        :meth:`slow_replica`, which sleeps nowhere."""
        self._dispatch_delay[int(batch)] = [int(times), float(seconds)]
        return self

    def slow_replica(self, replica: str, seconds: float, *,
                     batches: Optional[int] = None) -> "FaultInjector":
        """Mark serving replica ``replica`` a straggler: every batch it
        dispatches reports ``seconds`` of synthetic extra latency (the
        latency its router reads) without sleeping, so failover is
        deterministic. ``batches`` bounds how many dispatches are
        penalized (default: all)."""
        self._slow_replica[str(replica)] = [
            -1 if batches is None else int(batches), float(seconds)]
        return self

    def kill_replica(self, replica: str, *,
                     after_batches: int = 0) -> "FaultInjector":
        """Kill serving replica ``replica`` once it has dispatched
        ``after_batches`` batches: its next dispatch raises
        :class:`SimulatedReplicaDeath`, the loop dies, its queued and
        collected requests fail with that error, and the fleet re-routes
        and replays them. One-shot per replica."""
        self._kill_replica[str(replica)] = int(after_batches)
        return self

    def straggle_replica(self, replica: str, seconds: float, *,
                         every: int = 1,
                         batches: Optional[int] = None) -> "FaultInjector":
        """Make replica ``replica`` a real straggler: every ``every``-th
        dispatched batch sleeps ``seconds`` before it runs (``batches``
        bounds the penalized dispatches; default: all). Unlike
        :meth:`slow_replica` it stalls the dispatch thread, which is what
        a hedging drill needs."""
        self._straggle[str(replica)] = [
            0, max(int(every), 1), float(seconds),
            -1 if batches is None else int(batches)]
        return self

    def kill_process(self, name: str, *, after_requests: int = 0):
        raise NotImplementedError(_WIRE_TIER.format("kill_process"))

    def kill_machine(self, machine: str, *, after_results: int = 0):
        raise NotImplementedError(_WIRE_TIER.format("kill_machine"))

    def slow_link(self, machine: str, seconds: float, *, chunks=None):
        raise NotImplementedError(_WIRE_TIER.format("slow_link"))

    def random_load_failures(self, p: float,
                             exc_type=InjectedLoaderError) -> "FaultInjector":
        """Every block read fails with probability ``p`` (seeded RNG)."""
        self._p_load = float(p)
        self._p_exc = exc_type
        return self

    # -- hooks (called by the pipeline) ------------------------------------

    def on_load(self, block: int) -> None:
        with self._lock:
            plan = self._load_delay.get(block)
            delay = None
            if plan and plan[0] > 0:
                plan[0] -= 1
                delay = plan[1]
                self.injected["delay"] += 1
        if delay:
            time.sleep(delay)
        with self._lock:
            plan = self._load_fail.get(block)
            if plan and plan[0] > 0:
                plan[0] -= 1
                self.injected["load"] += 1
                exc = plan[1](f"injected load failure for block {block}")
            elif self._p_load and self._rng.random() < self._p_load:
                self.injected["load"] += 1
                exc = self._p_exc(f"injected load failure for block {block}")
            else:
                return
        raise exc

    def on_transfer(self, block: int) -> None:
        with self._lock:
            left = self._transfer_fail.get(block, 0)
            if left <= 0:
                return
            self._transfer_fail[block] = left - 1
            self.injected["transfer"] += 1
        raise InjectedTransferError(
            f"injected host-to-device copy failure for block {block}")

    def should_preempt(self, block: int, epoch: int) -> bool:
        with self._lock:
            key = (int(epoch), int(block))
            if key in self._preempt:
                self._preempt.discard(key)  # one-shot: the resume runs clean
                self.injected["preempt"] += 1
                return True
        return False

    # -- serving-loop hooks (called by ServingLoop / ServingFleet) ---------

    def _mirror(self, kind: str) -> None:
        """The registry mirror of ``injected[kind]``, at the same site."""
        from dask_ml_tpu_torch.parallel import telemetry

        if telemetry.enabled():
            telemetry.metrics().counter("faults.injected", kind=kind).inc()

    def on_dispatch(self, batch: int) -> None:
        """Sleep per a :meth:`delay_dispatch` plan before the loop
        dispatches batch ``batch``."""
        with self._lock:
            plan = self._dispatch_delay.get(int(batch))
            delay = None
            if plan and plan[0] > 0:
                plan[0] -= 1
                delay = plan[1]
                self.injected["dispatch_delay"] += 1
        if delay:
            self._mirror("dispatch_delay")
            time.sleep(delay)

    def dispatch_sleep(self, replica: str) -> float:
        """Sleep per the :meth:`straggle_replica` plan before replica
        ``replica`` dispatches a batch; returns the seconds slept."""
        with self._lock:
            plan = self._straggle.get(str(replica))
            if not plan or plan[3] == 0:
                return 0.0
            plan[0] += 1
            if plan[0] % plan[1] != 0:
                return 0.0
            if plan[3] > 0:
                plan[3] -= 1
            self.injected["straggle"] += 1
            seconds = plan[2]
        self._mirror("straggle")
        time.sleep(seconds)
        return seconds

    def dispatch_penalty(self, replica: str) -> float:
        """Synthetic straggler: the extra seconds replica ``replica``
        reports for this dispatch (nothing sleeps)."""
        with self._lock:
            plan = self._slow_replica.get(str(replica))
            if not plan or plan[0] == 0:
                return 0.0
            if plan[0] > 0:
                plan[0] -= 1
            self.injected["slow_replica"] += 1
            seconds = plan[1]
        self._mirror("slow_replica")
        return seconds

    def should_kill_replica(self, replica: str, n_batches: int) -> bool:
        """True once, when ``replica`` has dispatched ``after_batches``
        batches (see :meth:`kill_replica`)."""
        with self._lock:
            after = self._kill_replica.get(str(replica))
            if after is None or int(n_batches) < after:
                return False
            del self._kill_replica[str(replica)]
            self.injected["replica_kill"] += 1
        self._mirror("replica_kill")
        return True

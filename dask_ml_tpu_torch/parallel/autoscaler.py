"""The SLO autoscaler: a control loop over the fleet's own signals (the
counterpart of ``dask_ml_tpu/parallel/autoscaler.py``).

The serving tier exports its load (queue depth, latency percentiles, shed
counts). This module closes the loop: a control thread reads the same
signals through ``fleet.signals()`` and acts on the fleet's scale calls.

- **Breach → spawn.** When the p99 latency, the queue depth or the shed
  rate exceeds the :class:`SLO` for ``breach_ticks`` consecutive ticks
  (one slow batch is noise, a sustained breach is load) and the scale-up
  cooldown has passed, the autoscaler calls ``fleet.scale_up(1)``: a fresh
  replica process that fetches the snapshot (only the missing chunks,
  through its machine's cache), warms every program, and only then joins
  rotation. ``max_replicas`` bounds it.
- **Quiet → drain.** When every signal stays under ``clear_fraction`` of
  its bound for ``quiet_ticks`` consecutive ticks and the (longer)
  scale-down cooldown has passed, it calls ``fleet.drain_slot()``:
  SIGTERM, a graceful drain, a tombstone, exit 0, never a kill.
  ``min_replicas`` bounds it.
- **No flapping.** The consecutive-tick rules filter spikes, the cooldowns
  are asymmetric (down waits longer than up), and each action resets both
  streaks, so one burst makes one decision.

Counters at their increment sites: ``autoscaler.scale_ups``,
``autoscaler.scale_downs``, ``autoscaler.breaches`` and the
``autoscaler.replicas`` gauge. :attr:`Autoscaler.decisions` records every
action with the signals that drove it. :meth:`Autoscaler.tick` takes a
``now=`` clock, so the control law can be driven step by step.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from collections import deque
from typing import Optional

__all__ = ["SLO", "Autoscaler"]


@dataclasses.dataclass
class SLO:
    """The service-level objective the autoscaler defends.

    ``target_p99_s`` bounds the fleet's p99 request latency (pooled
    router-side observations); ``max_queue_depth`` bounds total
    in-flight requests across replicas; ``max_shed_per_s`` bounds the
    rate of deadline sheds (0.0 = any sustained shedding is a breach).
    Set a bound to ``float("inf")`` to ignore that signal."""

    target_p99_s: float = 0.5
    max_queue_depth: float = 64.0
    max_shed_per_s: float = 0.0


class Autoscaler:
    """Control loop over ``fleet.signals()`` (module docstring has the
    policy). The fleet must expose ``signals() -> {"p99_s",
    "queue_depth", "shed_total", "replicas_up"}``, ``scale_up(k)``, and
    ``drain_slot()`` — :class:`~dask_ml_tpu_torch.parallel.procfleet.
    ProcessFleet` does.

    Scale-up runs INLINE on the control thread (spawn + snapshot fetch +
    warmup can take seconds); the loop simply does not tick while a
    replica is coming up, which is itself a cooldown.

    Parameters
    ----------
    breach_ticks, quiet_ticks : int
        Hysteresis: consecutive breaching (resp. quiet) ticks required
        before acting. Quiet needs more ticks than breach — adding
        capacity late costs latency, removing it late costs only money.
    scale_up_cooldown_s, scale_down_cooldown_s : float
        Minimum seconds between successive scale-ups (resp. downs).
    clear_fraction : float
        The quiet threshold as a fraction of each SLO bound (0.5 = a
        signal is quiet below half its limit) — the hysteresis BAND
        between "not breaching" and "drain-worthy".
    """

    def __init__(self, fleet, slo: Optional[SLO] = None, *,
                 min_replicas: int = 1, max_replicas: int = 4,
                 interval_s: float = 0.25,
                 breach_ticks: int = 2, quiet_ticks: int = 8,
                 scale_up_cooldown_s: float = 2.0,
                 scale_down_cooldown_s: float = 10.0,
                 clear_fraction: float = 0.5):
        if int(min_replicas) < 1:
            raise ValueError("min_replicas must be >= 1")
        if int(max_replicas) < int(min_replicas):
            raise ValueError("max_replicas must be >= min_replicas")
        self.fleet = fleet
        self.slo = slo if slo is not None else SLO()
        self.min_replicas = int(min_replicas)
        self.max_replicas = int(max_replicas)
        self.interval_s = float(interval_s)
        self.breach_ticks = int(breach_ticks)
        self.quiet_ticks = int(quiet_ticks)
        self.scale_up_cooldown_s = float(scale_up_cooldown_s)
        self.scale_down_cooldown_s = float(scale_down_cooldown_s)
        self.clear_fraction = float(clear_fraction)

        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._breach_streak = 0
        self._quiet_streak = 0
        self._last_up = -1e18     # monotonic instants of the last actions
        self._last_down = -1e18
        self._last_shed: Optional[float] = None
        self._last_tick_t: Optional[float] = None
        #: ring of decision records: {"action", "t", "signals", "reason"}
        self.decisions: deque = deque(maxlen=256)
        self.n_scale_ups = 0
        self.n_scale_downs = 0
        self.n_breaches = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "Autoscaler":
        from dask_ml_tpu_torch.parallel import telemetry

        if self._thread is not None and self._thread.is_alive():
            return self
        self._telemetry_inherit = telemetry.enabled()
        self._stop.clear()
        self._thread = threading.Thread(
            target=self._loop, name="autoscaler", daemon=True)
        self._thread.start()
        return self

    def __enter__(self) -> "Autoscaler":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self, timeout: Optional[float] = 30.0) -> None:
        self._stop.set()
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout)

    def _loop(self) -> None:
        import contextlib
        import logging

        from dask_ml_tpu_torch import config as config_lib

        ctx = (config_lib.config_context(telemetry=True)
               if getattr(self, "_telemetry_inherit", False)
               else contextlib.nullcontext())
        with ctx:
            while not self._stop.wait(self.interval_s):
                # the control loop must outlive a surprised tick: a
                # failed scale action is logged and retried next breach
                try:
                    self.tick()
                except Exception:  # noqa: BLE001
                    logging.getLogger(__name__).exception(
                        "autoscaler: tick failed (continuing)")

    # -- telemetry ---------------------------------------------------------

    def _telemetry_on(self) -> bool:
        from dask_ml_tpu_torch.parallel import telemetry

        return telemetry.enabled() or getattr(
            self, "_telemetry_inherit", False)

    def _count(self, attr: str, counter: str, **labels) -> None:
        from dask_ml_tpu_torch.parallel import telemetry

        with self._lock:
            setattr(self, attr, getattr(self, attr) + 1)
        if self._telemetry_on():
            telemetry.metrics().counter(counter, **labels).inc()

    def _set_gauge(self, replicas_up: int) -> None:
        from dask_ml_tpu_torch.parallel import telemetry

        if self._telemetry_on():
            telemetry.metrics().gauge("autoscaler.replicas").set(
                int(replicas_up))

    # -- the control law ---------------------------------------------------

    def _classify(self, sig: dict, shed_rate: float) -> tuple:
        """→ (breaching, quiet, reasons): breach = ANY signal over its
        bound; quiet = EVERY signal under ``clear_fraction`` of it. The
        band between is hysteresis — no action either way."""
        slo = self.slo
        reasons = []
        if sig["p99_s"] > slo.target_p99_s:
            reasons.append(f"p99 {sig['p99_s']:.3f}s > "
                           f"{slo.target_p99_s:.3f}s")
        if sig["queue_depth"] > slo.max_queue_depth:
            reasons.append(f"queue {sig['queue_depth']} > "
                           f"{slo.max_queue_depth:g}")
        if shed_rate > slo.max_shed_per_s:
            reasons.append(f"shed {shed_rate:.2f}/s > "
                           f"{slo.max_shed_per_s:g}/s")
        breaching = bool(reasons)
        frac = self.clear_fraction
        quiet = (not breaching
                 and sig["p99_s"] <= frac * slo.target_p99_s
                 and sig["queue_depth"] <= frac * slo.max_queue_depth
                 and shed_rate <= frac * slo.max_shed_per_s)
        return breaching, quiet, reasons

    def tick(self, now: Optional[float] = None) -> Optional[str]:
        """One control evaluation (the loop calls this; tests may drive
        it directly with a synthetic clock). Returns the action taken
        (``"scale_up"`` / ``"scale_down"``) or None."""
        now = time.monotonic() if now is None else float(now)
        sig = self.fleet.signals()
        with self._lock:
            last_shed = self._last_shed
            last_t = self._last_tick_t
            self._last_shed = float(sig.get("shed_total", 0.0))
            self._last_tick_t = now
        dt = max(now - last_t, 1e-9) if last_t is not None else None
        shed_rate = 0.0 if (dt is None or last_shed is None) else \
            max(float(sig.get("shed_total", 0.0)) - last_shed, 0.0) / dt
        breaching, quiet, reasons = self._classify(sig, shed_rate)
        up = int(sig.get("replicas_up", 0))
        self._set_gauge(up)
        if breaching:
            self._count("n_breaches", "autoscaler.breaches")
        with self._lock:
            self._breach_streak = self._breach_streak + 1 if breaching \
                else 0
            self._quiet_streak = self._quiet_streak + 1 if quiet else 0
            fire_up = (self._breach_streak >= self.breach_ticks
                       and up < self.max_replicas
                       and now - self._last_up >= self.scale_up_cooldown_s)
            fire_down = (not fire_up
                         and self._quiet_streak >= self.quiet_ticks
                         and up > self.min_replicas
                         and now - self._last_down
                         >= self.scale_down_cooldown_s)
        record = {"t": now, "signals": dict(sig),
                  "shed_rate": round(shed_rate, 4)}
        if fire_up:
            names = self.fleet.scale_up(1)
            with self._lock:
                self._last_up = now
                self._breach_streak = 0
                self._quiet_streak = 0
            self._count("n_scale_ups", "autoscaler.scale_ups")
            self._set_gauge(int(self.fleet.signals().get(
                "replicas_up", up + 1)))
            self.decisions.append({**record, "action": "scale_up",
                                   "replicas": names,
                                   "reason": "; ".join(reasons)})
            return "scale_up"
        if fire_down:
            name = self.fleet.drain_slot()
            with self._lock:
                self._last_down = now
                self._breach_streak = 0
                self._quiet_streak = 0
            if name is not None:
                self._count("n_scale_downs", "autoscaler.scale_downs")
                self.decisions.append({**record, "action": "scale_down",
                                       "replicas": [name],
                                       "reason": "quiet"})
                return "scale_down"
        return None

    def stats(self) -> dict:
        with self._lock:
            return {
                "scale_ups": self.n_scale_ups,
                "scale_downs": self.n_scale_downs,
                "breaches": self.n_breaches,
                "breach_streak": self._breach_streak,
                "quiet_streak": self._quiet_streak,
                "min_replicas": self.min_replicas,
                "max_replicas": self.max_replicas,
            }

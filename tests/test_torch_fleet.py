"""The PyTorch port's in-process serving fleet (``parallel/fleet.py``) on
the CPU: one test for each in-process scenario of ``tests/test_fleet.py``
(replica placement, results equal to direct whichever replica answered,
spillover, straggler avoidance, the circuit breaker, death with re-route
and replay, false deaths, idempotent request ids, shedding and its
telemetry, hot-swap under traffic, the shared drain, stop, hedging).

Every wait is bounded; events and polls of the fleet's own state order
the steps, never a sleep.
"""

import signal
import threading
import time

import numpy as np
import pytest
import torch

from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.decomposition import PCA
from dask_ml_tpu_torch.linear_model import LogisticRegression
from dask_ml_tpu_torch.parallel import telemetry
from dask_ml_tpu_torch.parallel.faults import FaultInjector, GracefulDrain
from dask_ml_tpu_torch.parallel.fleet import FleetTimeoutError, ServingFleet
from dask_ml_tpu_torch.parallel.serving import (DeadlineExceeded,
                                                ModelRegistry,
                                                ServingError,
                                                ServingQueueFull,
                                                ServingStopped)
from dask_ml_tpu_torch.parallel.shapes import track_compiles
from dask_ml_tpu_torch.wrappers import ParallelPostFit

RAGGED_SIZES = (1, 3, 31, 32, 33, 64, 100, 128)
WAIT = 60


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


def _data(n=512, d=8, seed=0):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def until(cond, timeout=15.0, what="condition"):
    """Poll ``cond`` (the fleet's own state) until true, at most
    ``timeout`` seconds."""
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        threading.Event().wait(0.005)


@pytest.fixture(scope="module")
def fitted():
    X = _data(512, 8)
    rng = np.random.RandomState(1)
    y = (rng.rand(512) > 0.5).astype(np.int32)
    with config_context(device="cpu"):
        return {
            "X": X,
            "kmeans": KMeans(n_clusters=4, random_state=0,
                             max_iter=5).fit(X),
            "logistic": LogisticRegression(max_iter=20).fit(X, y),
            "logistic_v2": LogisticRegression(max_iter=60,
                                              C=0.3).fit(X, y),
            "pca": PCA(n_components=3, random_state=0).fit(X),
        }


def _make_fleet(fitted, n_replicas=3, **kw):
    fleet = ServingFleet(n_replicas=n_replicas, max_batch_rows=256, **kw)
    fleet.start()
    fleet.register("kmeans", fitted["kmeans"])
    fleet.register("logistic", fitted["logistic"])
    fleet.register("pca", fitted["pca"])
    return fleet


class _GateModel:
    """A host model whose dispatches wait for ``release``; records the
    rows of each batch."""

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()
        self.calls = []
        self._lock = threading.Lock()

    def predict(self, X):
        self.entered.set()
        self.release.wait(WAIT)
        with self._lock:
            self.calls.append(int(len(X)))
        return np.zeros(len(X), np.float32)


# ---------------------------------------------------------------------------
# placement, results equal to direct
# ---------------------------------------------------------------------------


def test_replica_devices(fitted, monkeypatch):
    """``devices=`` places one replica a device; by default replica i
    takes card i while there are enough, else the cards round robin (on
    one card every replica shares it); on the CPU every replica runs
    there."""
    fleet = _make_fleet(fitted, n_replicas=3)
    try:
        assert [r.device for r in fleet._replicas] == \
            [torch.device("cpu")] * 3
        assert fleet.replicas_up() == 3
    finally:
        fleet.stop()
    fl = ServingFleet(devices=["cpu", "cpu"])
    assert fl._build_devices() == [torch.device("cpu")] * 2
    from dask_ml_tpu_torch import config as config_lib

    monkeypatch.setattr(config_lib, "resolve_device",
                        lambda d=None: torch.device(d or "cuda"))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert ServingFleet(n_replicas=3)._build_devices() == \
        [torch.device("cuda", 0)] * 3
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert ServingFleet(n_replicas=3)._build_devices() == [
        torch.device("cuda", 0), torch.device("cuda", 1),
        torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="n_replicas"):
        ServingFleet(n_replicas=0)._build_devices()
    with pytest.raises(ValueError, match="at least one"):
        ServingFleet(devices=[])._build_devices()


@pytest.mark.parametrize("name,method", [
    ("kmeans", "predict"),
    ("logistic", "predict"),
    ("logistic", "predict_proba"),
    ("pca", "transform"),
])
def test_every_replica_serves_like_direct(fitted, name, method):
    fleet = _make_fleet(fitted, n_replicas=3)
    try:
        est = fitted[name]
        X = fitted["X"]
        direct = getattr(est, method)
        futs = [(n, fleet.submit(name, X[:n], method=method))
                for n in RAGGED_SIZES * 3]
        for n, fut in futs:
            got, want = fut.result(WAIT), direct(X[:n])
            if name == "kmeans":
                np.testing.assert_array_equal(got, want)
            elif method == "predict":
                sure = np.abs(est.predict_proba(X[:n]) - 0.5) > 1e-5
                np.testing.assert_array_equal(got[sure], want[sure])
            else:  # plain products: see tests/test_torch_serving.py
                np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
        served = [r["batches"] for r in fleet.stats()["replicas"].values()]
        assert sum(1 for b in served if b > 0) >= 2, served
    finally:
        fleet.stop()


# ---------------------------------------------------------------------------
# the router: spillover, stragglers, the breaker
# ---------------------------------------------------------------------------


def test_queue_full_spills_over_before_surfacing():
    """A full replica spills over to its sibling; ServingQueueFull reaches
    the caller only when every live replica is full."""
    gate = _GateModel()
    fleet = ServingFleet(n_replicas=2, max_batch_rows=8, max_queue=2,
                         heartbeat_timeout_s=60.0)
    fleet.start()
    fleet.registry.register("gate", gate)
    try:
        futs = []
        with pytest.raises(ServingQueueFull):
            for _ in range(16):
                futs.append(fleet.submit("gate", np.zeros((5, 3),
                                                          np.float32)))
        assert fleet.n_spillovers >= 1
        gate.release.set()
        for f in futs:
            f.result(WAIT)
    finally:
        gate.release.set()
        fleet.stop()


def test_router_avoids_injected_straggler(fitted):
    """slow_replica reports synthetic latency (nothing sleeps): once it
    exceeds the routing quantum, traffic goes to the sibling."""
    fi = FaultInjector().slow_replica("fl-r0", 5.0)
    fleet = ServingFleet(n_replicas=2, max_batch_rows=256,
                         fault_injector=fi, name="fl")
    fleet.start()
    fleet.register("kmeans", fitted["kmeans"])
    try:
        X = fitted["X"]
        t0 = time.perf_counter()
        for i in range(20):
            np.testing.assert_array_equal(
                fleet.call("kmeans", X[i:i + 4], timeout=WAIT),
                fitted["kmeans"].predict(X[i:i + 4]))
        assert time.perf_counter() - t0 < 4.0, "the penalty must not sleep"
        assert fi.injected["slow_replica"] >= 1
        r0, r1 = fleet._replicas
        assert r0.loop.latency_s() > 1.0 > r1.loop.latency_s()
        assert fleet.stats()["replicas"]["fl-r1"]["batches"] >= 15
    finally:
        fleet.stop()


def test_circuit_breaker_takes_failing_replica_out(fitted):
    fleet = _make_fleet(fitted, n_replicas=2,
                        max_consecutive_failures=3, breaker_cooldown_s=0.2)
    try:
        r0, r1 = fleet._replicas
        for _ in range(3):
            fleet._note_failure(r0)
        assert r0.breaker_open()
        for _ in range(10):
            assert fleet._pick(set()) is r1
        # the cooldown runs out on the clock; then the half-open probe
        until(lambda: not r0.breaker_open(), what="the cooldown")
        assert r0.name in {fleet._pick(set()).name for _ in range(10)}
        fleet._note_success(r0)
        assert not r0.breaker_open() and r0.consecutive_failures == 0
        # every live replica's breaker open: the soonest to close probes
        for _ in range(3):
            fleet._note_failure(r0)
            fleet._note_failure(r1)
        assert fleet._pick(set()) in (r0, r1)
    finally:
        fleet.stop()


# ---------------------------------------------------------------------------
# replica death: re-route and replay, once by request id
# ---------------------------------------------------------------------------


def test_replica_kill_reroutes_and_replays(fitted):
    """kill_replica mid-traffic: the batch the dying replica collected
    fails over to the survivor, nothing is lost, every result equals the
    direct call, and the monitor takes the dead replica out. The calls
    are sequential and both replicas idle between them, so the router's
    round robin reaches r0 again after its first batch, and the kill
    fires on that second batch."""
    fi = FaultInjector().kill_replica("fk-r0", after_batches=1)
    fleet = ServingFleet(n_replicas=2, max_batch_rows=256,
                         fault_injector=fi, heartbeat_interval_s=0.02,
                         name="fk")
    fleet.start()
    fleet.register("kmeans", fitted["kmeans"])
    try:
        X = fitted["X"]
        km = fitted["kmeans"]
        for i in range(40):
            np.testing.assert_array_equal(
                fleet.call("kmeans", X[i:i + 8], timeout=WAIT),
                km.predict(X[i:i + 8]))
        assert fi.injected["replica_kill"] == 1
        until(lambda: fleet.stats()["replica_deaths"] == 1,
              what="the death")
        s = fleet.stats()
        assert s["replicas_up"] == 1
        assert s["reroutes"] >= 1
        assert s["inflight"] == 0
        r0 = fleet._replicas[0]
        assert r0.dead and type(r0.loop.fatal).__name__ == \
            "SimulatedReplicaDeath"
    finally:
        fleet.stop()


def test_false_positive_death_duplicates_compute_not_resolution():
    gate = _GateModel()
    fleet = ServingFleet(n_replicas=2, max_batch_rows=8,
                         heartbeat_timeout_s=60.0, name="fp")
    fleet.start()
    fleet.registry.register("gate", gate)
    try:
        fut = fleet.submit("gate", np.zeros((4, 3), np.float32))
        until(lambda: bool(fleet._inflight), what="the request in flight")
        (freq,) = fleet._inflight.values()
        victim = next(r for r in fleet._replicas if r.name == freq.replica)
        fleet._declare_dead(victim)  # false: the loop is alive
        gate.release.set()
        np.testing.assert_array_equal(fut.result(WAIT),
                                      np.zeros(4, np.float32))
        until(lambda: len(gate.calls) == 2, what="both computations")
        assert fleet.stats()["inflight"] == 0
        assert fleet.n_reroutes == 1
    finally:
        gate.release.set()
        fleet.stop()


def test_heartbeat_stall_declares_dead_and_replays(fitted):
    gate = _GateModel()
    fleet = ServingFleet(n_replicas=2, max_batch_rows=8,
                         heartbeat_interval_s=0.02,
                         heartbeat_timeout_s=1.0, name="hb")
    fleet.start()
    fleet.registry.register("gate", gate)
    fleet.register("kmeans", fitted["kmeans"])
    try:
        # the gate holds one replica's dispatch thread: its beat stalls
        # past the timeout while the thread stays alive
        fut = fleet.submit("gate", np.zeros((4, 3), np.float32))
        until(lambda: fleet.replicas_up() == 1, what="the stall")
        assert fleet.stats()["replica_deaths"] == 1
        gate.release.set()
        np.testing.assert_array_equal(fut.result(WAIT),
                                      np.zeros(4, np.float32))
        np.testing.assert_array_equal(
            fleet.call("kmeans", fitted["X"][:8], timeout=WAIT),
            fitted["kmeans"].predict(fitted["X"][:8]))
    finally:
        gate.release.set()
        fleet.stop()


def test_false_positive_death_heals_when_heartbeat_returns():
    gate = _GateModel()
    fleet = ServingFleet(n_replicas=2, max_batch_rows=8,
                         heartbeat_interval_s=0.02,
                         heartbeat_timeout_s=0.3, name="rv")
    fleet.start()
    fleet.registry.register("gate", gate)
    try:
        fut = fleet.submit("gate", np.zeros((4, 3), np.float32))
        until(lambda: fleet.replicas_up() == 1, what="the false death")
        gate.release.set()  # the batch ends, the beat returns
        fut.result(WAIT)
        until(lambda: fleet.replicas_up() == 2, what="the revival")
        assert all(not r.dead for r in fleet._replicas)
    finally:
        gate.release.set()
        fleet.stop()


def test_request_id_idempotent(fitted):
    fleet = _make_fleet(fitted, n_replicas=2)
    gate = _GateModel()
    fleet.registry.register("gate", gate)
    try:
        f1 = fleet.submit("gate", np.zeros((3, 3), np.float32),
                          request_id="rid-1")
        f2 = fleet.submit("gate", np.zeros((3, 3), np.float32),
                          request_id="rid-1")
        assert f1 is f2  # a client retry is the same request
        gate.release.set()
        f1.result(WAIT)
        assert len(gate.calls) == 1
    finally:
        gate.release.set()
        fleet.stop()


def test_replay_budget_ends_a_request():
    """A request that outlives its re-route budget fails with the
    replica's error instead of bouncing for ever."""
    gate = _GateModel()
    fleet = ServingFleet(n_replicas=2, max_batch_rows=8, max_replays=0,
                         heartbeat_timeout_s=60.0, name="rb")
    fleet.start()
    fleet.registry.register("gate", gate)
    try:
        fut = fleet.submit("gate", np.zeros((4, 3), np.float32))
        until(lambda: gate.entered.is_set(), what="the dispatch")
        (freq,) = fleet._inflight.values()
        victim = next(r for r in fleet._replicas if r.name == freq.replica)
        fleet._declare_dead(victim)
        with pytest.raises(ServingStopped, match="declared dead"):
            fut.result(WAIT)
    finally:
        gate.release.set()
        fleet.stop()


# ---------------------------------------------------------------------------
# admission at the fleet
# ---------------------------------------------------------------------------


def test_fleet_shed_and_telemetry_mirrors(fitted):
    telemetry.reset_telemetry()
    try:
        with config_context(telemetry=True):
            fleet = _make_fleet(fitted, n_replicas=2)
            try:
                with pytest.raises(DeadlineExceeded):
                    fleet.submit("kmeans", fitted["X"][:4], deadline=-1.0)
                fleet.call("kmeans", fitted["X"][:4], timeout=WAIT)
                assert fleet.n_shed == 1
            finally:
                fleet.stop()
            rep = telemetry.telemetry_report()
        counters = rep["metrics"]["counters"]
        assert counters["fleet.shed{model=kmeans}"] == 1
        assert rep["metrics"]["gauges"]["fleet.replica_up"]["max"] == 2
        assert "fleet.request" in [s["name"] for s in telemetry.spans()]
    finally:
        telemetry.reset_telemetry()


def test_mixed_priority_traffic_all_resolve(fitted):
    fleet = _make_fleet(fitted, n_replicas=3)
    try:
        X = fitted["X"]
        km = fitted["kmeans"]
        futs = []
        for i in range(60):
            kw = {}
            if i % 3 == 0:
                kw = {"priority": 5, "deadline": 30.0}
            elif i % 3 == 1:
                kw = {"deadline": 30.0}
            futs.append((i, fleet.submit("kmeans", X[i:i + 8], **kw)))
        for i, f in futs:  # 30 s budgets never run out here
            np.testing.assert_array_equal(f.result(WAIT),
                                          km.predict(X[i:i + 8]))
    finally:
        fleet.stop()


def test_validation_error_reaches_the_caller(fitted):
    fleet = _make_fleet(fitted, n_replicas=2)
    try:
        with pytest.raises(ValueError, match="features"):
            fleet.submit("kmeans", fitted["X"][:4, :3])
        with pytest.raises(KeyError):
            fleet.submit("nope", fitted["X"][:4])
        assert fleet.stats()["inflight"] == 0
    finally:
        fleet.stop()
    with pytest.raises(ServingStopped):
        ServingFleet().submit("kmeans", fitted["X"][:4])  # never started
    assert issubclass(FleetTimeoutError, ServingError)


# ---------------------------------------------------------------------------
# hot-swap
# ---------------------------------------------------------------------------


def test_swap_under_traffic_loses_nothing(fitted):
    """Clients hammer the fleet while the model is swapped: every request
    resolves, to the old model's answer or the new one's, the version
    moves up, and the traffic after the swap builds and loads nothing."""
    fleet = _make_fleet(fitted, n_replicas=3)
    try:
        X = fitted["X"]
        old, new = fitted["logistic"], fitted["logistic_v2"]
        v0 = fleet.registry.version("logistic")
        sizes = (8, 16, 24)
        old_out = {n: old.predict_proba(X[:n]) for n in sizes}
        new_out = {n: new.predict_proba(X[:n]) for n in sizes}
        results, errors = [], []
        lock = threading.Lock()
        stop_evt = threading.Event()

        def hammer():
            with config_context(device="cpu"):
                i = 0
                while not stop_evt.is_set():
                    n = sizes[i % 3]
                    i += 1
                    try:
                        out = fleet.call("logistic", X[:n],
                                         method="predict_proba",
                                         timeout=WAIT)
                    except Exception as e:  # noqa: BLE001
                        errors.append(e)
                        return
                    with lock:
                        results.append((n, out))

        threads = [threading.Thread(target=hammer) for _ in range(4)]
        for t in threads:
            t.start()
        until(lambda: len(results) >= 40, what="traffic before the swap")
        v1 = fleet.swap("logistic", new)
        with lock:
            at_swap = len(results)
        with track_compiles() as steady:
            until(lambda: len(results) >= at_swap + 40,
                  what="traffic after the swap")
        stop_evt.set()
        for t in threads:
            t.join(WAIT)
        assert not errors, errors
        assert v1 > v0 and fleet.registry.version("logistic") == v1
        assert fleet.n_swaps == 1
        n_old = n_new = 0
        for n, out in results:
            if np.allclose(out, old_out[n], rtol=1e-5, atol=1e-6):
                n_old += 1
            elif np.allclose(out, new_out[n], rtol=1e-5, atol=1e-6):
                n_new += 1
            else:
                raise AssertionError("a result matches neither version")
        assert n_old > 0 and n_new > 0, (n_old, n_new)
        assert steady["n_compiles"] == 0 and steady["n_loads"] == 0
        np.testing.assert_allclose(
            fleet.call("logistic", X[:16], method="predict_proba",
                       timeout=WAIT), new_out[16], rtol=1e-5, atol=1e-6)
    finally:
        stop_evt.set()
        fleet.stop()


# ---------------------------------------------------------------------------
# drain and stop
# ---------------------------------------------------------------------------


def test_shared_drain_drains_all_replicas(fitted):
    drain = GracefulDrain()
    fleet = ServingFleet(n_replicas=3, max_batch_rows=256, drain=drain,
                         name="dr")
    fleet.start()
    fleet.register("kmeans", fitted["kmeans"])
    try:
        X = fitted["X"]
        futs = [fleet.submit("kmeans", X[:8]) for _ in range(20)]
        drain.request()
        expected = fitted["kmeans"].predict(X[:8])
        for f in futs:
            np.testing.assert_array_equal(f.result(WAIT), expected)
        with pytest.raises(ServingStopped):
            fleet.submit("kmeans", X[:8])
        for rep in fleet._replicas:
            until(lambda rep=rep: rep.loop.stopped, what="the replica stop")
            assert rep.loop.queue_depth() == 0
    finally:
        fleet.stop()


def test_drain_reentrancy_with_fleet(fitted):
    drain = GracefulDrain()
    before = signal.getsignal(signal.SIGTERM)
    with drain:
        installed = signal.getsignal(signal.SIGTERM)
        with drain:  # re-entry installs nothing again
            assert signal.getsignal(signal.SIGTERM) is installed
            fleet = ServingFleet(n_replicas=2, drain=drain, name="rz")
            fleet.start()
            fleet.register("kmeans", fitted["kmeans"])
            np.testing.assert_array_equal(
                fleet.call("kmeans", fitted["X"][:8], timeout=WAIT),
                fitted["kmeans"].predict(fitted["X"][:8]))
            fleet.stop()
        assert signal.getsignal(signal.SIGTERM) is installed
    assert signal.getsignal(signal.SIGTERM) == before


def test_fleet_stop_leaves_nothing_pending(fitted):
    X = fitted["X"]
    expected = fitted["kmeans"].predict(X[:3])
    fleet = _make_fleet(fitted, n_replicas=2)
    barrier = threading.Barrier(4)
    futures: list = []
    flock = threading.Lock()

    def worker():
        with config_context(device="cpu"):
            barrier.wait(WAIT)
            for _ in range(40):
                try:
                    f = fleet.submit("kmeans", X[:3])
                except ServingStopped:
                    return
                with flock:
                    futures.append(f)

    threads = [threading.Thread(target=worker) for _ in range(3)]
    for t in threads:
        t.start()
    barrier.wait(WAIT)
    fleet.stop(drain=True)
    for t in threads:
        t.join(WAIT)
        assert not t.is_alive()
    for f in futures:
        try:
            np.testing.assert_array_equal(f.result(WAIT), expected)
        except ServingStopped:
            pass
    assert fleet.stats()["inflight"] == 0


def test_clean_drain_records_no_replica_deaths(fitted):
    telemetry.reset_telemetry()
    drain = GracefulDrain()
    try:
        with config_context(telemetry=True):
            fleet = ServingFleet(n_replicas=2, drain=drain,
                                 heartbeat_interval_s=0.02, name="cd")
            fleet.start()
            fleet.register("kmeans", fitted["kmeans"])
            fleet.call("kmeans", fitted["X"][:8], timeout=WAIT)
            drain.request()
            # the monitor marks each stopped replica: proof it looked at
            # every one after the drain
            until(lambda: all(r.dead for r in fleet._replicas),
                  what="the monitor's pass over the stopped replicas")
            assert fleet.n_replica_deaths == 0
            fleet.stop()
        counters = telemetry.telemetry_report()["metrics"]["counters"]
        assert not any(k.startswith("fleet.replica_deaths")
                       for k in counters), counters
    finally:
        telemetry.reset_telemetry()


# ---------------------------------------------------------------------------
# ParallelPostFit through the fleet
# ---------------------------------------------------------------------------


def test_parallel_post_fit_serves_through_fleet(fitted):
    fleet = _make_fleet(fitted, n_replicas=2)
    try:
        X = fitted["X"]
        clf = ParallelPostFit(estimator=fitted["kmeans"], serving=fleet,
                              serving_model="ppf-kmeans")
        np.testing.assert_array_equal(clf.predict(X[:300]),
                                      fitted["kmeans"].predict(X[:300]))
        small = ParallelPostFit(estimator=fitted["pca"], serving=fleet,
                                block_size=64)  # chunked across the fleet
        np.testing.assert_allclose(small.transform(X[:200]),
                                   fitted["pca"].transform(X[:200]),
                                   rtol=1e-5, atol=1e-6)
    finally:
        fleet.stop()


# ---------------------------------------------------------------------------
# hedging
# ---------------------------------------------------------------------------


class _FirstCallStraggler:
    """A host model whose first dispatch waits until released; every later
    one answers at once."""

    def __init__(self):
        self.release = threading.Event()
        self._lock = threading.Lock()
        self.calls = 0

    def predict(self, X):
        with self._lock:
            self.calls += 1
            first = self.calls == 1
        if first:
            self.release.wait(WAIT)
        return np.full(len(X), 7.0, np.float32)


def test_hedge_rescues_tail_and_mirrors_exactly():
    telemetry.reset_telemetry()
    model = _FirstCallStraggler()
    try:
        with config_context(telemetry=True):
            fleet = ServingFleet(n_replicas=2, max_batch_rows=256,
                                 hedge=True, hedge_factor=1.0,
                                 hedge_min_s=0.02, hedge_cold_s=0.05,
                                 heartbeat_timeout_s=30.0, name="hg")
            fleet.start()
            fleet.register("straggler", model)
            try:
                # the first attempt never answers until released: only the
                # hedge can resolve the future
                out = fleet.call("straggler", np.zeros((8, 3), np.float32),
                                 timeout=WAIT)
                np.testing.assert_array_equal(out,
                                              np.full(8, 7.0, np.float32))
                assert fleet.n_hedged == 1 and fleet.n_hedge_wins == 1
                st = fleet.stats()
                assert st["hedged"] == 1 and st["hedge_wins"] == 1
            finally:
                model.release.set()
                fleet.stop()
            rep = telemetry.telemetry_report()
        counters = rep["metrics"]["counters"]
        assert sum(v for k, v in counters.items()
                   if k.startswith("serving.hedged")) == 1
        assert sum(v for k, v in counters.items()
                   if k.startswith("serving.hedge_wins")) == 1
    finally:
        model.release.set()
        telemetry.reset_telemetry()


def test_hedge_default_off(fitted):
    fleet = _make_fleet(fitted, n_replicas=2)
    try:
        assert fleet.hedge is False
        for _ in range(5):
            fleet.call("kmeans", fitted["X"][:8], timeout=WAIT)
        assert fleet.n_hedged == 0 and fleet.n_hedge_wins == 0
    finally:
        fleet.stop()


# ---------------------------------------------------------------------------
# the fault plans of the serving tier
# ---------------------------------------------------------------------------


def test_dispatch_hooks_and_straggle(fitted):
    """delay_dispatch and straggle_replica stall real dispatches (counted
    and mirrored); the results are unchanged."""
    telemetry.reset_telemetry()
    fi = (FaultInjector().delay_dispatch(1, 0.01)
          .straggle_replica("sg-r0", 0.01, every=2, batches=2))
    try:
        with config_context(telemetry=True):
            fleet = ServingFleet(n_replicas=1, fault_injector=fi, name="sg")
            fleet.start()
            fleet.register("kmeans", fitted["kmeans"])
            try:
                for i in range(6):
                    np.testing.assert_array_equal(
                        fleet.call("kmeans", fitted["X"][i:i + 4],
                                   timeout=WAIT),
                        fitted["kmeans"].predict(fitted["X"][i:i + 4]))
            finally:
                fleet.stop()
            counters = telemetry.metrics().snapshot()["counters"]
        assert fi.injected["dispatch_delay"] == 1
        assert fi.injected["straggle"] == 2
        assert counters["faults.injected{kind=straggle}"] == 2
        assert counters["faults.injected{kind=dispatch_delay}"] == 1
    finally:
        telemetry.reset_telemetry()


@pytest.mark.parametrize("plan", ["kill_process", "kill_machine",
                                  "slow_link"])
def test_process_fleet_plans_wait_for_the_wire_tier(plan):
    """The process fleet's plans: ``kill_process`` (one-shot at its request
    count), and the cross-machine ``kill_machine`` (one-shot at the
    fleet's count of resolved requests) and ``slow_link`` (a delay for
    each of its first ``chunks`` chunks to that machine only)."""
    fi = FaultInjector()
    if plan == "kill_process":
        assert fi.kill_process("p", after_requests=3) is fi
        assert not fi.should_kill_process("p", 2)
        assert fi.should_kill_process("p", 3)
        assert not fi.should_kill_process("p", 4)  # one-shot
        assert fi.injected["process_kill"] == 1
    elif plan == "kill_machine":
        assert fi.kill_machine("m", after_results=3) is fi
        assert not fi.should_kill_machine("m", 2)
        assert not fi.should_kill_machine("other", 9)
        assert fi.should_kill_machine("m", 3)
        assert not fi.should_kill_machine("m", 4)  # one-shot
        assert fi.injected["machine_kill"] == 1
    else:
        assert fi.slow_link("m", 1.0, chunks=2) is fi
        assert fi.link_delay("other") == 0.0
        assert [fi.link_delay("m") for _ in range(3)] == [1.0, 1.0, 0.0]
        assert fi.injected["slow_link"] == 2

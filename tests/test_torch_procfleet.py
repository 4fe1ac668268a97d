"""The port's process fleet (``parallel/procfleet.py``,
``parallel/replica.py``) on the CPU, with real child processes: the cases
of ``tests/test_procfleet.py`` run against the port (replicas are real OS
processes; results equal to direct whichever process answers; request ids
are idempotent; a SIGKILL under traffic drops nothing and resolves every
request once, the slot respawns with no build and no library load after
its warmup; a stale death verdict is a no-op; hedging rescues a real
straggler; the death and respawn counters carry the pid), and the port's
own: the child imports neither jax nor the JAX package, a child told
``--device cuda`` without a card exits non-zero and the router names the
exit code, a SIGTERM drains and leaves a tombstone, the registry snapshot
holds no torch object.

Discipline: every wait has its own timeout, fixtures stop their fleets
(and so their children), one module-scoped fleet serves most cases, and
the children run with ``OMP_NUM_THREADS=1`` from the fixture's
environment.
"""

import os
import pickletools
import signal
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.decomposition import PCA
from dask_ml_tpu_torch.linear_model import LogisticRegression
from dask_ml_tpu_torch.parallel import framing, telemetry
from dask_ml_tpu_torch.parallel import shm as shm_lib
from dask_ml_tpu_torch.parallel.elastic import FileHeartbeat
from dask_ml_tpu_torch.parallel.fleet import FleetClient
from dask_ml_tpu_torch.parallel.launcher import LocalLauncher
from dask_ml_tpu_torch.parallel.procfleet import ProcessFleet, _PRequest
from dask_ml_tpu_torch.parallel.replica import (load_registry_snapshot,
                                                save_registry_snapshot)
from dask_ml_tpu_torch.parallel.serving import ServingStopped

RAGGED_SIZES = (1, 3, 31, 33, 100, 128)
WAIT = 120
GEMM_RTOL = 1e-5
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture(scope="module", autouse=True)
def one_thread_children():
    """Children inherit ``OMP_NUM_THREADS=1`` (set for this module only)."""
    prior = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    yield
    if prior is None:
        os.environ.pop("OMP_NUM_THREADS", None)
    else:
        os.environ["OMP_NUM_THREADS"] = prior


def _data(n=512, d=8, seed=0):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def until(cond, timeout=60.0, what="condition"):
    end = time.monotonic() + timeout
    while not cond():
        if time.monotonic() > end:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)


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
            "pca": PCA(n_components=3, random_state=0).fit(X),
        }


def _fleet(fitted, name, models=("kmeans", "logistic", "pca"), **kw):
    kw.setdefault("request_timeout_s", WAIT)
    fleet = ProcessFleet(n_replicas=2, device="cpu", max_batch_rows=256,
                         name=name, **kw)
    for m in models:
        fleet.register(m, fitted[m])
    return fleet


@pytest.fixture(scope="module")
def pfleet(fitted, one_thread_children):
    fleet = _fleet(fitted, "tpf")
    fleet.start()
    try:
        yield fleet
    finally:
        fleet.stop(timeout=30)


def _segments_of(fleet):
    return [r["segment"] for r in fleet.stats()["replicas"].values()
            if r["segment"] is not None]


# ---------------------------------------------------------------------------
# the liveness primitive and the snapshot
# ---------------------------------------------------------------------------


def test_file_heartbeat_primitive(tmp_path):
    live = FileHeartbeat(str(tmp_path))
    assert live.age("r0") is None
    live.beat("r0")
    age = live.age("r0")
    assert age is not None and age < 5.0
    assert not live.has_tombstone("r0")
    live.tombstone("r0")
    assert live.has_tombstone("r0")
    live.clear("r0")
    assert live.age("r0") is None and not live.has_tombstone("r0")


class _TensorModel:
    """A host model holding tensors, a torch dtype and a torch device."""

    n_features_in_ = 3

    def __init__(self):
        self.w = torch.arange(6, dtype=torch.float32).reshape(3, 2)
        self.h = torch.tensor([1.5, -2.0], dtype=torch.bfloat16)
        self.dtype = torch.float32
        self.where = torch.device("cpu")

    def predict(self, X):
        return np.asarray(X, np.float32) @ self.w.numpy()


def test_registry_snapshot_holds_no_torch_object(tmp_path, fitted):
    """Tensors are pickled as numpy arrays (bf16 as its bits), dtypes and
    devices by name: the snapshot's pickle names no torch global, and
    loads back into tensors on the device asked for."""
    path = str(tmp_path / "reg.reg")
    save_registry_snapshot(path, [("t", _TensorModel(), None),
                                  ("km", fitted["kmeans"], ["predict"])])
    data = open(path, "rb").read()
    body = framing.decode_frame(data, magic=b"DMLTFREG1\n")
    names = [arg for _op, arg, _pos in pickletools.genops(body)
             if isinstance(arg, str)]
    assert "dask_ml_tpu_torch.parallel.replica" in names
    assert not [n for n in names
                if n == "torch" or n.startswith(("torch.", "torch "))]
    models = load_registry_snapshot(path, device=torch.device("cpu"))
    (name, est, methods), (name2, km, methods2) = models
    assert name == "t" and methods is None and methods2 == ["predict"]
    assert isinstance(est.w, torch.Tensor) and est.w.device.type == "cpu"
    assert torch.equal(est.w, _TensorModel().w)
    assert est.h.dtype == torch.bfloat16
    assert torch.equal(est.h, _TensorModel().h)
    assert est.dtype is torch.float32 and est.where == torch.device("cpu")
    assert np.array_equal(km.cluster_centers_,
                          fitted["kmeans"].cluster_centers_)
    # a torn snapshot fails its frame, never unpickles noise
    with open(path, "wb") as f:
        f.write(data[:-3])
    with pytest.raises(framing.FrameError):
        load_registry_snapshot(path)


# ---------------------------------------------------------------------------
# process isolation and identity
# ---------------------------------------------------------------------------


def test_replicas_are_real_processes(pfleet):
    pids = {rep.pid for rep in pfleet._procs}
    assert len(pids) == 2 and os.getpid() not in pids
    for pid in pids:
        os.kill(pid, 0)  # alive
    remote = pfleet.remote_stats()
    assert set(remote) == {"tpf-p0", "tpf-p1"}
    for name, st in remote.items():
        assert st["pid"] in pids
        assert st["device"] == "cpu" and st["device_name"] == "cpu"
        assert st["n_builds"] == 0  # the router built the host library
        assert st["steady_compiles"] == 0
        assert st["steady_builds"] == 0 and st["steady_loads"] == 0
        assert st["steady_launches"] == {}  # the CPU launches no kernel
        assert set(st["phases"]) == {"import_s", "cuda_init_s",
                                     "snapshot_s", "warmup_s", "load_s"}
    st = pfleet.stats()
    for rep in st["replicas"].values():
        assert rep["start_s"] > 0 and rep["warmup"]["n_programs"] > 0


@pytest.mark.parametrize("name,method", [
    ("kmeans", "predict"),
    ("logistic", "predict_proba"),
    ("pca", "transform"),
])
def test_results_equal_direct_across_processes(pfleet, fitted, name,
                                               method):
    X = fitted["X"]
    direct = getattr(fitted[name], method)
    futs = [(n, pfleet.submit(name, X[:n], method=method))
            for n in RAGGED_SIZES * 2]
    for n, fut in futs:
        got, want = fut.result(WAIT), direct(X[:n])
        assert got.dtype == want.dtype and got.shape == want.shape
        if name == "kmeans":
            assert np.array_equal(got, want), n
        else:
            scale = max(float(np.abs(want).max()), 1.0)
            assert float(np.abs(got.astype(np.float64) - want).max()) \
                <= GEMM_RTOL * scale, n


def test_latency_history_resets_and_links_name_their_segments(pfleet,
                                                               fitted):
    """reset_latency_history() clears every replica's routing EWMA; the
    stats name each router link's ring segment."""
    for _ in range(4):
        pfleet.call("kmeans", fitted["X"][:8], timeout=WAIT)
    st = pfleet.stats()["replicas"]
    assert any(r["latency_ewma_s"] > 0 for r in st.values())
    pfleet.reset_latency_history()
    st = pfleet.stats()["replicas"]
    assert all(r["latency_ewma_s"] == 0 for r in st.values())
    assert pfleet.signals()["p99_s"] == 0.0
    segs = [r["segment"] for r in st.values() if not r["dead"]]
    assert segs and all(s and s.startswith(shm_lib.SEGMENT_PREFIX)
                        for s in segs)
    assert set(segs) <= set(shm_lib.list_segments())


def test_replica_counts_launches_from_the_end_of_its_warmup(tmp_path):
    """The stats extras report every launch since the process started
    and, apart, those since the warmup ended (traffic only)."""
    from dask_ml_tpu_torch import _kernels
    from dask_ml_tpu_torch.parallel import replica

    host = replica.ReplicaHost("r0", str(tmp_path / "s.reg"),
                               str(tmp_path), device="cpu")
    saved = dict(_kernels.launches)
    try:
        _kernels.reset_launches()
        for _ in range(3):  # the warmup's launches
            _kernels.count("fused_argmin_min")
        host._warm_launches = replica._launches_now()
        st = host._extra_stats()
        assert st["launches"] == {"fused_argmin_min": 3}
        assert st["steady_launches"] == {}
        _kernels.count("fused_argmin_min")
        _kernels.count("fused_argmin_min_sketched")
        st = host._extra_stats()
        assert st["launches"] == {"fused_argmin_min": 4,
                                  "fused_argmin_min_sketched": 1}
        assert st["steady_launches"] == {"fused_argmin_min": 1,
                                         "fused_argmin_min_sketched": 1}
    finally:
        with _kernels._launches_lock:
            _kernels.launches.update(saved)


def test_request_id_idempotent(pfleet, fitted):
    from concurrent.futures import Future

    freq = _PRequest(rid="rid-Z", model="kmeans", method="predict",
                     X=fitted["X"][:4], priority=0, deadline_abs=None,
                     future=Future())
    with pfleet._lock:
        pfleet._inflight["rid-Z"] = freq
    try:
        f2 = pfleet.submit("kmeans", fitted["X"][:4], request_id="rid-Z")
        assert f2 is freq.future
    finally:
        with pfleet._lock:
            pfleet._inflight.pop("rid-Z", None)
    out = pfleet.submit("kmeans", fitted["X"][:4],
                        request_id="rid-fresh").result(WAIT)
    assert np.array_equal(out, fitted["kmeans"].predict(fitted["X"][:4]))


# ---------------------------------------------------------------------------
# kill -9 under traffic: replay, respawn, nothing built or loaded after
# ---------------------------------------------------------------------------


def test_sigkill_respawn_zero_drops(pfleet, fitted):
    X = fitted["X"]
    km = fitted["kmeans"]
    victim = pfleet._procs[0]
    old_pid, old_proc = victim.pid, victim.proc
    results_before = pfleet.n_results
    futs = [(i, pfleet.submit("kmeans", X[i:i + 8])) for i in range(30)]
    os.kill(old_pid, signal.SIGKILL)
    for i, fut in futs:
        assert np.array_equal(fut.result(WAIT), km.predict(X[i:i + 8])), i
    # 30 futures, 30 first resolutions: a replay may compute twice but
    # resolves once
    assert pfleet.n_results - results_before == 30
    assert pfleet.n_replica_deaths >= 1
    old_proc.wait(30)
    assert old_proc.returncode == -signal.SIGKILL
    until(lambda: pfleet.replicas_up() == 2, WAIT, "the respawn")
    assert pfleet.n_respawns >= 1
    assert victim.pid != old_pid
    assert [old_pid, -signal.SIGKILL] in \
        pfleet.stats()["replicas"][victim.name]["past_exits"]
    for i in range(20):
        out = pfleet.call("kmeans", X[i:i + 8], timeout=WAIT)
        assert np.array_equal(out, km.predict(X[i:i + 8]))
    remote = pfleet.remote_stats()
    assert len(remote) == 2
    for name, st in remote.items():
        assert st["steady_compiles"] == 0, (name, st)
        assert st["n_builds"] == 0, (name, st)
    assert victim.pid in {st["pid"] for st in remote.values()}


def test_stale_death_verdict_is_a_noop(pfleet):
    rep = next(r for r in pfleet._procs if not r.dead and not r.retired)
    deaths_before = pfleet.n_replica_deaths
    up_before = pfleet.replicas_up()
    pfleet._declare_dead(rep, "heartbeat stale 9.99s", gen=rep.gen - 1)
    assert not rep.dead and not rep.retired
    assert rep.proc.poll() is None
    assert pfleet.n_replica_deaths == deaths_before
    assert pfleet.replicas_up() == up_before


def test_scale_up_then_drain_slot_retires_with_a_tombstone(pfleet, fitted):
    """scale_up adds a warmed slot; drain_slot retires it by SIGTERM: it
    answers its queue, leaves a tombstone and exits 0; no death, no
    respawn."""
    deaths, respawns = pfleet.n_replica_deaths, pfleet.n_respawns
    (new,) = pfleet.scale_up(1)
    assert pfleet.replicas_up() == 3
    rep = next(r for r in pfleet._procs if r.name == new)
    assert pfleet.drain_slot(new) == new
    until(lambda: rep.retired, WAIT, "the retirement")
    assert rep.proc.wait(30) == 0
    assert pfleet._live.has_tombstone(new)
    assert pfleet.n_drains == 1
    assert (pfleet.n_replica_deaths, pfleet.n_respawns) == (deaths,
                                                            respawns)
    assert pfleet.replicas_up() == 2
    out = pfleet.call("kmeans", fitted["X"][:5], timeout=WAIT)
    assert np.array_equal(out, fitted["kmeans"].predict(fitted["X"][:5]))


# ---------------------------------------------------------------------------
# hedging, the kill plan, the counters and their mirrors
# ---------------------------------------------------------------------------


def _total(counters, prefix):
    return sum(v for k, v in counters.items()
               if k == prefix or k.startswith(prefix + "{"))


def test_hedging_rescues_straggler_and_mirrors_exactly(fitted):
    X = fitted["X"]
    km = fitted["kmeans"]
    telemetry.reset_telemetry()
    try:
        with config_context(telemetry=True):
            fleet = _fleet(fitted, "thf", models=("kmeans",),
                           straggle={0: (0.3, 3)}, hedge_min_s=0.02)
            fleet.start()
            try:
                segments = _segments_of(fleet)
                lats = []
                for i in range(36):
                    t0 = time.perf_counter()
                    out = fleet.call("kmeans", X[i:i + 8], timeout=WAIT)
                    lats.append(time.perf_counter() - t0)
                    assert np.array_equal(out, km.predict(X[i:i + 8])), i
                assert fleet.n_hedged >= 1 and fleet.n_hedge_wins >= 1
                assert max(lats) < 2 * 0.3  # no request paid it twice
                stats = fleet.stats()
            finally:
                fleet.stop(timeout=30)
            counters = telemetry.metrics().snapshot()["counters"]
        assert _total(counters, "serving.hedged") == stats["hedged"]
        assert _total(counters, "serving.hedge_wins") == stats["hedge_wins"]
        assert _total(counters, "fleet.reroutes") == stats["reroutes"]
        assert _total(counters, "fleet.replica_deaths") == 0
        assert any(k.startswith("serving.hedged{") and "replica=" in k
                   for k in counters)
        assert segments and not set(segments) & set(
            shm_lib.list_segments())
        assert all(r.proc.returncode == 0 for r in fleet._procs)
    finally:
        telemetry.reset_telemetry()


def test_kill_plan_death_and_respawn_counters_carry_pid(fitted):
    """The ``kill_process`` plan: slot 1 SIGKILLs itself after 3 served
    requests; every request still resolves once, equal to direct; the
    death and respawn counters carry the pids; the killed incarnation
    exits -9, every other process 0 at stop; no segment is left."""
    X = fitted["X"]
    km = fitted["kmeans"]
    telemetry.reset_telemetry()
    try:
        with config_context(telemetry=True):
            fleet = _fleet(fitted, "tdf", models=("kmeans",), hedge=False,
                           kill_after_requests={1: 3})
            fleet.start()
            try:
                old_pid = fleet._procs[1].pid
                futs = [(i, fleet.submit("kmeans", X[i:i + 4]))
                        for i in range(40)]
                for i, fut in futs:
                    assert np.array_equal(fut.result(WAIT),
                                          km.predict(X[i:i + 4])), i
                until(lambda: fleet.n_respawns >= 1, WAIT, "the respawn")
                new_pid = fleet._procs[1].pid
                assert fleet.n_respawns == 1 and fleet.n_replica_deaths == 1
                assert fleet.n_results == 40
                segments = _segments_of(fleet)
                stats = fleet.stats()
            finally:
                fleet.stop(timeout=30)
            counters = telemetry.metrics().snapshot()["counters"]
        assert counters[
            f"fleet.replica_deaths{{pid={old_pid},replica=tdf-p1}}"] == 1
        respawn_keys = [k for k in counters
                        if k.startswith("fleet.respawns")]
        assert len(respawn_keys) == 1 and str(new_pid) in respawn_keys[0]
        assert counters[respawn_keys[0]] == stats["respawns"] == 1
        assert stats["replicas"]["tdf-p1"]["past_exits"] == [
            [old_pid, -signal.SIGKILL]]
        assert [r.proc.returncode for r in fleet._procs] == [0, 0]
        assert not set(segments) & set(shm_lib.list_segments())
    finally:
        telemetry.reset_telemetry()


# ---------------------------------------------------------------------------
# the child process: jax-free, drains on SIGTERM, refuses a missing card
# ---------------------------------------------------------------------------


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    env["OMP_NUM_THREADS"] = "1"
    return env


def test_replica_child_is_jax_free_and_drains_on_sigterm(tmp_path, fitted):
    """The replica entry point in a subprocess under ``-X importtime``:
    it serves a request equal to direct, drains on SIGTERM (exit 0, a
    tombstone), and no module of jax or of the JAX package was imported
    in it, at any point of its life."""
    snap = str(tmp_path / "reg.reg")
    save_registry_snapshot(snap, [("kmeans", fitted["kmeans"], None)])
    log = open(tmp_path / "child.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-X", "importtime", "-m",
         "dask_ml_tpu_torch.parallel.replica", "--name", "solo",
         "--snapshot", snap, "--workdir", str(tmp_path), "--device", "cpu",
         "--max-batch-rows", "64"],
        stdout=log, stderr=subprocess.STDOUT, env=_child_env(), cwd=ROOT)
    try:
        addr = tmp_path / "solo.addr.json"
        until(lambda: addr.exists() or proc.poll() is not None, WAIT,
              "the child's address file")
        assert proc.poll() is None, (tmp_path / "child.log").read_text()
        import json

        info = json.loads(addr.read_text())
        assert info["pid"] == proc.pid and info["device"] == "cpu"
        with FleetClient((info["host"], info["port"])) as cli:
            out = cli.call("kmeans", fitted["X"][:9], timeout=WAIT)
            st = cli.stats()
        assert np.array_equal(out, fitted["kmeans"].predict(fitted["X"][:9]))
        assert st["pid"] == proc.pid and st["steady_compiles"] == 0
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(60) == 0
        assert FileHeartbeat(str(tmp_path)).has_tombstone("solo")
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(30)
        log.close()
    text = (tmp_path / "child.log").read_text()
    imported = [line.rsplit("|", 1)[-1].strip() for line in text.splitlines()
                if line.startswith("import time:")]
    assert "dask_ml_tpu_torch.parallel.replica" in imported
    assert "torch" in imported
    bad = [m for m in imported
           if m.split(".")[0] in ("jax", "jaxlib", "dask_ml_tpu")]
    assert not bad, bad


def test_child_told_cuda_without_a_card_exits_nonzero(tmp_path, fitted):
    """``--device cuda`` on a machine with no card: the child exits
    non-zero with the error in its log; it never serves on the CPU."""
    snap = str(tmp_path / "reg.reg")
    save_registry_snapshot(snap, [("kmeans", fitted["kmeans"], None)])
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with open(tmp_path / "child.log", "wb") as log:
        proc = subprocess.run(
            [sys.executable, "-m", "dask_ml_tpu_torch.parallel.replica",
             "--name", "nocard", "--snapshot", snap, "--workdir",
             str(tmp_path), "--device", "cuda"],
            stdout=log, stderr=subprocess.STDOUT, env=_child_env(),
            cwd=ROOT, timeout=WAIT)
    assert proc.returncode != 0
    assert "torch.cuda.is_available() is False" in \
        (tmp_path / "child.log").read_text()
    assert not (tmp_path / "nocard.addr.json").exists()


class _ForceCuda(LocalLauncher):
    """Spawns each child told ``--device cuda`` (the router itself was
    told the CPU, so no card is needed to get this far)."""

    def spawn(self, machine, argv, *, env, log_path=None):
        argv = list(argv)
        argv[argv.index("--device") + 1] = "cuda"
        return super().spawn(machine, argv, env=env, log_path=log_path)


def test_router_start_names_the_exit_code(fitted):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    fleet = _fleet(fitted, "tnc", models=("kmeans",),
                   launcher=_ForceCuda(), spawn_timeout_s=WAIT)
    with pytest.raises(ServingStopped, match="exited with 1"):
        fleet.start()
    assert all(r.proc.poll() is not None for r in fleet._procs)


def test_router_refuses_cuda_without_a_card(fitted):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    fleet = ProcessFleet(n_replicas=1, name="tnd")
    fleet.register("kmeans", fitted["kmeans"])
    with pytest.raises(RuntimeError, match="device_count"):
        fleet.start()
    assert fleet._procs[0].proc is None


# ---------------------------------------------------------------------------
# the full drill (slow tier)
# ---------------------------------------------------------------------------


@pytest.mark.slow
def test_full_process_kill_drill_all_gates(fitted):
    """The whole drill at three replicas: closed-loop traffic with one
    replica SIGKILLed by its plan, a hedging A/B under a straggler, the
    respawn, SIGTERM everywhere, no segment left."""
    X = fitted["X"]
    km = fitted["kmeans"]
    fleet = ProcessFleet(n_replicas=3, device="cpu", max_batch_rows=256,
                         name="tfd", request_timeout_s=WAIT,
                         kill_after_requests={2: 25})
    fleet.register("kmeans", km)
    fleet.start()
    try:
        futs = [(i, fleet.submit("kmeans", X[i % 500:i % 500 + 8]))
                for i in range(300)]
        for i, fut in futs:
            assert np.array_equal(fut.result(WAIT),
                                  km.predict(X[i % 500:i % 500 + 8]))
        until(lambda: fleet.n_respawns >= 1, WAIT, "the respawn")
        assert fleet.n_results == 300
        segments = _segments_of(fleet)
        for st in fleet.remote_stats().values():
            assert st["steady_compiles"] == 0
    finally:
        fleet.stop(timeout=30)
    assert not set(segments) & set(shm_lib.list_segments())
    p99 = {}
    for hedge in (False, True):
        f = ProcessFleet(n_replicas=2, device="cpu", max_batch_rows=256,
                         name=f"tfh{int(hedge)}", hedge=hedge,
                         hedge_min_s=0.02, straggle={0: (0.2, 4)},
                         request_timeout_s=WAIT)
        f.register("kmeans", km)
        f.start()
        try:
            lats = []
            for i in range(60):
                t0 = time.perf_counter()
                f.call("kmeans", X[i:i + 8], timeout=WAIT)
                lats.append(time.perf_counter() - t0)
            p99[hedge] = float(np.percentile(lats, 99))
        finally:
            f.stop(timeout=30)
    assert p99[True] < p99[False], p99

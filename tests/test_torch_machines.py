"""The port's cross-machine tier on the CPU: the launchers and placement
(``parallel/launcher.py``), the SLO autoscaler's control law
(``parallel/autoscaler.py``) and the multi-machine
:class:`~dask_ml_tpu_torch.parallel.procfleet.ProcessFleet`, as in
``tests/test_machines.py``. "Machines" are isolated workdirs with their own
OS processes on loopback, which drives every seam (placement, snapshot
distribution, machine-death detection, replay, respawn elsewhere) on one
box. Placement and the autoscaler are also held to the JAX package's:
the same plans for the same rosters, the same actions for the same
``tick(now=)`` sequences.
"""

import os
import subprocess
import sys
import time

import numpy as np
import pytest

from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch.parallel.autoscaler import SLO, Autoscaler
from dask_ml_tpu_torch.parallel.faults import FaultInjector
from dask_ml_tpu_torch.parallel.launcher import (
    ExecLauncher,
    LocalLauncher,
    MachineSpec,
    plan_placement,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WAIT = 120


# ---------------------------------------------------------------------------
# placement
# ---------------------------------------------------------------------------


def _roster(tmp_path, *rows):
    return [MachineSpec(name=n, workdir=str(tmp_path / n), devices=d)
            for n, d in rows]


def test_placement_round_robins_equal_machines(tmp_path):
    machines = _roster(tmp_path, ("m0", 0), ("m1", 0))
    plan = plan_placement(4, machines)
    counts = {m.name: sum(1 for p in plan if p is m) for m in machines}
    assert counts == {"m0": 2, "m1": 2}
    # and slots alternate rather than clumping
    assert [p.name for p in plan[:2]] in (["m0", "m1"], ["m1", "m0"])


def test_placement_weights_by_device_inventory(tmp_path):
    machines = _roster(tmp_path, ("big", 4), ("small", 2))
    plan = plan_placement(6, machines)
    counts = {m.name: sum(1 for p in plan if p is m) for m in machines}
    # a 4-chip machine takes twice the slots of a 2-chip one
    assert counts == {"big": 4, "small": 2}


def test_placement_seeds_existing_loads(tmp_path):
    machines = _roster(tmp_path, ("m0", 0), ("m1", 0))
    plan = plan_placement(2, machines, loads={"m0": 5})
    assert [p.name for p in plan] == ["m1", "m1"]


def test_placement_rejects_empty_roster():
    with pytest.raises(ValueError):
        plan_placement(2, [])


# ---------------------------------------------------------------------------
# launchers
# ---------------------------------------------------------------------------


def test_local_launcher_runs_in_machine_workdir(tmp_path):
    m = MachineSpec(name="loc", workdir=str(tmp_path / "wd"))
    proc = LocalLauncher().spawn(
        m, [sys.executable, "-c", "open('here.txt', 'w').write('y')"],
        env=dict(os.environ))
    assert proc.wait(30) == 0
    assert (tmp_path / "wd" / "here.txt").read_text() == "y"


def test_exec_launcher_formats_template_and_forwards_env(tmp_path):
    m = MachineSpec(name="mx", workdir=str(tmp_path / "wd"),
                    host="127.0.0.9")
    launcher = ExecLauncher(
        ["sh", "-c", "echo {machine} {host} > seen.txt; exec {cmd}"],
        env_forward=("DMLT_LAUNCH_TEST",))
    env = dict(os.environ)
    env["DMLT_LAUNCH_TEST"] = "forwarded through the template"
    proc = launcher.spawn(
        m, [sys.executable, "-c",
            "import os; open('out.txt', 'w')"
            ".write(os.environ['DMLT_LAUNCH_TEST'])"],
        env=env, log_path=str(tmp_path / "wd.log"))
    assert proc.wait(30) == 0
    # {machine}/{host} substituted from the roster row; cwd = workdir
    assert (tmp_path / "wd" / "seen.txt").read_text().split() \
        == ["mx", "127.0.0.9"]
    # the env prefix carried the var THROUGH the exec template (an ssh
    # hop would not inherit the kernel-injected env)
    assert (tmp_path / "wd" / "out.txt").read_text() \
        == "forwarded through the template"


def test_exec_launcher_machine_env_overrides(tmp_path):
    m = MachineSpec(name="me", workdir=str(tmp_path / "wd"),
                    env={"DMLT_LAUNCH_TEST": "machine wins"})
    launcher = ExecLauncher(["sh", "-c", "exec {cmd}"],
                            env_forward=("DMLT_LAUNCH_TEST",))
    env = dict(os.environ)
    env["DMLT_LAUNCH_TEST"] = "router value"
    proc = launcher.spawn(
        m, [sys.executable, "-c",
            "import os; open('out.txt', 'w')"
            ".write(os.environ['DMLT_LAUNCH_TEST'])"], env=env)
    assert proc.wait(30) == 0
    assert (tmp_path / "wd" / "out.txt").read_text() == "machine wins"


def test_exec_launcher_rejects_empty_template():
    with pytest.raises(ValueError):
        ExecLauncher([])


# ---------------------------------------------------------------------------
# parity: the JAX package's placement for the same rosters
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("rows,n,loads", [
    ((("a", 0), ("b", 0), ("c", 0)), 7, None),
    ((("a", 8), ("b", 2), ("c", 1)), 11, None),
    ((("a", 4), ("b", 4)), 5, {"a": 3}),
    ((("solo", 1),), 3, {"solo": 2}),
])
def test_placement_equals_the_jax_package(tmp_path, rows, n, loads):
    from dask_ml_tpu.parallel import launcher as jax_launcher

    port = plan_placement(n, _roster(tmp_path, *rows), loads=loads)
    jax = jax_launcher.plan_placement(
        n, [jax_launcher.MachineSpec(name=r, workdir=str(tmp_path / r),
                                     devices=d) for r, d in rows],
        loads=loads)
    assert [m.name for m in port] == [m.name for m in jax]


def test_exec_launcher_forwards_the_port_variables():
    assert set(ExecLauncher(["sh", "-c", "exec {cmd}"]).env_forward) == {
        "PYTHONPATH", "CUDA_VISIBLE_DEVICES", "OMP_NUM_THREADS"}


# ---------------------------------------------------------------------------
# one box through a command template
# ---------------------------------------------------------------------------


def test_process_fleet_through_an_exec_launcher(tmp_path):
    """The spawn hook is pluggable on one box too: a fleet whose child
    starts through ``sh -c "exec {cmd}"`` serves equal to direct and
    drains to exit 0."""
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.parallel.procfleet import ProcessFleet

    X = np.random.RandomState(0).randn(200, 6).astype(np.float32)
    with config_context(device="cpu"):
        km = KMeans(n_clusters=3, random_state=0, max_iter=5).fit(X)
        want = km.predict(X[:20])
    prior = os.environ.get("OMP_NUM_THREADS")
    os.environ["OMP_NUM_THREADS"] = "1"
    try:
        fleet = ProcessFleet(
            n_replicas=1, device="cpu", max_batch_rows=64, name="tex",
            workdir=str(tmp_path / "wd"), request_timeout_s=WAIT,
            launcher=ExecLauncher(["sh", "-c", "exec {cmd}"]))
        fleet.register("km", km)
        fleet.start()
        try:
            assert np.array_equal(fleet.call("km", X[:20], timeout=WAIT),
                                  want)
        finally:
            fleet.stop(timeout=30)
    finally:
        if prior is None:
            os.environ.pop("OMP_NUM_THREADS", None)
        else:
            os.environ["OMP_NUM_THREADS"] = prior
    assert fleet._procs[0].proc.returncode == 0


# ---------------------------------------------------------------------------
# the cross-machine surface: what it refuses
# ---------------------------------------------------------------------------


def test_process_fleet_machines_roster_raises(tmp_path):
    """A roster is taken; one whose machine names repeat is refused at
    start(), before anything is spawned."""
    from dask_ml_tpu_torch.parallel.procfleet import ProcessFleet

    fleet = ProcessFleet(machines=_roster(tmp_path, ("m0", 1), ("m0", 1)),
                         device="cpu", workdir=str(tmp_path / "router"))
    fleet.register("m", object())
    with pytest.raises(ValueError, match="unique"):
        fleet.start()
    assert fleet._procs == []


@pytest.mark.parametrize("plan,args,bad", [
    ("kill_machine", ("m0",), {"after_results": "soon"}),
    ("slow_link", ("m0", 0.5), {"chunks": "some"})])
def test_machine_fault_plans_raise(plan, args, bad):
    """The machine plans are armed (chainable, as every plan is) and refuse
    a malformed count."""
    inj = FaultInjector()
    assert getattr(inj, plan)(*args) is inj
    with pytest.raises(ValueError):
        getattr(FaultInjector(), plan)(*args, **bad)


def test_replica_snapshot_server_raises(tmp_path):
    """A replica told to fetch from a snapshot server nobody listens on
    fails with the transfer error after its retries, in process and as a
    CLI child (exit code non-zero): it never serves a registry it does not
    have."""
    from dask_ml_tpu_torch.parallel.replica import ReplicaHost
    from dask_ml_tpu_torch.parallel.snapshots import SnapshotTransferError

    host = ReplicaHost("r0", str(tmp_path / "s.reg"), str(tmp_path),
                       device="cpu", snapshot_server="127.0.0.1:1",
                       machine="m0")
    with pytest.raises(SnapshotTransferError):
        host.run()
    assert not os.path.exists(tmp_path / "s.reg")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "dask_ml_tpu_torch.parallel.replica",
         "--name", "r0", "--snapshot", str(tmp_path / "s.reg"),
         "--workdir", str(tmp_path), "--device", "cpu",
         "--snapshot-server", "127.0.0.1:1", "--machine", "m0"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=WAIT)
    assert proc.returncode != 0
    assert "SnapshotTransferError" in proc.stderr


# ---------------------------------------------------------------------------
# the autoscaler's control law, tick by tick, against the JAX package's
# ---------------------------------------------------------------------------


class FakeFleet:
    """The signals() / scale_up() / drain_slot() contract, and nothing
    else."""

    def __init__(self, replicas=2):
        self.replicas = replicas
        self.sig = {"p99_s": 0.0, "queue_depth": 0.0, "shed_total": 0.0}
        self.n_up_calls = 0
        self.n_down_calls = 0

    def signals(self):
        return {**self.sig, "replicas_up": self.replicas}

    def scale_up(self, k):
        self.replicas += int(k)
        self.n_up_calls += 1
        return [f"fake-p{self.replicas}"]

    def drain_slot(self):
        if self.replicas <= 1:
            return None
        self.replicas -= 1
        self.n_down_calls += 1
        return f"fake-p{self.replicas}"


def _scaler(cls, slo_cls, fleet, **kw):
    kw.setdefault("slo", slo_cls(target_p99_s=0.1, max_queue_depth=4.0,
                                 max_shed_per_s=0.0))
    kw.setdefault("breach_ticks", 2)
    kw.setdefault("quiet_ticks", 3)
    kw.setdefault("scale_up_cooldown_s", 1.0)
    kw.setdefault("scale_down_cooldown_s", 5.0)
    kw.setdefault("max_replicas", 4)
    slo = kw.pop("slo")
    return cls(fleet, slo, **kw)


def _both(scenario):
    """Run ``scenario(Autoscaler, SLO)`` with the port's classes (its own
    assertions hold the port) and with the JAX package's; the two runs must
    record the same actions, decisions, counts and fleet sizes."""
    from dask_ml_tpu.parallel import autoscaler as jax_autoscaler

    port = scenario(Autoscaler, SLO)
    jax = scenario(jax_autoscaler.Autoscaler, jax_autoscaler.SLO)
    assert port == jax
    return port


def _record(sc, fleet, acts):
    return {"acts": acts, "replicas": fleet.replicas,
            "up_calls": fleet.n_up_calls, "down_calls": fleet.n_down_calls,
            "stats": sc.stats(),
            "decisions": [(d["action"], d["t"], d["replicas"], d["reason"],
                           d["shed_rate"]) for d in sc.decisions]}


def test_breach_needs_consecutive_ticks_then_scales_up():
    def scenario(cls, slo_cls):
        fleet = FakeFleet(replicas=2)
        sc = _scaler(cls, slo_cls, fleet)
        fleet.sig["p99_s"] = 0.5  # 5x the SLO
        acts = [sc.tick(now=0.00)]
        assert acts[0] is None  # streak 1: one slow tick is noise
        acts.append(sc.tick(now=0.25))
        assert acts[-1] == "scale_up"
        assert fleet.replicas == 3
        assert sc.n_scale_ups == 1 and sc.n_breaches == 2
        d = sc.decisions[-1]
        assert d["action"] == "scale_up" and "p99" in d["reason"]
        return _record(sc, fleet, acts)

    _both(scenario)


def test_spike_resets_breach_streak():
    def scenario(cls, slo_cls):
        fleet = FakeFleet(replicas=2)
        sc = _scaler(cls, slo_cls, fleet)
        acts = []
        for t, q in ((0.0, 100.0), (0.25, 0.0), (0.5, 100.0),
                     (0.75, 100.0)):
            fleet.sig["queue_depth"] = q
            acts.append(sc.tick(now=t))
        # the spike's streak reset: the action comes on the 2nd tick of
        # the second run, not the 1st
        assert acts == [None, None, None, "scale_up"]
        return _record(sc, fleet, acts)

    _both(scenario)


def test_scale_up_cooldown_spaces_actions():
    def scenario(cls, slo_cls):
        fleet = FakeFleet(replicas=1)
        sc = _scaler(cls, slo_cls, fleet)
        fleet.sig["p99_s"] = 0.5  # sustained breach
        acts = [sc.tick(now=t / 4) for t in range(16)]  # every 0.25 s
        ups = [t / 4 for t, a in zip(range(16), acts) if a == "scale_up"]
        assert len(ups) >= 2
        assert all(b - a >= sc.scale_up_cooldown_s
                   for a, b in zip(ups, ups[1:]))
        return _record(sc, fleet, acts)

    _both(scenario)


def test_max_replicas_bounds_scale_up():
    def scenario(cls, slo_cls):
        fleet = FakeFleet(replicas=2)
        sc = _scaler(cls, slo_cls, fleet, max_replicas=2)
        fleet.sig["p99_s"] = 0.5
        acts = [sc.tick(now=t * 0.25) for t in range(8)]
        assert acts == [None] * 8
        assert fleet.n_up_calls == 0  # a storm never forks past the bound
        return _record(sc, fleet, acts)

    _both(scenario)


def test_quiet_drains_down_to_min_replicas():
    def scenario(cls, slo_cls):
        fleet = FakeFleet(replicas=3)
        sc = _scaler(cls, slo_cls, fleet, min_replicas=2)
        # all-zero signals: quiet (below clear_fraction of every bound)
        acts = [sc.tick(now=float(t)) for t in range(12)]
        assert acts.count("scale_down") == 1  # 3 -> 2, then the floor
        assert fleet.replicas == 2 and fleet.n_down_calls == 1
        assert sc.decisions[-1]["action"] == "scale_down"
        return _record(sc, fleet, acts)

    _both(scenario)


def test_hysteresis_band_takes_no_action():
    def scenario(cls, slo_cls):
        fleet = FakeFleet(replicas=2)
        sc = _scaler(cls, slo_cls, fleet)
        # above clear_fraction (0.5 x 0.1 = 0.05), below the bound (0.1):
        # neither breaching nor quiet, so the scaler never flaps
        fleet.sig["p99_s"] = 0.08
        acts = [sc.tick(now=t * 0.25) for t in range(20)]
        assert acts == [None] * 20
        assert fleet.n_up_calls == 0 and fleet.n_down_calls == 0
        st = sc.stats()
        assert st["breach_streak"] == 0 and st["quiet_streak"] == 0
        return _record(sc, fleet, acts)

    _both(scenario)


def test_shed_rate_is_a_breach_signal():
    def scenario(cls, slo_cls):
        fleet = FakeFleet(replicas=1)
        slo = slo_cls(target_p99_s=float("inf"),
                      max_queue_depth=float("inf"), max_shed_per_s=1.0)
        sc = _scaler(cls, slo_cls, fleet, slo=slo)
        acts = [sc.tick(now=0.0)]  # no rate on the first observation
        fleet.sig["shed_total"] = 10.0  # 10 sheds over the next second
        acts.append(sc.tick(now=1.0))  # 10/s > 1/s: streak 1
        fleet.sig["shed_total"] = 20.0
        acts.append(sc.tick(now=2.0))
        assert acts == [None, None, "scale_up"]
        assert "shed" in sc.decisions[-1]["reason"]
        return _record(sc, fleet, acts)

    _both(scenario)


def test_autoscaler_validates_bounds():
    from dask_ml_tpu.parallel import autoscaler as jax_autoscaler

    for cls in (Autoscaler, jax_autoscaler.Autoscaler):
        with pytest.raises(ValueError):
            cls(FakeFleet(), min_replicas=0)
        with pytest.raises(ValueError):
            cls(FakeFleet(), min_replicas=3, max_replicas=2)


def test_autoscaler_counters_mirror_into_telemetry():
    """With the telemetry knob on, each action and breach adds to its
    counter at the increment site, and the gauge follows the fleet."""
    from dask_ml_tpu_torch.parallel import telemetry

    with config_context(telemetry=True):
        telemetry.reset_telemetry()
        fleet = FakeFleet(replicas=2)
        sc = _scaler(Autoscaler, SLO, fleet)
        fleet.sig["p99_s"] = 0.5
        sc.tick(now=0.0)
        assert sc.tick(now=0.25) == "scale_up"
        snap = telemetry.metrics().snapshot()
    assert snap["counters"]["autoscaler.scale_ups"] == 1
    assert snap["counters"]["autoscaler.breaches"] == 2
    assert snap["gauges"]["autoscaler.replicas"]["last"] == 3.0


# ---------------------------------------------------------------------------
# the two-machine fleet, end to end
# ---------------------------------------------------------------------------


def _fetch_stats(fleet):
    return {name: st["snapshot_fetch"]
            for name, st in fleet.stats()["replicas"].items()
            if st["snapshot_fetch"] is not None}


def test_two_machine_fleet_lifecycle(tmp_path):
    """The cross-machine story in one deterministic sequence: placement
    over two isolated machines, the registry shipped chunk by chunk with a
    chunk cache a machine (a scale-up on a warm machine ships no byte), a
    graceful drain, then a machine lost under traffic: no future dropped,
    the survivors take the replays, and the dead machine's slot respawns
    on the survivor from its cache."""
    from dask_ml_tpu_torch.cluster import KMeans
    from dask_ml_tpu_torch.parallel.procfleet import ProcessFleet

    rng = np.random.RandomState(0)
    X = rng.randn(256, 8).astype(np.float32)
    with config_context(device="cpu"):
        km = KMeans(n_clusters=4, random_state=0, max_iter=5).fit(X)
        direct = km.predict(X)

    inj = FaultInjector()
    machines = [
        MachineSpec(name=n, workdir=str(tmp_path / n),
                    env={"OMP_NUM_THREADS": "1"}) for n in ("m0", "m1")]
    # spawned through the command template: the ssh shape, pointed at sh
    fleet = ProcessFleet(
        n_replicas=2, device="cpu", max_batch_rows=256,
        request_timeout_s=WAIT, spawn_timeout_s=WAIT, name="tmf",
        workdir=str(tmp_path / "router"), machines=machines,
        fault_injector=inj,
        launcher=ExecLauncher(["sh", "-c", "exec {cmd}"]),
        snapshot_chunk_bytes=256)
    fleet.register("kmeans", km)
    fleet.start()
    try:
        # -- placement and the first distribution ----------------------
        st = fleet.stats()
        assert {m: len(row["replicas"])
                for m, row in st["machines"].items()} == {"m0": 1, "m1": 1}
        assert st["snapshot_server"] is not None
        assert st["snapshot_server"]["chunks"] > 0
        fetches = _fetch_stats(fleet)
        assert len(fetches) == 2
        full_bytes = next(iter(fetches.values()))["bytes_total"]
        for fs in fetches.values():  # each machine's first replica: cold
            assert fs["chunks_total"] >= 2
            assert fs["bytes_fetched"] == fs["bytes_total"] == full_bytes
        assert st["snapshot_server"]["bytes_sent"] == 2 * full_bytes

        # -- equal to direct on either machine ---------------------------
        assert np.array_equal(fleet.submit("kmeans", X).result(WAIT),
                              direct)

        # -- a scale-up reuses its machine's chunk cache -----------------
        (new_name,) = fleet.scale_up(1)
        st = fleet.stats()
        assert st["replicas_up"] == 3 and st["scale_ups"] == 1
        new_fetch = st["replicas"][new_name]["snapshot_fetch"]
        assert new_fetch["bytes_fetched"] == 0
        assert new_fetch["chunks_cached"] == new_fetch["chunks_total"]

        # -- a graceful drain: a tombstone, not a death -------------------
        assert fleet.drain_slot() == new_name  # the newest slot first
        deadline = time.monotonic() + 30.0
        while fleet.stats()["drains"] < 1:
            assert time.monotonic() < deadline, "the drain never retired"
            time.sleep(0.05)
        st = fleet.stats()
        assert st["replicas_up"] == 2
        assert st["replica_deaths"] == 0 and st["respawns"] == 0

        # -- a machine lost under traffic ----------------------------------
        futs = [fleet.submit("kmeans", X[: 32 + (i % 8)])
                for i in range(30)]
        inj.kill_machine("m1", after_results=0)
        for i, fut in enumerate(futs):
            n = 32 + (i % 8)
            assert np.array_equal(fut.result(WAIT), direct[:n]), i
        deadline = time.monotonic() + WAIT
        while fleet.stats()["respawns"] < 1:
            assert time.monotonic() < deadline, "no respawn after the kill"
            time.sleep(0.05)
        st = fleet.stats()
        assert st["machine_deaths"] == 1
        assert st["machines"]["m1"]["down"]
        assert inj.injected["machine_kill"] == 1
        # the dead machine's slot came back on the survivor, whose cache
        # held every chunk: the link carried no byte
        live = {name: row for name, row in st["replicas"].items()
                if not row["dead"] and not row["retired"]}
        assert len(live) == 2
        assert {row["machine"] for row in live.values()} == {"m0"}
        respawned = [row for row in live.values() if row["gen"] > 1]
        assert respawned and all(
            row["snapshot_fetch"]["bytes_fetched"] == 0
            for row in respawned)
        assert all(row["past_exits"][-1][1] == -9 for row in respawned)

        # -- the rejoined fleet: equal to direct, nothing built ------------
        assert np.array_equal(fleet.submit("kmeans", X).result(WAIT),
                              direct)
        for name, rst in fleet.remote_stats().items():
            assert rst["steady_compiles"] == 0, name
            assert rst["snapshot_fetch"] is not None, name
    finally:
        fleet.stop(timeout=30)
    # SIGTERM drained every incarnation still alive at stop(), and the
    # retired slot's drain too, to exit 0
    codes = {name: row["returncode"]
             for name, row in fleet.stats()["replicas"].items()}
    assert all(c == 0 for c in codes.values()), codes

"""The port's launchers and placement (``parallel/launcher.py``) on the
CPU: the placement and launcher cases of ``tests/test_machines.py`` run
against the port, the same plans as the JAX package's
``plan_placement`` for the same rosters, a process fleet spawned through a
command template on one box, and the cross-machine surface, which is
ROADMAP Queue A item 11c: ``ProcessFleet(machines=)``, ``kill_machine``,
``slow_link`` and the replica's ``--snapshot-server`` raise, naming it.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from dask_ml_tpu_torch import config_context
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
# the cross-machine surface raises, naming ROADMAP item 11c
# ---------------------------------------------------------------------------


def test_process_fleet_machines_roster_raises(tmp_path):
    from dask_ml_tpu_torch.parallel.procfleet import ProcessFleet

    with pytest.raises(NotImplementedError, match="item 11c"):
        ProcessFleet(machines=_roster(tmp_path, ("m0", 1), ("m1", 1)))


@pytest.mark.parametrize("plan,args", [("kill_machine", ("m0",)),
                                       ("slow_link", ("m0", 0.5))])
def test_machine_fault_plans_raise(plan, args):
    with pytest.raises(NotImplementedError, match="item 11c"):
        getattr(FaultInjector(), plan)(*args)


def test_replica_snapshot_server_raises(tmp_path):
    from dask_ml_tpu_torch.parallel.replica import ReplicaHost

    with pytest.raises(NotImplementedError, match="item 11c"):
        ReplicaHost("r0", str(tmp_path / "s.reg"), str(tmp_path),
                    device="cpu", snapshot_server="127.0.0.1:1")
    env = dict(os.environ)
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run(
        [sys.executable, "-m", "dask_ml_tpu_torch.parallel.replica",
         "--name", "r0", "--snapshot", str(tmp_path / "s.reg"),
         "--workdir", str(tmp_path), "--device", "cpu",
         "--snapshot-server", "127.0.0.1:1"],
        capture_output=True, text=True, env=env, cwd=ROOT, timeout=WAIT)
    assert proc.returncode != 0
    assert "item 11c" in proc.stderr

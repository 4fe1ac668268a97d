"""Spawn launchers and machine rosters for the process fleet (the
counterpart of ``dask_ml_tpu/parallel/launcher.py``).

- :class:`MachineSpec` is one row of a roster: a machine name, its
  coordination workdir and its device inventory (how many cards it owns),
  so placement weighs capacity.
- :class:`Launcher` is the spawn hook: ``spawn(machine, argv, env=,
  log_path=)`` returns a Popen-like handle with ``pid`` / ``poll()`` /
  ``terminate()`` / ``kill()`` / ``wait()``. :class:`LocalLauncher` execs
  the argv directly (the single-box default of
  :class:`~dask_ml_tpu_torch.parallel.procfleet.ProcessFleet`);
  :class:`ExecLauncher` formats a command template around the argv
  (``{cmd}`` is the shell-quoted replica command, ``{host}`` /
  ``{machine}`` / ``{workdir}`` come from the roster row), the shape of an
  SSH launcher: ``ExecLauncher(["ssh", "{host}", "cd {workdir} && exec
  {cmd}"])``.
- :func:`plan_placement` assigns replica slots to roster rows, least
  loaded first, weighted by device inventory.

The process fleet runs on one implicit local machine unless it is given a
``machines=`` roster, which places its replicas on those machines through
these launchers.
"""

from __future__ import annotations

import dataclasses
import os
import shlex
import subprocess
from typing import Optional

__all__ = [
    "MachineSpec",
    "Launcher",
    "LocalLauncher",
    "ExecLauncher",
    "plan_placement",
]


@dataclasses.dataclass(eq=False)
class MachineSpec:
    """One machine in the fleet roster.

    Parameters
    ----------
    name : str
        Roster-unique machine name — the label on machine-scoped
        telemetry (``fleet.machine_deaths{machine=}``) and the address
        of ``kill_machine``/``slow_link`` chaos plans.
    workdir : str
        The machine's coordination directory: its replicas' heartbeats,
        tombstones, address files, logs, and chunk cache live here. The
        ROUTER must be able to read it (same box in tests; a shared
        mount, or a future wire-forwarded variant, across real
        machines) — it is the per-machine half of the liveness fabric.
    devices : int
        Device inventory (accelerator count) for capacity-weighted
        placement; ``0`` means unknown — the machine weighs as 1 and
        replicas inherit the parent's device pinning policy.
    host : str
        Address handed to command templates (``{host}``) and, in a real
        deployment, where the replica's announced server binds.
    env : dict
        Extra environment for every replica spawned on this machine
        (merged over the router-computed child env).
    """

    name: str
    workdir: str
    devices: int = 0
    host: str = "127.0.0.1"
    env: dict = dataclasses.field(default_factory=dict)
    #: whether the router may OFFER a shared-memory ring to replicas on
    #: this machine (the offer is still attach-verified at negotiation —
    #: a genuinely remote machine falls back to TCP on its own — so this
    #: flag only short-circuits the attempt, e.g. for a roster entry
    #: known to sit behind a network hop or a broken /dev/shm)
    shm: bool = True


class Launcher:
    """Spawn-hook contract (see module docstring): subclasses implement
    :meth:`spawn` and return a ``subprocess.Popen``-shaped handle the
    router can ``poll()``/``terminate()``/``kill()``/``wait()``."""

    def spawn(self, machine: MachineSpec, argv, *, env: dict,
              log_path: Optional[str] = None) -> subprocess.Popen:
        raise NotImplementedError


class LocalLauncher(Launcher):
    """Exec the replica argv directly — the single-box launcher, and the
    test stand-in for remote machines (isolation = the machine's own
    workdir + its own OS process + loopback TCP)."""

    def spawn(self, machine: MachineSpec, argv, *, env: dict,
              log_path: Optional[str] = None) -> subprocess.Popen:
        os.makedirs(machine.workdir, exist_ok=True)
        merged = dict(env)
        merged.update(machine.env)
        log = open(log_path, "ab") if log_path is not None \
            else subprocess.DEVNULL
        try:
            return subprocess.Popen(
                list(argv), stdout=log, stderr=subprocess.STDOUT,
                env=merged, cwd=machine.workdir)
        finally:
            if log_path is not None:
                log.close()


class ExecLauncher(Launcher):
    """Command-template launcher: each template element has ``{cmd}``
    (the shell-quoted replica argv), ``{host}``, ``{machine}``, and
    ``{workdir}`` substituted, then the result is exec'd locally. This
    is the SSH shape without hardcoding ssh::

        ExecLauncher(["ssh", "{host}", "cd {workdir} && exec {cmd}"])

    The returned handle tracks the LOCAL template process (for ssh, the
    client); replica liveness does not depend on it — heartbeats in the
    machine workdir and the wire itself carry that — but its exit code
    still surfaces launch failures fast.

    Env forwarding: template launchers exec through another program, so
    the child env cannot be injected by the kernel. The spawn prefixes
    the command with ``env KEY=VALUE...`` for ``env_forward`` keys
    (default: the device-pinning and path variables the replica needs).
    """

    #: env vars prefixed onto the templated command (the ones the
    #: router's device pinning, module resolution and thread count depend
    #: on)
    DEFAULT_ENV_FORWARD = (
        "PYTHONPATH", "CUDA_VISIBLE_DEVICES", "OMP_NUM_THREADS",
    )

    def __init__(self, template, *, env_forward=None):
        if not template:
            raise ValueError("template must name at least one argv element")
        self.template = [str(t) for t in template]
        self.env_forward = tuple(env_forward) if env_forward is not None \
            else self.DEFAULT_ENV_FORWARD

    def spawn(self, machine: MachineSpec, argv, *, env: dict,
              log_path: Optional[str] = None) -> subprocess.Popen:
        os.makedirs(machine.workdir, exist_ok=True)
        merged = dict(env)
        merged.update(machine.env)
        prefix = ["env"] + [
            f"{k}={merged[k]}" for k in self.env_forward if k in merged]
        cmd = shlex.join(prefix + [str(a) for a in argv])
        final = [t.format(cmd=cmd, host=machine.host,
                          machine=machine.name, workdir=machine.workdir)
                 for t in self.template]
        log = open(log_path, "ab") if log_path is not None \
            else subprocess.DEVNULL
        try:
            return subprocess.Popen(
                final, stdout=log, stderr=subprocess.STDOUT,
                env=merged, cwd=machine.workdir)
        finally:
            if log_path is not None:
                log.close()


def plan_placement(n_slots: int, machines, *,
                   loads: Optional[dict] = None) -> list:
    """Assign ``n_slots`` replica slots to roster rows, least-loaded
    first, weighted by device inventory: each assignment goes to the
    machine minimizing ``(assigned + existing_load) / max(devices, 1)``.
    ``loads`` seeds per-machine slot counts already placed (respawn and
    scale-up placement pass the live roster state). Returns one
    :class:`MachineSpec` per slot."""
    machines = list(machines)
    if not machines:
        raise ValueError("placement needs at least one machine")
    counts = {m.name: int((loads or {}).get(m.name, 0)) for m in machines}
    out = []
    for i in range(int(n_slots)):
        m = min(machines,
                key=lambda m: ((counts[m.name]) / max(m.devices, 1),
                               (machines.index(m) + i) % len(machines)))
        counts[m.name] += 1
        out.append(m)
    return out

"""The seeded block plan and the file liveness layer of the PyTorch port
(``BlockPlan``, ``FileHeartbeat`` and ``SimulatedHostDeath`` of
``dask_ml_tpu/parallel/elastic.py``: numpy and the standard library
only).

:class:`FileHeartbeat` is the liveness layer every fleet of processes
shares: the process fleet's replicas beat on it
(``parallel/replica.py``) and its router reads it
(``parallel/procfleet.py``). The rest of the JAX module (``ElasticRun``,
the multi-host roster and re-deals) comes with the rest of the multi-device
port, ROADMAP Queue A item 10b.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import numpy as np

__all__ = ["BlockPlan", "FileHeartbeat", "SimulatedHostDeath"]


class FileHeartbeat:
    """mtime heartbeats and tombstones over a shared directory.

    ``workdir/hb/<member>`` holds heartbeat files whose mtime is the
    signal (each write is a temporary file renamed into place, so a reader
    never sees a torn one); ``workdir/dead/<member>`` holds the tombstones
    graceful leavers leave. A member that really died (SIGKILL, a lost
    machine) leaves nothing: its beats stop, and observers see the silence
    by its age. So a clean exit is seen at once, a dirty one within the
    observer's timeout.
    """

    def __init__(self, workdir: str):
        self.workdir = str(workdir)
        self._hb = os.path.join(self.workdir, "hb")
        self._dead = os.path.join(self.workdir, "dead")
        os.makedirs(self._hb, exist_ok=True)
        os.makedirs(self._dead, exist_ok=True)

    def hb_path(self, member: str) -> str:
        return os.path.join(self._hb, str(member))

    def tomb_path(self, member: str) -> str:
        return os.path.join(self._dead, str(member))

    def beat(self, member: str) -> None:
        """Refresh ``member``'s heartbeat (atomic, its mtime the signal)."""
        path = self.hb_path(member)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            f.write(f"{time.time():.6f}\n")
        os.replace(tmp, path)

    def tombstone(self, member: str) -> None:
        """Leave ``member``'s tombstone: observers skip the timeout."""
        with open(self.tomb_path(member), "w") as f:
            f.write(f"{time.time():.6f}\n")

    def has_tombstone(self, member: str) -> bool:
        return os.path.exists(self.tomb_path(member))

    def age(self, member: str) -> Optional[float]:
        """Seconds since ``member``'s last beat, or ``None`` when no beat
        was ever seen."""
        try:
            return time.time() - os.path.getmtime(self.hb_path(member))
        except OSError:
            return None

    def clear(self, member: str) -> None:
        """Forget ``member``'s heartbeat and tombstone: a fresh incarnation
        must not inherit its predecessor's death or stale beat."""
        for path in (self.hb_path(member), self.tomb_path(member)):
            try:
                os.unlink(path)
            except OSError:
                pass


class SimulatedHostDeath(RuntimeError):
    """An injected host death: the process stands for one killed by
    SIGKILL or a lost machine (no drain, no snapshot, no tombstone; its
    beats stop). In-process tests catch it where a dead host would just
    be gone."""

    def __init__(self, message: str, rank: int = 0):
        super().__init__(message)
        self.rank = int(rank)


class BlockPlan:
    """Deterministic, seeded cross-epoch block permutation.

    ``epoch_order(e)`` is a permutation of ``range(n_blocks)`` drawn from
    ``np.random.RandomState([seed, e])``: a pure function of (seed,
    epoch), the JAX package's permutation for the same pair, so every
    resume derives the same order. ``shuffle=False`` keeps block-id
    order. (The JAX class's ``shard`` / ``redeal``, which deal blocks over
    a multi-host roster, come with ROADMAP Queue A item 10b.)
    """

    def __init__(self, n_blocks: int, *, seed: int = 0,
                 shuffle: bool = True):
        if int(n_blocks) < 1:
            raise ValueError("n_blocks must be a positive integer")
        self.n_blocks = int(n_blocks)
        self.seed = int(seed)
        self.shuffle = bool(shuffle)

    def epoch_order(self, epoch: int) -> list:
        if not self.shuffle:
            return list(range(self.n_blocks))
        rs = np.random.RandomState(
            np.array([self.seed & 0xFFFFFFFF, int(epoch) & 0xFFFFFFFF],
                     dtype=np.uint32))
        return [int(b) for b in rs.permutation(self.n_blocks)]

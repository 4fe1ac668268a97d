"""The elastic multi-host data plane of the PyTorch port (counterpart of
``dask_ml_tpu/parallel/elastic.py``): a streamed epoch sharded over a
fleet of processes that survives losing some of them.

- :class:`BlockPlan`: the seeded block permutation of each epoch (the JAX
  package's permutation for the same seed and epoch), the contiguous
  shard of it each host takes, and the round-robin re-deal of a lost
  host's missing blocks. Every host computes every other host's
  assignment from the same arithmetic: there is no scheduler.
- :class:`ElasticRun`: the handle a process holds on one elastic fit.
  The hosts share a directory, not a collective: heartbeats and
  tombstones (:class:`FileHeartbeat`) say who is alive, and every
  block's result is published atomically through
  :func:`dask_ml_tpu_torch.checkpoint.save_pytree` (temporary file,
  rename, sha256 frame). Nothing here uses ``torch.distributed``: the
  tier must work exactly when collectives are what died.
- The solver loops :func:`elastic_admm_host`
  (``models.glm.admm_streamed(..., elastic=run)``) and
  :func:`elastic_moments_host` (``decomposition.streaming.
  streamed_moments`` / ``pca_fit_blocks(..., elastic=run)``), and the
  successive-halving search's candidate plane
  (``model_selection._incremental``), which deals a rung's candidates as
  blocks.

A block's result is a pure function of the epoch-start state and the
block's rows, the results are published as numpy (so a host's own result
and one read back from disk are the same bits) and folded in block-id
order: the trajectory equals the single-host run bit for bit, whatever
the roster did, whichever host died or drained and however the epoch was
shuffled. A host wrongly declared dead costs duplicate compute, never a
wrong answer: publication is idempotent.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import logging
import os
import threading
import time
from typing import Callable, Optional, Sequence

import numpy as np

from dask_ml_tpu_torch.parallel import telemetry
from dask_ml_tpu_torch.parallel.faults import Preempted

logger = logging.getLogger(__name__)

__all__ = ["BlockPlan", "ElasticRun", "FileHeartbeat", "SimulatedHostDeath"]


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
    """An injected host death (``FaultInjector.die_at``): the process
    stands for one killed by SIGKILL or a lost machine (no drain, no
    snapshot, no tombstone; its beats stop). In-process tests catch it
    where a dead host would just be gone; a host process turns it into
    ``os._exit``."""

    def __init__(self, message: str, rank: int = 0):
        super().__init__(message)
        self.rank = int(rank)


# ---------------------------------------------------------------------------
# the plan: seeded epoch permutation, shard split, re-deal
# ---------------------------------------------------------------------------


class BlockPlan:
    """Deterministic, seeded cross-epoch block permutation and shard split.

    ``epoch_order(e)`` is a permutation of ``range(n_blocks)`` drawn from
    ``np.random.RandomState([seed, e])``: a pure function of (seed,
    epoch), the JAX package's permutation for the same pair, so every host
    and every resume derives the same order. ``shuffle=False`` keeps
    block-id order. The streamed consumers' results do not depend on the
    order, so the shuffle changes the I/O order, never the bytes.

    :meth:`shard` deals an order contiguously over a sorted roster (an
    even split, the remainder to the front ranks); :meth:`redeal` deals a
    list of missing blocks round-robin over the sorted survivors. Both are
    pure, so every host computes every other host's assignment without a
    message.
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

    @staticmethod
    def shard(order: Sequence[int], rank: int, roster) -> list:
        """``rank``'s contiguous slice of ``order`` among the sorted
        ``roster`` (an even split, the remainder to the front ranks)."""
        roster = sorted(roster)
        i = roster.index(rank)
        base, rem = divmod(len(order), len(roster))
        start = i * base + min(i, rem)
        stop = start + base + (1 if i < rem else 0)
        return [int(b) for b in order[start:stop]]

    @staticmethod
    def redeal(missing: Sequence[int], survivors) -> dict:
        """The ``missing`` blocks (in their given order) dealt round-robin
        over the sorted ``survivors``: ``{block: new owner}``."""
        survivors = sorted(survivors)
        return {int(b): survivors[j % len(survivors)]
                for j, b in enumerate(missing)}


# ---------------------------------------------------------------------------
# the per-process handle: liveness and atomic publication
# ---------------------------------------------------------------------------


class ElasticRun:
    """A process's handle on one multi-host elastic fit.

    ``workdir`` is the directory every participating process shares.
    Under it each problem gets a namespace (:meth:`bind_problem`) with
    ``hb/`` (heartbeats, fresh by mtime), ``dead/`` (tombstones, left by
    graceful leavers and by :meth:`mark_dead`) and ``blocks/`` (the
    published block results, one subdirectory an epoch, each file written
    by :func:`~dask_ml_tpu_torch.checkpoint.save_pytree`: atomic and
    checksummed, so a torn publication cannot exist and a corrupt one
    raises).

    ``rank`` / ``world`` default to
    :func:`~dask_ml_tpu_torch.parallel.runtime.process_rank` /
    :func:`~dask_ml_tpu_torch.parallel.runtime.process_count` (an explicit
    ``set_process_info``, then ``DASK_ML_TPU_PROCESS_ID`` /
    ``DASK_ML_TPU_NUM_PROCESSES``, then an initialised world, then 0 of 1).
    ``shuffle_seed`` / ``shuffle`` configure the solver loops'
    :class:`BlockPlan`. A host whose heartbeat is older than
    ``heartbeat_timeout`` seconds, or that left a tombstone, is lost, and
    the survivors re-deal its missing blocks. ``drain`` (a
    :class:`~dask_ml_tpu_torch.parallel.faults.GracefulDrain`) is polled
    while waiting on peers: a requested drain leaves a tombstone and
    raises :class:`~dask_ml_tpu_torch.parallel.faults.Preempted`.

    ``speculate_after`` (seconds, best below ``heartbeat_timeout``)
    mitigates stragglers: a host done with its own share, which sees
    every owner alive but no new publication for that long, computes a
    share of the missing blocks without declaring anyone dead. The first
    publication wins; the bytes are the same either way. ``None`` turns
    speculation off.

    Counters ``hosts_lost`` / ``blocks_rebalanced`` / ``blocks_speculated``
    add to the telemetry counters ``elastic.host_lost`` /
    ``elastic.blocks_rebalanced`` / ``elastic.blocks_speculated`` at the
    same sites when the knob is on.
    """

    def __init__(self, workdir: str, *, rank: Optional[int] = None,
                 world: Optional[int] = None, shuffle_seed: int = 0,
                 shuffle: bool = True, heartbeat_timeout: float = 10.0,
                 poll_interval: float = 0.05, fault_injector=None,
                 drain=None, speculate_after: Optional[float] = None):
        from dask_ml_tpu_torch.parallel import runtime

        self.rank = runtime.process_rank() if rank is None else int(rank)
        self.world = runtime.process_count() if world is None else int(world)
        if not 0 <= self.rank < self.world:
            raise ValueError(
                f"rank {self.rank} out of range [0, {self.world})")
        self.workdir = str(workdir)
        self.shuffle_seed = int(shuffle_seed)
        self.shuffle = bool(shuffle)
        self.heartbeat_timeout = float(heartbeat_timeout)
        self.poll_interval = float(poll_interval)
        self.fault_injector = fault_injector
        self.drain = drain
        self.speculate_after = (None if speculate_after is None
                                else float(speculate_after))
        self.hosts_lost = 0
        self.blocks_rebalanced = 0
        self.blocks_speculated = 0
        #: ranks seen lost in this namespace (reset by a new problem)
        self._known_dead: set = set()
        #: ranks ever counted as lost by this handle: one death is counted
        #: once across problems, until the rank is seen beating again
        self._ever_lost: set = set()
        self._t0 = time.time()
        #: the problem namespace: "shared" until :meth:`bind_problem`
        self._ns = "shared"
        #: this epoch's results by (epoch, block), as published: what this
        #: host computed or read needs no second trip through the disk
        self._cache: dict = {}
        self._ensure_dirs()
        self.beat()

    def _dir(self, sub: str) -> str:
        return os.path.join(self.workdir, self._ns, sub)

    def _ensure_dirs(self) -> None:
        self._live = FileHeartbeat(os.path.join(self.workdir, self._ns))
        os.makedirs(self._dir("blocks"), exist_ok=True)

    def bind_problem(self, kind: str, **bind) -> str:
        """Scope this run to a problem: its files move to
        ``workdir/<digest>/``, the digest being the first 16 hex digits of
        the sha256 of ``{"kind": kind, **bind}`` as sorted-key JSON (the
        JAX package's digest for the same payload). Two problems sharing a
        workdir never read each other's blocks; the same problem again
        reuses its published blocks, which is the resume path. Every host
        derives the same digest."""
        payload = json.dumps({"kind": kind, **bind}, sort_keys=True,
                             default=repr)
        ns = hashlib.sha256(payload.encode()).hexdigest()[:16]
        if ns != self._ns:
            self._ns = ns
            self._known_dead = set()  # loss views are per namespace
            self._t0 = time.time()
            self._cache.clear()
            self._ensure_dirs()
            # the readable record of the namespace; every writer writes the
            # same bytes, and threads standing for hosts share a pid, so
            # the temporary name carries the thread id too
            desc = os.path.join(self.workdir, ns, "problem.json")
            tmp = f"{desc}.{os.getpid()}.{threading.get_ident()}.tmp"
            with open(tmp, "w") as f:
                f.write(payload)
            os.replace(tmp, desc)
            self.beat()
        return ns

    # -- liveness ----------------------------------------------------------

    def _hb_path(self, rank: int) -> str:
        return self._live.hb_path(f"host{int(rank)}")

    def _tomb_path(self, rank: int) -> str:
        return self._live.tomb_path(f"host{int(rank)}")

    def beat(self) -> None:
        """Refresh this process's heartbeat."""
        self._live.beat(f"host{self.rank}")

    def mark_dead(self, rank: int) -> None:
        """Leave ``rank``'s tombstone: survivors see the death at once
        instead of waiting out the heartbeat timeout."""
        self._live.tombstone(f"host{int(rank)}")

    def lost_hosts(self) -> set:
        """Ranks lost now: tombstoned, or with a heartbeat older than
        ``heartbeat_timeout`` (a heartbeat never seen ages from this
        namespace's start, so a host that never launched is lost in the
        end). Cumulative within a namespace. A newly seen death adds to
        ``hosts_lost`` once, across namespaces, unless the rank was seen
        beating again since."""
        lost = set(self._known_dead)
        now = time.time()
        for r in range(self.world):
            if r == self.rank or r in lost:
                continue
            if self._live.has_tombstone(f"host{r}"):
                lost.add(r)
                continue
            age = self._live.age(f"host{r}")
            fresh_hb = age is not None
            if age is None:
                age = now - self._t0
            if age > self.heartbeat_timeout:
                lost.add(r)
            elif fresh_hb and r in self._ever_lost:
                # a real beat from a rank counted before: it rejoined, so
                # a later death is a new loss
                self._ever_lost.discard(r)
        new = lost - self._known_dead
        if new:
            self._known_dead |= new
            logger.warning("elastic: host(s) %s lost (rank %d observing)",
                           sorted(new), self.rank)
            counted = new - self._ever_lost
            if counted:
                self._ever_lost |= counted
                self.hosts_lost += len(counted)
                if telemetry.enabled():
                    telemetry.metrics().counter(
                        "elastic.host_lost").inc(len(counted))
        return lost

    def alive_hosts(self) -> list:
        """Sorted ranks not lost now (this one always among them)."""
        lost = self.lost_hosts()
        return [r for r in range(self.world)
                if r == self.rank or r not in lost]

    # -- publication -------------------------------------------------------

    def _block_path(self, epoch: int, block: int) -> str:
        # a subdirectory an epoch: each poll lists only its epoch's files
        return os.path.join(self._dir("blocks"), f"e{int(epoch):04d}",
                            f"b{int(block):05d}.ckpt")

    def publish(self, epoch: int, block: int, tree) -> None:
        """Atomically publish ``block``'s result for ``epoch`` (numpy
        leaves). Idempotent: a result is a pure function of the
        epoch-start state and the block, so two publishers write the same
        bytes. The tree is also kept for this epoch's assembly."""
        from dask_ml_tpu_torch.checkpoint import save_pytree

        save_pytree(self._block_path(epoch, block), tree,
                    meta={"kind": "elastic_block", "epoch": int(epoch),
                          "block": int(block), "by": self.rank})
        self._cache[(int(epoch), int(block))] = tree

    def published(self, epoch: int) -> set:
        """Block ids with a published result for ``epoch``."""
        try:
            names = os.listdir(
                os.path.join(self._dir("blocks"), f"e{int(epoch):04d}"))
        except OSError:
            return set()
        return {int(name[1:-len(".ckpt")]) for name in names
                if name.startswith("b") and name.endswith(".ckpt")}

    def read_block(self, epoch: int, block: int):
        """A published block result. A corrupt file raises
        :class:`~dask_ml_tpu_torch.checkpoint.CheckpointCorruptError`."""
        from dask_ml_tpu_torch.checkpoint import load_pytree

        snap = load_pytree(self._block_path(epoch, block))
        if snap is None:
            raise FileNotFoundError(
                f"elastic block e{epoch} b{block} is not published")
        return snap[0]

    # -- failure hooks -----------------------------------------------------

    def maybe_die(self, block: int, epoch: int) -> None:
        """Deliver the injector's ``die_at`` plan after ``block`` was
        published: no tombstone, no snapshot; survivors must notice the
        silence."""
        if (self.fault_injector is not None
                and self.fault_injector.should_die(block, epoch)):
            raise SimulatedHostDeath(
                f"injected host death after block {block} of epoch "
                f"{epoch} (rank {self.rank})", rank=self.rank)

    def check_drain(self) -> None:
        """A requested drain means leave now: this host's blocks are
        published, so it leaves its tombstone and raises
        :class:`~dask_ml_tpu_torch.parallel.faults.Preempted`."""
        if self.drain is not None and self.drain.requested:
            self.mark_dead(self.rank)
            raise Preempted(
                f"graceful drain: rank {self.rank} leaving the elastic "
                "run; its published blocks stand and survivors rebalance "
                "the rest")

    @contextlib.contextmanager
    def leaving(self):
        """The solver loops' compute scope: a
        :class:`~dask_ml_tpu_torch.parallel.faults.Preempted` escaping it
        (a drain mid-scan, after its snapshot) leaves this rank's
        tombstone on the way out."""
        try:
            yield
        except Preempted:
            self.mark_dead(self.rank)
            raise

    # -- the rebalance protocol -------------------------------------------

    def collect_epoch(self, plan: BlockPlan, epoch: int,
                      order: Sequence[int], owner: dict,
                      compute_publish: Callable[[list], None]) -> dict:
        """Wait until every block of ``epoch`` is published, re-dealing
        lost hosts' missing blocks to the survivors (this host computes
        its own share of each re-deal). Returns ``{block: tree}`` for the
        whole epoch.

        ``owner`` maps block → rank in this host's view and is updated by
        the re-deals. Views may differ between hosts for a while (a death
        is seen at different times): that costs duplicate compute, never
        a gap. Where views cross (a block every live host believes another
        live host owns), a heartbeat timeout without a new publication
        re-deals every missing block over the survivors."""
        last_progress = time.time()
        n_have = -1
        speculated: set = set()
        while True:
            have = self.published(epoch)
            if len(have) != n_have:
                n_have = len(have)
                last_progress = time.time()
            missing = [b for b in order if b not in have]
            if not missing:
                out = {b: self._cache.get((int(epoch), int(b)))
                       for b in order}
                for b in order:
                    if out[b] is None:
                        out[b] = self.read_block(epoch, b)
                self._cache.clear()
                return out
            self.beat()
            self.check_drain()
            # blocks this host owns but never published (a resume whose
            # saved sequence predates a roster change): nobody else will
            stale_mine = [b for b in missing if owner.get(b) == self.rank]
            if stale_mine:
                compute_publish(stale_mine)
                continue
            lost = self.lost_hosts()
            orphans = [b for b in missing
                       if owner.get(b) in lost or owner.get(b) is None]
            if (not orphans and self.speculate_after is not None
                    and time.time() - last_progress
                    > self.speculate_after):
                # every owner is alive but nothing landed: someone is
                # slow. The idle hosts (owning no missing block) deal the
                # stragglers' blocks among themselves, each block at most
                # once an epoch per host; the heartbeat fallback below
                # stays the backstop
                stalled = {owner.get(b) for b in missing}
                idle = [r for r in range(self.world)
                        if r not in lost and r not in stalled]
                if self.rank in idle:
                    deal = BlockPlan.redeal(
                        [b for b in missing if b not in speculated], idle)
                    grab = [b for b, r in deal.items() if r == self.rank]
                    if grab:
                        logger.warning(
                            "elastic: rank %d speculatively computing %d "
                            "straggler block(s) of epoch %d: %s",
                            self.rank, len(grab), epoch, grab)
                        speculated.update(grab)
                        with telemetry.span("elastic.speculate",
                                            epoch=epoch, blocks=len(grab)):
                            compute_publish(grab)
                        self.blocks_speculated += len(grab)
                        if telemetry.enabled():
                            telemetry.metrics().counter(
                                "elastic.blocks_speculated").inc(len(grab))
                        continue
            if not orphans and (time.time() - last_progress
                                > self.heartbeat_timeout):
                # crossed views: every live owner had a whole timeout and
                # nothing landed, so the assignment view is re-dealt
                logger.warning(
                    "elastic: rank %d saw no progress on %d missing "
                    "block(s) of epoch %d for %.1fs; re-dealing them over "
                    "the current survivors", self.rank, len(missing),
                    epoch, self.heartbeat_timeout)
                orphans = list(missing)
                last_progress = time.time()
            if orphans:
                survivors = [r for r in range(self.world) if r not in lost]
                owner.update(BlockPlan.redeal(orphans, survivors))
                grab = [b for b in orphans if owner[b] == self.rank]
                if grab:
                    logger.warning(
                        "elastic: rank %d rebalancing %d orphaned "
                        "block(s) of epoch %d: %s", self.rank, len(grab),
                        epoch, grab)
                    with telemetry.span("elastic.rebalance", epoch=epoch,
                                        blocks=len(grab)):
                        compute_publish(grab)
                    self.blocks_rebalanced += len(grab)
                    if telemetry.enabled():
                        telemetry.metrics().counter(
                            "elastic.blocks_rebalanced").inc(len(grab))
                    continue
            time.sleep(self.poll_interval)


# ---------------------------------------------------------------------------
# the elastic solver loops (called by the facades)
# ---------------------------------------------------------------------------


def _epoch_assignment(run: ElasticRun, order) -> dict:
    """The epoch-start view: ``order`` dealt contiguously over the hosts
    alive now, ``{block: rank}``."""
    alive = run.alive_hosts()
    owner = {}
    for r in alive:
        for b in BlockPlan.shard(order, r, alive):
            owner[b] = r
    return owner


def _adopt(run: ElasticRun, source, scan_checkpoint) -> None:
    """Wire a solver loop's run to its source and checkpoint: the source's
    bytes are counted under this host, the source's injector delivers
    ``die_at``, the checkpoint's drain is polled."""
    if source.host_rank is None:
        source.host_rank = run.rank
    if run.fault_injector is None:
        run.fault_injector = getattr(source, "fault_injector", None)
    if run.drain is None and scan_checkpoint is not None:
        run.drain = scan_checkpoint.drain


def elastic_admm_host(run: ElasticRun, source, z, x, u, mask, pen_prox,
                      scal, *, check_done, family, regularizer, max_iter,
                      inner_max_iter, kernel, scan_checkpoint=None):
    """The elastic counterpart of ``models/glm.py::_admm_streamed_host``:
    each epoch this host consumes its shard of the seeded block
    permutation through ``prefetched_scan(blocks=)``, publishes each
    block's prox solution as numpy as it completes, waits (and rebalances)
    until the whole epoch is published, then runs the consensus itself.
    The consensus is deterministic, so every host derives the same
    ``(z, u, done)`` with no collective.

    The per-block solve (:func:`~dask_ml_tpu_torch.models.glm._block_prox`)
    depends only on the epoch-start ``(z, x, u)`` and the block's rows,
    and ``x`` is stacked in block-id order before the consensus
    (:func:`~dask_ml_tpu_torch.models.glm._streamed_consensus`, the
    single-host one): the trajectory is the single-host run's bits
    whatever the roster did. Published files stay for the run's lifetime
    (a d-vector a block an epoch). Returns ``(z, n_iter, x, u, done)``."""
    import torch

    from dask_ml_tpu_torch.checkpoint import leaf_tensor
    from dask_ml_tpu_torch.models import glm as glm_core
    from dask_ml_tpu_torch.parallel.hierarchy import ledger
    from dask_ml_tpu_torch.parallel.stream import prefetched_scan

    dev = source.device
    n_blocks = int(x.shape[0])
    plan = BlockPlan(n_blocks, seed=run.shuffle_seed, shuffle=run.shuffle)
    run.bind_problem(
        "admm_streamed", n_blocks=n_blocks, d=int(z.shape[0]),
        family=family, regularizer=regularizer,
        params=repr(tuple(float(scal[k]) for k in (
            "lamduh", "rho", "abstol", "reltol", "inner_tol", "sw_total"))
            + (int(inner_max_iter),)),
        shuffle_seed=run.shuffle_seed, shuffle=run.shuffle)
    _adopt(run, source, scan_checkpoint)

    done = None
    n_iter = 0
    start_epoch, resume = 0, None
    if scan_checkpoint is not None:
        snap = scan_checkpoint.load()
        if snap is not None:
            carry, outs0, pos0, start_epoch = snap
            z, x, u = (leaf_tensor(t, dev) for t in carry)
            seq0 = (scan_checkpoint.last_meta or {}).get("blocks")
            resume = (list(outs0), int(pos0), list(seq0 or []))
            n_iter = start_epoch

    for it in range(start_epoch, max_iter):
        with run.leaving(), telemetry.span("elastic.epoch", epoch=it,
                                           rank=run.rank, blocks=n_blocks):
            # a drain requested since the last epoch leaves at the
            # boundary, before any work it would not finish
            run.check_drain()
            order = plan.epoch_order(it)
            owner = _epoch_assignment(run, order)
            z_e, x_e, u_e = z, x, u  # the epoch-start carry

            def step(carry, b, blk):
                x_b = glm_core._block_prox(
                    blk, b, z_e, x_e, u_e, scal, family=family,
                    inner_max_iter=inner_max_iter,
                    transform=source.transform, kernel=kernel)
                # the publication reads the block's result to the host:
                # the price of this host's work surviving its death
                x_b = x_b.cpu().numpy()
                run.publish(it, b, x_b)
                run.beat()
                run.maybe_die(b, it)
                return carry, x_b

            def compute_publish(blocks_seq, start_pos=0, outs=None):
                prefetched_scan(step, (z_e, x_e, u_e), source,
                                blocks=blocks_seq,
                                checkpoint=scan_checkpoint, epoch=it,
                                start_block=start_pos, outs=outs)

            if resume is not None and it == start_epoch and resume[2]:
                # replay the snapshot's own sequence from its position:
                # the roster, and so the shard split, may have changed
                outs0, pos0, seq0 = resume
                compute_publish(seq0, start_pos=pos0, outs=outs0)
            else:
                compute_publish([b for b in order
                                 if owner.get(b) == run.rank])

            results = run.collect_epoch(plan, it, order, owner,
                                        compute_publish)
            x = torch.as_tensor(
                np.stack([np.asarray(results[b]) for b in range(n_blocks)]),
                device=dev)
            # the consensus imports every other host's blocks over the
            # cross-host link: the pod level of the two-level hierarchy
            n_foreign = sum(1 for b in range(n_blocks)
                            if owner.get(b) != run.rank)
            ledger().record("glm.admm.consensus", "pod",
                            n_foreign * int(np.asarray(results[0]).nbytes))
            with telemetry.span("elastic.consensus", epoch=it):
                z, u, done = glm_core._streamed_consensus(
                    z, x, u, mask, pen_prox, scal)
        n_iter = it + 1
        # every surviving host computes the same flag: they stop together
        if check_done and glm_core._read(done):
            break
    source.discard_inflight()
    if scan_checkpoint is not None:
        scan_checkpoint.delete()
    return z, n_iter, x, u, done


def elastic_moments_host(run: ElasticRun, source, scan_checkpoint=None):
    """The elastic moment pass (``streamed_moments`` / ``pca_fit_blocks``
    with ``elastic=``): one epoch of the seeded permutation sharded over
    the hosts. Each block's moments are computed from zeros and published;
    every host then folds all of them in block-id order
    (:func:`_fold_moments`). Independent blocks are what make the pass
    elastic: a running sum dies with its host, a published block does not.
    The summation tree differs from the single-host running chain, so the
    result equals it to Neumaier accuracy, and equals itself bit for bit
    across rosters, deaths and resumes. A resume needs no carry: the
    published blocks are the progress."""
    import torch

    from dask_ml_tpu_torch.decomposition import streaming as sm
    from dask_ml_tpu_torch.parallel.stream import prefetched_scan

    n_blocks = source.n_blocks
    d = int(source.out_struct[0].shape[1])
    dev = source.device
    plan = BlockPlan(n_blocks, seed=run.shuffle_seed, shuffle=run.shuffle)
    run.bind_problem("streamed_moments", n_blocks=n_blocks, d=d,
                     shuffle_seed=run.shuffle_seed, shuffle=run.shuffle)
    _adopt(run, source, scan_checkpoint)

    with run.leaving(), telemetry.span("elastic.moments", rank=run.rank,
                                       blocks=n_blocks, d=d):
        run.check_drain()
        order = plan.epoch_order(0)
        owner = _epoch_assignment(run, order)

        def step(carry, b, blk):
            if source.transform is not None:
                blk = source.transform(blk)
            X_b, w_b = blk
            sw_b, s_b, G_b = sm._moments_finalize(
                sm._accumulate_block(sm._moments_init(d, dev), X_b, w_b))
            run.publish(0, b, (sw_b.cpu().numpy(), s_b.cpu().numpy(),
                               G_b.cpu().numpy()))
            run.beat()
            run.maybe_die(b, 0)
            return carry, None

        def compute_publish(blocks_seq):
            prefetched_scan(step, None, source, blocks=blocks_seq,
                            checkpoint=scan_checkpoint, epoch=0)

        have = run.published(0)
        compute_publish([b for b in order
                         if owner.get(b) == run.rank and b not in have])
        results = run.collect_epoch(plan, 0, order, owner, compute_publish)

        def stacked(i):
            return torch.as_tensor(
                np.stack([np.asarray(results[b][i])
                          for b in range(n_blocks)]), device=dev)

        sw, s, G = _fold_moments(stacked(0), stacked(1), stacked(2))
    source.discard_inflight()
    if scan_checkpoint is not None:
        scan_checkpoint.delete()
    return sw, s, G


def _fold_moments(sws, ss, Gs):
    """The per-block moments folded in block-id order on their device, f32
    with Neumaier compensation on the sums and the Gram: one fixed order,
    so every host gets the same bits."""
    import torch

    from dask_ml_tpu_torch.parallel.precision import neumaier_add

    d = int(ss.shape[1])
    sw = torch.zeros((), dtype=torch.float32, device=ss.device)
    s = torch.zeros((d,), dtype=torch.float32, device=ss.device)
    cs = torch.zeros_like(s)
    G = torch.zeros((d, d), dtype=torch.float32, device=ss.device)
    cG = torch.zeros_like(G)
    for b in range(int(ss.shape[0])):
        sw = sw + sws[b]
        s, cs = neumaier_add(s, cs, ss[b])
        G, cG = neumaier_add(G, cG, Gs[b])
    return sw, s + cs, G + cG

"""The PyTorch port's elastic multi-host data plane
(``dask_ml_tpu_torch/parallel/elastic.py``) on the CPU: the JAX package's
``tests/test_elastic.py`` ported case by case, and the port held against
the JAX package.

Within the port, bit for bit: an elastic fit's ``(z, x, u)`` and moments
do not depend on how many hosts took part, which of them died or drained,
or how the epoch was shuffled (world 1, two hosts, a ``die_at`` kill, a
drain, a resume mid-shuffled-epoch); a loader source whose blocks differ
in their widest row gives the same bits under any roster.

Against the JAX package:

- ``BlockPlan`` (orders, shards, re-deals) and ``bind_problem``'s digest
  are equal;
- a block the JAX ``ElasticRun`` published is read by the port's
  ``read_block``;
- the elastic ADMM (dense and sparse blocks) and the elastic moments are
  within rtol 1e-5 (atol 1e-6) of the JAX elastic loops' on the same
  blocks and roster: the packages sum in other orders, and three outer
  iterations carry the ulps forward.

Hosts are threads sharing a workdir, as in the JAX tests: the
coordination layer is the filesystem, so threads run the code processes
run. ``host_reads`` of ``models/glm.py`` is a module counter the threads
race on, so no test counts from it.
"""

import hashlib
import json
import os
import threading
import time

import numpy as np
import pytest
import scipy.sparse as scipy_sparse
import torch

from dask_ml_tpu.decomposition import streaming as jstreaming
from dask_ml_tpu.models import glm as jcore
from dask_ml_tpu.parallel import elastic as jelastic
from dask_ml_tpu.parallel import stream as jstream
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch.checkpoint import CheckpointCorruptError, load_pytree
from dask_ml_tpu_torch.decomposition import streaming
from dask_ml_tpu_torch.models import glm as tcore
from dask_ml_tpu_torch.parallel import hierarchy
from dask_ml_tpu_torch.parallel.elastic import (BlockPlan, ElasticRun,
                                                SimulatedHostDeath)
from dask_ml_tpu_torch.parallel.faults import (FaultInjector, GracefulDrain,
                                               Preempted)
from dask_ml_tpu_torch.parallel.stream import HostBlockSource, prefetched_scan

# one problem shape for every solver-level test, as in the JAX module
N, D, BLOCKS, OUTER = 512, 5, 4, 3
SEED = 7
#: port against the JAX package (the elastic ADMM state, the moments)
JAX_TOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def on_cpu():
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    with config_context(device="cpu"):
        yield


def _problem():
    rng = np.random.RandomState(0)
    X = rng.randn(N, D).astype(np.float32)
    beta = rng.randn(D).astype(np.float32)
    y = (X @ beta + 0.3 * rng.randn(N) > 0).astype(np.float32)
    return X, y, np.ones(N, np.float32)


def _sparse_problem():
    rng = np.random.RandomState(4)
    Dn = ((rng.rand(N, 12) < 0.3) * rng.randn(N, 12)).astype(np.float32)
    y = (Dn @ rng.randn(12) + 0.3 * rng.randn(N) > 0).astype(np.float32)
    return scipy_sparse.csr_matrix(Dn), y, np.ones(N, np.float32)


def _kw(**extra):
    kw = dict(family="logistic", regularizer="l2", lamduh=1.0,
              max_iter=OUTER, abstol=0.0, reltol=0.0, return_state=True)
    kw.update(extra)
    return kw


def _fit(source, elastic=None, d=D, **extra):
    z, n_iter, (z2, x, u), done = tcore.admm_streamed(
        source, BLOCKS, d, float(N), elastic=elastic, **_kw(**extra))
    return z.numpy(), x.numpy(), u.numpy()


def _assert_state_equal(a, b):
    for left, right in zip(a, b):
        np.testing.assert_array_equal(left, right)


def _host_thread(results, rank, wd, source, injector=None, drain=None,
                 timeout=60.0, fit=_fit):
    def go():
        with config_context(device="cpu"):
            run = ElasticRun(wd, rank=rank, world=2, shuffle_seed=SEED,
                             heartbeat_timeout=timeout, poll_interval=0.02,
                             fault_injector=injector, drain=drain)
            try:
                results[rank] = (fit(source, elastic=run), run)
            except (SimulatedHostDeath, Preempted) as e:
                results[rank] = (e, run)

    t = threading.Thread(target=go, daemon=True)
    t.start()
    return t


def _join(*threads, timeout=180):
    for t in threads:
        t.join(timeout=timeout)
        assert not t.is_alive(), "elastic fit deadlocked"


# ---------------------------------------------------------------------------
# BlockPlan: the arithmetic every host shares
# ---------------------------------------------------------------------------


def test_epoch_order_is_deterministic_seeded_permutation():
    plan = BlockPlan(16, seed=3)
    o0 = plan.epoch_order(0)
    assert o0 == BlockPlan(16, seed=3).epoch_order(0)
    assert sorted(o0) == list(range(16))
    assert plan.epoch_order(1) != o0
    assert BlockPlan(16, seed=4).epoch_order(0) != o0
    assert BlockPlan(16, seed=3, shuffle=False).epoch_order(5) == list(
        range(16))


def test_shard_is_a_contiguous_partition_with_remainder_to_front():
    order = BlockPlan(10, seed=0).epoch_order(0)
    for roster in ([0, 1, 2], [0, 2, 5], [1]):
        shards = [BlockPlan.shard(order, r, roster) for r in roster]
        assert sum(shards, []) == order
        sizes = [len(s) for s in shards]
        assert max(sizes) - min(sizes) <= 1
        assert sizes == sorted(sizes, reverse=True)


def test_redeal_round_robin_and_purity():
    missing = [7, 3, 9, 1, 4]
    deal = BlockPlan.redeal(missing, [2, 0])
    assert deal == {7: 0, 3: 2, 9: 0, 1: 2, 4: 0}
    assert BlockPlan.redeal(missing, [0, 2]) == deal
    assert BlockPlan(1).n_blocks == 1
    with pytest.raises(ValueError):
        BlockPlan(0)


@pytest.mark.parametrize("n_blocks", [1, 2, 5, 8, 13])
def test_plan_shard_and_redeal_equal_jax(n_blocks):
    for seed, shuffle in ((0, True), (7, True), (3, False)):
        plan = BlockPlan(n_blocks, seed=seed, shuffle=shuffle)
        jplan = jelastic.BlockPlan(n_blocks, seed=seed, shuffle=shuffle)
        for epoch in (0, 1, 1001):
            order = plan.epoch_order(epoch)
            assert order == jplan.epoch_order(epoch)
            for roster in ([0], [0, 1], [0, 2, 5], [1, 3, 4, 6]):
                for r in roster:
                    assert BlockPlan.shard(order, r, roster) == \
                        jelastic.BlockPlan.shard(order, r, roster)
                missing = order[::2]
                assert BlockPlan.redeal(missing, roster) == \
                    jelastic.BlockPlan.redeal(missing, roster)


# ---------------------------------------------------------------------------
# liveness, the namespace digest, publication
# ---------------------------------------------------------------------------


def test_heartbeat_staleness_and_tombstones(tmp_path):
    r0 = ElasticRun(tmp_path, rank=0, world=3, heartbeat_timeout=0.2,
                    poll_interval=0.01)
    r1 = ElasticRun(tmp_path, rank=1, world=3, heartbeat_timeout=0.2,
                    poll_interval=0.01)
    assert r0.lost_hosts() in (set(), {2})  # rank 2 never launched
    time.sleep(0.3)
    r1.beat()                       # rank 1 stays fresh, rank 2 goes stale
    assert r0.lost_hosts() == {2}
    assert r0.hosts_lost == 1
    r0.mark_dead(1)                 # a tombstone is seen at once
    assert r0.lost_hosts() == {1, 2}
    assert r0.alive_hosts() == [0]
    r1.beat()                       # a late beat does not resurrect
    assert r0.lost_hosts() == {1, 2}
    assert r0.hosts_lost == 2


def test_host_loss_counted_once_across_problem_rebinds(tmp_path):
    r0 = ElasticRun(tmp_path, rank=0, world=2, heartbeat_timeout=0.2,
                    poll_interval=0.01)
    ElasticRun(tmp_path, rank=1, world=2, heartbeat_timeout=0.2,
               poll_interval=0.01)
    time.sleep(0.3)                       # rank 1 goes silent
    assert r0.lost_hosts() == {1}
    assert r0.hosts_lost == 1
    r0.bind_problem("fit2", n=1)          # the next fit, the same handle
    time.sleep(0.3)
    assert r0.lost_hosts() == {1}         # dead in the new namespace too
    assert r0.hosts_lost == 1             # but not counted again
    # rank 1 restarts and joins fit3: a real beat re-arms the count
    r0.bind_problem("fit3", n=1)
    r1b = ElasticRun(tmp_path, rank=1, world=2, heartbeat_timeout=0.2,
                     poll_interval=0.01)
    r1b.bind_problem("fit3", n=1)
    assert r0.lost_hosts() == set()
    time.sleep(0.3)                       # and dies again
    assert r0.lost_hosts() == {1}
    assert r0.hosts_lost == 2


def test_elastic_run_rides_the_shared_liveness(tmp_path):
    run = ElasticRun(str(tmp_path), rank=0, world=2, heartbeat_timeout=0.2)
    assert os.path.exists(run._live.hb_path("host0"))
    run.mark_dead(1)
    assert run._live.has_tombstone("host1")
    assert run.lost_hosts() == {1}


def test_rank_and_world_default_to_the_process_env(tmp_path, monkeypatch):
    monkeypatch.setenv("DASK_ML_TPU_PROCESS_ID", "1")
    monkeypatch.setenv("DASK_ML_TPU_NUM_PROCESSES", "3")
    run = ElasticRun(tmp_path)
    assert (run.rank, run.world) == (1, 3)
    with pytest.raises(ValueError, match="out of range"):
        ElasticRun(tmp_path, rank=3, world=3)


def test_bind_problem_digest_equals_jax(tmp_path):
    bind = dict(n_blocks=8, d=1001, family="logistic", regularizer="l2",
                params=repr((1.0, 1.0, 0.0, 0.0, 1e-8, 1e6, 20)),
                shuffle_seed=11, shuffle=True)
    run = ElasticRun(tmp_path / "port", rank=0, world=1)
    jrun = jelastic.ElasticRun(str(tmp_path / "jax"), rank=0, world=1)
    ns = run.bind_problem("admm_streamed", **bind)
    assert ns == jrun.bind_problem("admm_streamed", **bind)
    payload = json.dumps({"kind": "admm_streamed", **bind}, sort_keys=True)
    assert ns == hashlib.sha256(payload.encode()).hexdigest()[:16]
    with open(tmp_path / "port" / ns / "problem.json") as f:
        assert f.read() == payload
    assert run.bind_problem("admm_streamed", **dict(bind, d=1000)) != ns


def test_die_at_injector_is_one_shot_and_counted():
    inj = FaultInjector().die_at(block=3, epoch=1)
    assert not inj.should_die(3, 0)
    assert inj.should_die(3, 1)
    assert not inj.should_die(3, 1)  # consumed
    assert inj.injected["die"] == 1


def test_corrupt_published_block_raises_loudly(tmp_path):
    run = ElasticRun(tmp_path, rank=0, world=1)
    run.publish(0, 2, np.arange(4.0))
    assert run.published(0) == {2}
    path = run._block_path(0, 2)
    with open(path, "rb") as f:
        blob = f.read()
    with open(path, "wb") as f:        # a torn copy: half the file
        f.write(blob[: len(blob) // 2])
    with pytest.raises(CheckpointCorruptError):
        run.read_block(0, 2)


def test_block_published_by_jax_is_read_by_the_port(tmp_path):
    jrun = jelastic.ElasticRun(str(tmp_path), rank=1, world=2)
    run = ElasticRun(tmp_path, rank=0, world=2)
    for r in (jrun, run):
        r.bind_problem("streamed_moments", n_blocks=4, d=3)
    tree = (np.float32(7.0), np.arange(3, dtype=np.float32),
            np.eye(3, dtype=np.float32))
    jrun.publish(2, 3, tree)
    assert run.published(2) == {3}
    got = run.read_block(2, 3)
    for a, b in zip(got, tree):
        np.testing.assert_array_equal(a, b)
    # and the other way round
    run.publish(2, 1, tree)
    assert jrun.published(2) == {1, 3}
    np.testing.assert_array_equal(jrun.read_block(2, 1)[2], tree[2])


# ---------------------------------------------------------------------------
# the shard-aware scan
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("prefetch", [0, 2])
def test_prefetched_scan_explicit_block_sequence(prefetch):
    X, y, w = _problem()
    src = HostBlockSource((X, y, w), BLOCKS, prefetch=prefetch)
    seen = []

    def step(carry, b, blk):
        seen.append(b)
        return carry, float(blk[0].sum())

    seq = [2, 0, 3]
    _, outs = prefetched_scan(step, None, src, blocks=seq)
    assert seen == seq                     # global ids, in sequence order
    per_block = X.reshape(BLOCKS, -1, D)
    np.testing.assert_allclose(
        outs, [per_block[b].sum() for b in seq], rtol=1e-6)
    assert src._inflight == {}


def test_prefetched_scan_rejects_wrap_with_explicit_blocks():
    X, y, w = _problem()
    src = HostBlockSource((X, y, w), BLOCKS)
    with pytest.raises(ValueError, match="wrap=True cannot combine"):
        prefetched_scan(lambda c, b, blk: (c, None), None, src,
                        wrap=True, blocks=[0, 1])


@pytest.mark.parametrize("consumer", ["admm", "moments"])
def test_elastic_rejects_a_callable_block_fn(consumer):
    with pytest.raises(ValueError, match="elastic= requires a Host"):
        if consumer == "admm":
            tcore.admm_streamed(lambda b: None, BLOCKS, D, float(N),
                                elastic=object())
        else:
            streaming.streamed_moments(block_fn=lambda b: None, n_blocks=2,
                                       elastic=object())


# ---------------------------------------------------------------------------
# bit identity: any roster, any death, any shuffle
# ---------------------------------------------------------------------------


def test_elastic_world1_matches_nonelastic_bit_identical(tmp_path):
    X, y, w = _problem()
    base = _fit(HostBlockSource((X, y, w), BLOCKS))
    run = ElasticRun(tmp_path, rank=0, world=1, shuffle_seed=SEED)
    got = _fit(HostBlockSource((X, y, w), BLOCKS), elastic=run)
    _assert_state_equal(base, got)
    assert run.hosts_lost == 0 and run.blocks_rebalanced == 0


def test_two_hosts_both_alive_match_single_host(tmp_path):
    X, y, w = _problem()
    base = _fit(HostBlockSource((X, y, w), BLOCKS))
    results = {}
    ts = [_host_thread(results, r, tmp_path,
                       HostBlockSource((X, y, w), BLOCKS)) for r in (0, 1)]
    _join(*ts)
    for r in (0, 1):
        state, run = results[r]
        assert not isinstance(state, Exception)
        _assert_state_equal(base, state)
        assert run.hosts_lost == 0


def test_kill_one_host_mid_epoch_survivor_rebalances_bit_identical(
        tmp_path):
    """Host 1 dies (no drain, no tombstone) after publishing one block of
    the shuffled epoch 0; host 0 finishes its shard, sees the silence
    through the heartbeat timeout, takes the orphaned blocks and ends with
    the single-host bits."""
    X, y, w = _problem()
    base = _fit(HostBlockSource((X, y, w), BLOCKS))
    order = BlockPlan(BLOCKS, seed=SEED).epoch_order(0)
    shard1 = BlockPlan.shard(order, 1, [0, 1])
    assert len(shard1) >= 2  # the kill must orphan at least one block
    inj = FaultInjector().die_at(block=shard1[0], epoch=0)
    results = {}
    t1 = _host_thread(results, 1, tmp_path,
                      HostBlockSource((X, y, w), BLOCKS), injector=inj,
                      timeout=2.0)
    t0 = _host_thread(results, 0, tmp_path,
                      HostBlockSource((X, y, w), BLOCKS), timeout=2.0)
    _join(t1, t0)
    dead, _ = results[1]
    assert isinstance(dead, SimulatedHostDeath) and dead.rank == 1
    state, run0 = results[0]
    assert not isinstance(state, Exception)
    _assert_state_equal(base, state)
    assert run0.hosts_lost == 1
    assert run0.blocks_rebalanced >= len(shard1) - 1
    # the dead host's published block was not recomputed
    assert run0.blocks_rebalanced < BLOCKS


def test_graceful_drain_leaves_tombstone_and_survivor_takes_over(
        tmp_path):
    """Host 1's drain is requested before it starts: it leaves at the
    first epoch boundary with a tombstone, and host 0 sees the tombstone
    at once (a 600 s timeout would hang the test) and finishes alone."""
    X, y, w = _problem()
    base = _fit(HostBlockSource((X, y, w), BLOCKS))
    drain = GracefulDrain()
    drain.request()
    results = {}
    t1 = _host_thread(results, 1, tmp_path,
                      HostBlockSource((X, y, w), BLOCKS), drain=drain,
                      timeout=600.0)
    t0 = _host_thread(results, 0, tmp_path,
                      HostBlockSource((X, y, w), BLOCKS), timeout=600.0)
    _join(t1, t0)
    left, run1 = results[1]
    assert isinstance(left, Preempted)
    assert os.path.exists(run1._tomb_path(1))
    state, run0 = results[0]
    assert not isinstance(state, Exception)
    _assert_state_equal(base, state)
    assert run0.hosts_lost == 1


def test_resume_mid_shuffled_epoch_bit_identical(tmp_path):
    """A preemption mid-shuffled-epoch saves the position in the epoch's
    permutation and the permutation itself (``meta["blocks"]``); the
    resumed run replays that slice and ends with the uninterrupted bits."""
    X, y, w = _problem()
    base = _fit(HostBlockSource((X, y, w), BLOCKS))
    wd, ckpt = tmp_path / "wd", str(tmp_path / "admm.ckpt")
    order = BlockPlan(BLOCKS, seed=SEED).epoch_order(1)
    inj = FaultInjector().preempt_at(block=order[1], epoch=1)
    run = ElasticRun(wd, rank=0, world=1, shuffle_seed=SEED)
    with pytest.raises(Preempted):
        _fit(HostBlockSource((X, y, w), BLOCKS, fault_injector=inj),
             elastic=run, checkpoint_path=ckpt, checkpoint_every=1)
    tree, meta = load_pytree(ckpt)
    assert meta["epoch"] == 1
    assert meta["next_block"] == 2          # a position, not a block id
    assert meta["blocks"] == order          # the epoch's own permutation
    run2 = ElasticRun(wd, rank=0, world=1, shuffle_seed=SEED)
    got = _fit(HostBlockSource((X, y, w), BLOCKS), elastic=run2,
               checkpoint_path=ckpt)
    _assert_state_equal(base, got)
    assert not os.path.exists(ckpt)


def test_crossed_owner_views_recover_via_no_progress_redeal(tmp_path):
    """A block each host believes the other (live) host owns is nobody's
    share and nobody's orphan; after a heartbeat timeout with no
    publication the waiter re-deals every missing block and computes its
    share, then the rest."""
    run = ElasticRun(tmp_path, rank=0, world=2, heartbeat_timeout=0.3,
                     poll_interval=0.02)
    peer = ElasticRun(tmp_path, rank=1, world=2, heartbeat_timeout=0.3,
                      poll_interval=0.02)
    plan = BlockPlan(4, seed=0)
    order = plan.epoch_order(0)
    owner = {b: 1 for b in order}   # rank 0's wrong view
    computed = []

    def compute_publish(blocks):
        computed.extend(blocks)
        for b in blocks:
            run.publish(0, b, np.asarray([float(b)]))

    stop = threading.Event()

    def keep_peer_alive():  # healthy, never publishing
        while not stop.is_set():
            peer.beat()
            time.sleep(0.02)

    t = threading.Thread(target=keep_peer_alive, daemon=True)
    t.start()
    try:
        results = run.collect_epoch(plan, 0, order, owner, compute_publish)
    finally:
        stop.set()
        t.join(timeout=5)
    assert not t.is_alive()
    assert set(results) == set(order)
    assert run.hosts_lost == 0  # the peer was never declared dead
    assert sorted(computed) == sorted(order)


def test_workdir_reuse_isolates_different_problems(tmp_path):
    X, y, w = _problem()
    run = ElasticRun(tmp_path, rank=0, world=1, shuffle_seed=SEED)
    _fit(HostBlockSource((X, y, w), BLOCKS), elastic=run)
    ns1 = run._ns
    base2 = _fit(HostBlockSource((X, y, w), BLOCKS), lamduh=2.0)
    got2 = _fit(HostBlockSource((X, y, w), BLOCKS), elastic=run,
                lamduh=2.0)
    assert run._ns != ns1
    _assert_state_equal(base2, got2)
    plain = streaming.streamed_moments(
        block_fn=HostBlockSource((X, w), BLOCKS), n_blocks=BLOCKS)
    m = streaming.streamed_moments(
        block_fn=HostBlockSource((X, w), BLOCKS), n_blocks=BLOCKS,
        elastic=run)
    for a, b in zip(plain, m):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-4)


def test_elastic_snapshot_rejected_by_nonelastic_resume(tmp_path):
    X, y, w = _problem()
    ckpt = str(tmp_path / "admm.ckpt")
    order = BlockPlan(BLOCKS, seed=SEED).epoch_order(1)
    inj = FaultInjector().preempt_at(block=order[1], epoch=1)
    run = ElasticRun(tmp_path / "wd", rank=0, world=1, shuffle_seed=SEED)
    with pytest.raises(Preempted):
        _fit(HostBlockSource((X, y, w), BLOCKS, fault_injector=inj),
             elastic=run, checkpoint_path=ckpt, checkpoint_every=1)
    with pytest.raises(ValueError, match="different problem"):
        _fit(HostBlockSource((X, y, w), BLOCKS), checkpoint_path=ckpt)


def test_consensus_ledger_counts_the_foreign_blocks(tmp_path):
    """The elastic consensus imports every other host's blocks over the
    cross-host link: ``glm.admm.consensus`` on axis ``pod`` holds their
    bytes, each epoch (world 1: none)."""
    X, y, w = _problem()
    hierarchy.reset_ledger()
    run = ElasticRun(tmp_path / "w1", rank=0, world=1, shuffle_seed=SEED)
    _fit(HostBlockSource((X, y, w), BLOCKS), elastic=run)
    assert hierarchy.ledger_snapshot()["ops"]["glm.admm.consensus"] == \
        {"pod": 0}
    # world 2 where host 1 never launches: host 0 owns its shard at each
    # epoch start, the rest is foreign in its view until re-dealt
    hierarchy.reset_ledger()
    run2 = ElasticRun(tmp_path / "w2", rank=0, world=2, shuffle_seed=SEED,
                      heartbeat_timeout=0.5, poll_interval=0.01)
    _fit(HostBlockSource((X, y, w), BLOCKS), elastic=run2)
    snap = hierarchy.ledger_snapshot()
    assert snap["calls"]["pod/glm.admm.consensus"] == OUTER
    # the first epoch re-deals host 1's shard to host 0, whose owner view
    # then holds every block; later epochs start with host 1 lost
    assert snap["ops"]["glm.admm.consensus"] == {"pod": 0}
    hierarchy.reset_ledger()


# ---------------------------------------------------------------------------
# the loader mode's slot bucket under a roster
# ---------------------------------------------------------------------------


def _ragged_loader():
    """A loader of CSR blocks whose widest rows differ: block 0's widest
    row has 7 nonzeros (bucket 8), the others at most 3 (bucket 4)."""
    rng = np.random.RandomState(5)
    n_b, d = N // BLOCKS, 12
    blocks = []
    for b in range(BLOCKS):
        width = 7 if b == 0 else 3
        dense = np.zeros((n_b, d), np.float32)
        for i in range(n_b):
            cols = rng.choice(d, size=rng.randint(1, width + 1),
                              replace=False)
            dense[i, cols] = rng.randn(cols.size)
        dense[0] = 0.0
        dense[0, :width] = rng.randn(width)  # the widest row is reached
        y = (dense.sum(1) + 0.3 * rng.randn(n_b) > 0).astype(np.float32)
        blocks.append((scipy_sparse.csr_matrix(dense), y,
                       np.ones(n_b, np.float32)))
    return blocks, d


def test_loader_bucket_is_the_same_for_every_roster(tmp_path):
    """Block 0 fixes a loader's slot bucket, whichever block a host reads
    first, so every roster encodes each block at the same width and the
    elastic fit keeps the single-host bits."""
    blocks, d = _ragged_loader()

    def src():
        return HostBlockSource(loader=lambda b: blocks[b], n_blocks=BLOCKS)

    base = _fit(src(), d=d)
    first = src()
    for b in (3, 0, 1):
        assert first.host_block(b)[0].cols.shape[1] == 8
    run = ElasticRun(tmp_path / "w1", rank=0, world=1, shuffle_seed=SEED)
    _assert_state_equal(base, _fit(src(), elastic=run, d=d))

    def fit(source, elastic):
        return _fit(source, elastic=elastic, d=d)

    results = {}
    ts = [_host_thread(results, r, tmp_path / "w2", src(), fit=fit)
          for r in (0, 1)]
    _join(*ts)
    for r in (0, 1):
        _assert_state_equal(base, results[r][0])


# ---------------------------------------------------------------------------
# the port against the JAX elastic loops
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_elastic_admm_matches_jax(tmp_path, kind):
    X, y, w = _problem() if kind == "dense" else _sparse_problem()
    d = X.shape[1]
    kw = _kw()
    run = ElasticRun(tmp_path / "port", rank=0, world=1, shuffle_seed=SEED)
    jrun = jelastic.ElasticRun(str(tmp_path / "jax"), rank=0, world=1,
                               shuffle_seed=SEED)
    _, n_iter, state, _ = tcore.admm_streamed(
        HostBlockSource((X, y, w), BLOCKS), BLOCKS, d, float(N),
        elastic=run, **kw)
    _, jn, jstate, _ = jcore.admm_streamed(
        jstream.HostBlockSource((X, y, w), BLOCKS), BLOCKS, d, float(N),
        elastic=jrun, **kw)
    assert n_iter == int(jn) == OUTER
    for a, b in zip(state, jstate):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **JAX_TOL)
    # the same namespace, the same block files
    assert run._ns == jrun._ns


def test_elastic_moments_match_jax_and_plain(tmp_path):
    rng = np.random.RandomState(1)
    X = (rng.randn(N, 8) * np.linspace(3.0, 0.3, 8) + 1.0).astype(
        np.float32)
    w = rng.rand(N).astype(np.float32)
    run = ElasticRun(tmp_path / "port", rank=0, world=1, shuffle_seed=SEED)
    jrun = jelastic.ElasticRun(str(tmp_path / "jax"), rank=0, world=1,
                               shuffle_seed=SEED)
    m = streaming.streamed_moments(block_fn=HostBlockSource((X, w), BLOCKS),
                                   n_blocks=BLOCKS, elastic=run)
    jm = jstreaming.streamed_moments(
        block_fn=jstream.HostBlockSource((X, w), BLOCKS), n_blocks=BLOCKS,
        elastic=jrun)
    plain = streaming.streamed_moments(
        block_fn=HostBlockSource((X, w), BLOCKS), n_blocks=BLOCKS)
    for a, b, c in zip(m, jm, plain):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **JAX_TOL)
        np.testing.assert_allclose(a.numpy(), c.numpy(), **JAX_TOL)
    assert run._ns == jrun._ns


# ---------------------------------------------------------------------------
# elastic moments and PCA
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["arrays", "loader"])
def test_elastic_moments_roster_invariant_and_matches_plain(tmp_path, mode):
    X, _, w = _problem()
    rows = N // BLOCKS

    def src():
        if mode == "arrays":
            return HostBlockSource((X, w), BLOCKS)
        return HostBlockSource(
            loader=lambda b: (X[b * rows:(b + 1) * rows],
                              w[b * rows:(b + 1) * rows]),
            n_blocks=BLOCKS)

    plain = streaming.streamed_moments(block_fn=src(), n_blocks=BLOCKS)
    run1 = ElasticRun(tmp_path / "w1", rank=0, world=1, shuffle_seed=SEED)
    m1 = streaming.streamed_moments(block_fn=src(), n_blocks=BLOCKS,
                                    elastic=run1)
    # world 2 where host 1 never launches: host 0 computes its shard, sees
    # the silence cross the timeout and takes the dead host's whole shard
    run2 = ElasticRun(tmp_path / "w2", rank=0, world=2, shuffle_seed=SEED,
                      heartbeat_timeout=1.0, poll_interval=0.01)
    m2 = streaming.streamed_moments(block_fn=src(), n_blocks=BLOCKS,
                                    elastic=run2)
    for a, b in zip(m1, m2):
        assert torch.equal(a, b)
    assert run2.blocks_rebalanced > 0
    for a, b in zip(plain, m1):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-4)


def test_elastic_moments_two_hosts_with_a_kill_bit_identical(tmp_path):
    X, _, w = _problem()
    run1 = ElasticRun(tmp_path / "w1", rank=0, world=1, shuffle_seed=SEED)
    m1 = streaming.streamed_moments(block_fn=HostBlockSource((X, w), BLOCKS),
                                    n_blocks=BLOCKS, elastic=run1)
    order = BlockPlan(BLOCKS, seed=SEED).epoch_order(0)
    inj = FaultInjector().die_at(block=BlockPlan.shard(order, 1, [0, 1])[0])

    def moments(source, elastic):
        return streaming.streamed_moments(block_fn=source, n_blocks=BLOCKS,
                                          elastic=elastic)

    results = {}
    ts = [_host_thread(results, r, tmp_path / "w2",
                       HostBlockSource((X, w), BLOCKS),
                       injector=inj if r == 1 else None, timeout=1.0,
                       fit=moments) for r in (0, 1)]
    _join(*ts)
    assert isinstance(results[1][0], SimulatedHostDeath)
    got, run0 = results[0]
    for a, b in zip(m1, got):
        assert torch.equal(a, b)
    assert run0.hosts_lost == 1 and run0.blocks_rebalanced >= 1


def test_elastic_pca_fit_blocks(tmp_path):
    X, _, w = _problem()
    run = ElasticRun(tmp_path, rank=0, world=1, shuffle_seed=SEED)
    est = streaming.pca_fit_blocks(HostBlockSource((X, w), BLOCKS), BLOCKS,
                                   2, elastic=run)
    plain = streaming.pca_fit_blocks(HostBlockSource((X, w), BLOCKS),
                                     BLOCKS, 2)
    np.testing.assert_allclose(est.components_, plain.components_,
                               rtol=1e-4, atol=1e-5)
    np.testing.assert_allclose(est.explained_variance_,
                               plain.explained_variance_, rtol=1e-4)


# ---------------------------------------------------------------------------
# the facade
# ---------------------------------------------------------------------------


def test_facade_fit_blocks_elastic_matches_plain(tmp_path):
    from dask_ml_tpu_torch.linear_model import LogisticRegression

    X, y, w = _problem()

    def fit(elastic=None):
        est = LogisticRegression(
            solver="admm", C=1.0, max_iter=OUTER,
            solver_kwargs={"abstol": 0.0, "reltol": 0.0})
        src = HostBlockSource((X, y, w), BLOCKS)
        est.fit_blocks(src, BLOCKS, N, D, classes=[0, 1], elastic=elastic)
        return est, src

    (base, _), (got, src) = fit(), fit(
        ElasticRun(tmp_path, rank=0, world=1, shuffle_seed=SEED))
    np.testing.assert_array_equal(base.coef_, got.coef_)
    np.testing.assert_array_equal(base.intercept_, got.intercept_)
    # the intercept copy's counters land on the caller's source
    assert src.blocks_started == BLOCKS * OUTER


def test_elastic_spans_and_per_host_bytes(tmp_path):
    """With the knob on, an elastic fit records its epochs, consensus steps
    and moment pass as spans, and its source's bytes under the host's
    rank; with it off, nothing."""
    from dask_ml_tpu_torch.parallel import telemetry

    X, y, w = _problem()
    telemetry.reset_telemetry()
    try:
        with config_context(device="cpu", telemetry=True):
            run = ElasticRun(tmp_path, rank=0, world=1, shuffle_seed=SEED)
            src = HostBlockSource((X, y, w), BLOCKS)
            _fit(src, elastic=run)
            msrc = HostBlockSource((X, w), BLOCKS)
            streaming.streamed_moments(block_fn=msrc, n_blocks=BLOCKS,
                                       elastic=run)
            names = [r["name"] for r in telemetry.spans()]
            c = telemetry.counters()
        assert names.count("elastic.epoch") == OUTER
        assert names.count("elastic.consensus") == OUTER
        assert names.count("elastic.moments") == 1
        assert src.host_rank == msrc.host_rank == 0
        assert c["stream.bytes{host=0}"] == (src.bytes_streamed
                                             + msrc.bytes_streamed)
        telemetry.reset_telemetry()
        _fit(HostBlockSource((X, y, w), BLOCKS),
             elastic=ElasticRun(tmp_path / "off", rank=0, world=1))
        assert telemetry.counters() == {} and telemetry.spans() == []
    finally:
        telemetry.reset_telemetry()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_elastic_snapshot_resumes_across_packages(tmp_path, writer):
    """An elastic snapshot (and the blocks published before it) written by
    one package is resumed by the other: the bind and the namespace digest
    are the same, so the resumed fit lands within the packages' tolerance
    of the writer's uninterrupted run."""
    from dask_ml_tpu.parallel import faults as jfaults

    X, y, w = _problem()
    wd, ckpt = tmp_path / "wd", str(tmp_path / "admm.ckpt")
    order = BlockPlan(BLOCKS, seed=SEED).epoch_order(1)
    kw = _kw()
    if writer == "jax":
        inj = jfaults.FaultInjector().preempt_at(block=order[1], epoch=1)
        with pytest.raises(jfaults.Preempted):
            jcore.admm_streamed(
                jstream.HostBlockSource((X, y, w), BLOCKS,
                                        fault_injector=inj),
                BLOCKS, D, float(N), checkpoint_path=ckpt,
                checkpoint_every=1, elastic=jelastic.ElasticRun(
                    str(wd), rank=0, world=1, shuffle_seed=SEED), **kw)
        got = _fit(HostBlockSource((X, y, w), BLOCKS), checkpoint_path=ckpt,
                   elastic=ElasticRun(wd, rank=0, world=1,
                                      shuffle_seed=SEED))
    else:
        inj = FaultInjector().preempt_at(block=order[1], epoch=1)
        with pytest.raises(Preempted):
            _fit(HostBlockSource((X, y, w), BLOCKS, fault_injector=inj),
                 checkpoint_path=ckpt, checkpoint_every=1,
                 elastic=ElasticRun(wd, rank=0, world=1, shuffle_seed=SEED))
        _, _, jstate, _ = jcore.admm_streamed(
            jstream.HostBlockSource((X, y, w), BLOCKS), BLOCKS, D, float(N),
            checkpoint_path=ckpt, elastic=jelastic.ElasticRun(
                str(wd), rank=0, world=1, shuffle_seed=SEED), **kw)
        got = tuple(np.asarray(t) for t in jstate)
    base = _fit(HostBlockSource((X, y, w), BLOCKS))
    for a, b in zip(got, base):
        np.testing.assert_allclose(a, b, **JAX_TOL)
    assert not os.path.exists(ckpt)

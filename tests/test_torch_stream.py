"""The PyTorch port's streaming and fault substrate on the CPU:
``parallel/stream.py`` (``HostBlockSource``, ``prefetched_scan``),
``parallel/faults.py`` (``RetryPolicy``, ``GracefulDrain``,
``ScanCheckpoint``, ``FaultInjector``), the frame codec and the snapshot
files of ``checkpoint.py``.

It mirrors ``tests/test_stream.py``, the streaming half of
``tests/test_faults.py`` and the snapshot sweeps of
``tests/test_checkpoint.py``: the same scenarios, the same counts. The
port runs under ``config_context(device="cpu")``, where a block "copy"
is a fresh CPU tensor. Snapshot files are exchanged with the JAX
package's ``save_pytree`` / ``load_pytree`` in both directions.
"""

import os
import signal
import time

import numpy as np
import pytest
import scipy.sparse as scipy_sparse
import torch

from dask_ml_tpu import checkpoint as jckpt
from dask_ml_tpu.parallel import framing as jframing
from dask_ml_tpu_torch import checkpoint as ckpt
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch.ops.sparse import SparseRows, ell_from_csr
from dask_ml_tpu_torch.parallel import framing
from dask_ml_tpu_torch.parallel.faults import (BlockFetchError, FaultInjector,
                                               GracefulDrain,
                                               InjectedLoaderError,
                                               InjectedTransferError,
                                               Preempted, RetryPolicy,
                                               ScanCheckpoint,
                                               scan_checkpoint_scope)
from dask_ml_tpu_torch.parallel.shapes import pad_tail
from dask_ml_tpu_torch.parallel.stream import HostBlockSource, prefetched_scan


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


def _no_sleep(_):
    pass


def _policy(**kw):
    kw.setdefault("sleep", _no_sleep)
    return RetryPolicy(**kw)


def _arrays(n=64, d=3, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    w = rng.rand(n).astype(np.float32)
    return X, w


def _problem(n=64, d=4, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    beta = rng.randn(d).astype(np.float32)
    y = (X @ beta + 0.3 * rng.randn(n) > 0).astype(np.float32)
    return X, y, np.ones(n, np.float32)


# ---------------------------------------------------------------------------
# HostBlockSource
# ---------------------------------------------------------------------------


def test_constructor_validation():
    X, w = _arrays()
    with pytest.raises(ValueError, match="exactly one"):
        HostBlockSource((X, w), 4, loader=lambda b: (X, w))
    with pytest.raises(ValueError, match="exactly one"):
        HostBlockSource(n_blocks=4)
    with pytest.raises(ValueError, match="n_blocks"):
        HostBlockSource((X, w), 0)
    with pytest.raises(ValueError, match="equal"):
        HostBlockSource((X, w), 5, pad_tail=False)
    # default: the ragged tail pads with weight-0 zeros instead
    src = HostBlockSource((X, w), 5)
    assert src._rows == 13
    Xt, wt = src.host_block(4)
    assert Xt.shape[0] == 13
    np.testing.assert_array_equal(Xt[:12], X[52:])
    np.testing.assert_array_equal(Xt[12:], 0)
    np.testing.assert_array_equal(wt[12:], 0)
    with pytest.raises(ValueError, match="axis 0"):
        HostBlockSource((X, w[:-1]), 4)
    # a tuple whose last array is not 1-D keeps the strict contract
    with pytest.raises(ValueError, match="equal"):
        HostBlockSource((w, X), 5)


def test_unported_options_name_their_queue_item():
    X, w = _arrays()
    # the wire cast (item 9) is ported: a storage dtype is taken as given
    assert HostBlockSource((X, w), 4, storage_dtype=np.float16
                           ).storage_dtype == torch.float16
    with pytest.raises(NotImplementedError, match="item 10"):
        HostBlockSource((X, w), 4, host_rank=0)
    src = HostBlockSource((X, w), 4, storage_dtype=None)
    assert src.storage_dtype is None
    with pytest.raises(NotImplementedError, match="item 10"):
        prefetched_scan(lambda c, b, blk: (c, None), 0, src, blocks=[0, 1])


def test_host_block_slicing_and_range():
    X, w = _arrays(n=64)
    src = HostBlockSource((X, w), 4)
    for b in range(4):
        Xb, wb = src.host_block(b)
        np.testing.assert_array_equal(Xb, X[b * 16:(b + 1) * 16])
        np.testing.assert_array_equal(wb, w[b * 16:(b + 1) * 16])
    with pytest.raises(IndexError):
        src.host_block(4)
    with pytest.raises(IndexError):
        src.host_block(-1)


def test_read_only_arrays_are_owned_as_writable_copies():
    X, w = _arrays(n=64)
    X.setflags(write=False)
    src = HostBlockSource((X, w), 4)
    blk = src.take(1)
    assert isinstance(blk[0], torch.Tensor)
    np.testing.assert_array_equal(blk[0].numpy(), X[16:32])


def test_loader_mode():
    X, w = _arrays(n=64)
    calls = []

    def loader(b):
        calls.append(b)
        return X[b * 16:(b + 1) * 16], w[b * 16:(b + 1) * 16]

    src = HostBlockSource(loader=loader, n_blocks=4)
    Xb, wb = src.take(2)
    assert isinstance(Xb, torch.Tensor) and Xb.device.type == "cpu"
    np.testing.assert_array_equal(Xb.numpy(), X[32:48])
    assert calls == [2]


def test_loader_mode_pads_short_tail_and_peeks_block0_on_resume():
    X, w = _arrays(n=60)

    def loader(b):
        return X[b * 16:(b + 1) * 16], w[b * 16:(b + 1) * 16]

    src = HostBlockSource(loader=loader, n_blocks=4)
    Xt, wt = src.host_block(3)  # first read is the tail: block 0 is peeked
    assert Xt.shape == (16, 3)
    np.testing.assert_array_equal(Xt[:12], X[48:])
    np.testing.assert_array_equal(wt[12:], 0)

    def bad(b):
        rows = 10 if b == 1 else 16
        return X[:rows], w[:rows]

    src = HostBlockSource(loader=bad, n_blocks=4)
    src.host_block(0)
    with pytest.raises(ValueError, match="ragged TAIL"):
        src.host_block(1)


def test_pad_tail_dense_and_sparse():
    X, w = _arrays(n=5)
    A = ell_from_csr(scipy_sparse.csr_matrix(X))
    Xp, Ap, wp = pad_tail((X, A, w), 8)
    assert Xp.shape == (8, 3) and wp.shape == (8,)
    np.testing.assert_array_equal(Xp[5:], 0)
    assert isinstance(Ap, SparseRows) and Ap.values.shape[0] == 8
    np.testing.assert_array_equal(Ap.values[5:], 0)
    np.testing.assert_array_equal(Ap.cols[5:], 0)
    with pytest.raises(ValueError, match="more than"):
        pad_tail((X,), 4)


def test_sparse_elements_arrays_and_loader_modes():
    rng = np.random.RandomState(0)
    D = (rng.rand(64, 9) < 0.3) * rng.randn(64, 9)
    D = D.astype(np.float32)
    D[5, :] = 1.0  # the widest row decides the source-wide slot bucket
    csr = scipy_sparse.csr_matrix(D)
    w = np.ones(64, np.float32)
    src = HostBlockSource((csr, w), 4)
    assert src._ell_k[0] == 16
    A0, _ = src.take(0)
    assert isinstance(A0, SparseRows) and A0.values.shape == (16, 16)
    assert isinstance(A0.values, torch.Tensor)
    # every block, the narrow ones too, shares the bucket
    A3, _ = src.take(3)
    assert A3.values.shape == (16, 16)
    dense = np.zeros((16, 9), np.float32)
    np.add.at(dense, (np.arange(16)[:, None], A3.cols.numpy()),
              A3.values.numpy())
    np.testing.assert_array_equal(dense, D[48:])
    # logical bytes count the dense equivalent
    assert src.logical_bytes_streamed == 2 * (16 * 9 * 4 + 16 * 4)

    # a container element in arrays mode streams both leaves
    cont = ell_from_csr(csr)
    src2 = HostBlockSource((cont, w), 4)
    B1, _ = src2.take(1)
    np.testing.assert_array_equal(B1.values.numpy(), cont.values[16:32])
    np.testing.assert_array_equal(B1.cols.numpy(), cont.cols[16:32])

    # loader mode fixes the bucket from the first block seen
    src3 = HostBlockSource(
        loader=lambda b: (csr[b * 16:(b + 1) * 16], w[b * 16:(b + 1) * 16]),
        n_blocks=4)
    A1, _ = src3.take(1)
    assert A1.values.shape[1] == src3._ell_k[("loader", 0)]
    with pytest.raises(BlockFetchError, match="widen k"):
        src3.take(0)  # block 0's row of 9 nonzeros exceeds the bucket


def test_inflight_bookkeeping_and_stats():
    X, w = _arrays(n=64)
    src = HostBlockSource((X, w), 4)
    src.start(0)
    src.start(0)  # idempotent while in flight
    assert src.blocks_started == 1
    blk = src.take(0)
    assert len(blk) == 2
    src.start(0)  # released: the block can stream again next epoch
    assert src.blocks_started == 2
    per_block = X[:16].nbytes + w[:16].nbytes
    assert src.bytes_streamed == 2 * per_block
    src.discard_inflight()
    assert src._inflight == {}
    src.reset_stats()
    assert src.bytes_streamed == 0 and src.blocks_started == 0


def test_reset_stats_neutralizes_inflight_rollback():
    X, w = _arrays(n=64)
    src = HostBlockSource((X, w), 4)
    src.start(1)
    src.reset_stats()
    src.discard_inflight()  # issued before the reset: nothing subtracted
    assert src.bytes_streamed == 0 and src.blocks_started == 0


def _double_X(blk):
    X, w = blk
    return 2.0 * X, w


def test_out_struct_and_transform():
    X, w = _arrays(n=64, d=3)
    src = HostBlockSource((X, w), 4)
    s = src.out_struct
    assert tuple(s[0].shape) == (16, 3) and tuple(s[1].shape) == (16,)
    assert s[0].device.type == "meta" and s[0].dtype == torch.float32

    src2 = src.with_transform(_double_X)
    assert tuple(src2.out_struct[0].shape) == (16, 3)
    assert src.transform is None
    a = src.with_transform(_double_X).with_transform(_double_X)
    Xb, wb = a.transform(tuple(torch.as_tensor(t)
                               for t in src.host_block(1)))
    np.testing.assert_allclose(Xb.numpy(), 4.0 * X[16:32], rtol=1e-6)


@pytest.mark.parametrize("prefetch", [0, 1, 2, 8])
def test_prefetched_scan_accumulates(prefetch):
    X, w = _arrays(n=64)
    src = HostBlockSource((X, w), 4, prefetch=prefetch)

    def step(carry, b, blk):
        Xb, wb = blk
        return carry + torch.sum(Xb * wb[:, None]), b

    carry, outs = prefetched_scan(step, torch.tensor(0.0), src)
    np.testing.assert_allclose(float(carry), float(np.sum(X * w[:, None])),
                               rtol=1e-5)
    assert outs == list(range(4))
    assert src.blocks_started == 4
    assert src._inflight == {}


def test_prefetched_scan_wrap_primes_next_epoch():
    X, w = _arrays(n=64)
    src = HostBlockSource((X, w), 4, prefetch=2)

    def step(carry, b, blk):
        return carry, None

    prefetched_scan(step, None, src, wrap=True)
    assert sorted(src._inflight) == [0, 1]
    assert src.blocks_started == 6
    prefetched_scan(step, None, src, wrap=False)
    assert src.blocks_started == 8
    assert src._inflight == {}


def test_parallel_package_exports():
    from dask_ml_tpu_torch import parallel

    assert parallel.HostBlockSource is HostBlockSource
    assert parallel.prefetched_scan is prefetched_scan
    assert parallel.pad_tail is pad_tail
    for name in ("BlockFetchError", "FaultInjector", "GracefulDrain",
                 "Preempted", "RetryPolicy", "ScanCheckpoint"):
        assert hasattr(parallel, name)


# ---------------------------------------------------------------------------
# RetryPolicy
# ---------------------------------------------------------------------------


def test_retry_policy_classification():
    p = _policy()
    assert p.is_transient(OSError("disk"))
    assert p.is_transient(TimeoutError("slow"))
    assert p.is_transient(InjectedLoaderError("x"))
    assert p.is_transient(InjectedTransferError("x"))
    assert not p.is_transient(ValueError("shape mismatch"))
    assert not p.is_transient(KeyError("k"))
    # the one device error worth a retry: the allocator's out-of-memory
    oom = torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to "
                                      "allocate 2.00 GiB")
    assert p.is_transient(oom)
    assert not _policy(retry_device_errors=False).is_transient(oom)
    # a CUDA error leaves the context broken: never retried
    sticky = RuntimeError("CUDA error: an illegal memory access was "
                          "encountered")
    assert not p.is_transient(sticky)
    assert not p.is_transient(torch.AcceleratorError(
        "CUDA error: unspecified launch failure"))
    # a jaxlib runtime error means nothing here
    XlaRuntimeError = type("XlaRuntimeError", (RuntimeError,), {})
    assert not p.is_transient(XlaRuntimeError("transfer failed"))
    custom = _policy(classify=lambda e: isinstance(e, ValueError))
    assert custom.is_transient(ValueError("now transient"))


@pytest.mark.parametrize("kind", ["sticky", "oom"])
def test_retry_policy_device_errors(kind):
    """A sticky CUDA error propagates at once with no retry; an
    out-of-memory is retried and recovers."""
    p = _policy(max_retries=3)
    calls = []

    def op():
        calls.append(1)
        if kind == "sticky":
            raise RuntimeError("CUDA error: an illegal memory access was "
                               "encountered")
        if len(calls) < 2:
            raise torch.cuda.OutOfMemoryError("CUDA out of memory")
        return "ok"

    if kind == "sticky":
        with pytest.raises(RuntimeError, match="illegal memory access"):
            p.run(op, kind="device-put")
        assert len(calls) == 1
        assert p.stats()["retries"] == 0 and p.stats()["giveups"] == 0
    else:
        assert p.run(op, kind="device-put") == "ok"
        assert p.stats()["by_kind"] == {"device-put": 1}


def test_retry_policy_succeeds_after_transients_and_counts():
    p = _policy(max_retries=3)
    calls = []

    def flaky():
        calls.append(1)
        if len(calls) < 3:
            raise OSError("hiccup")
        return "ok"

    assert p.run(flaky, kind="block-load") == "ok"
    s = p.stats()
    assert s["retries"] == 2 and s["giveups"] == 0
    assert s["by_kind"] == {"block-load": 2}
    p.reset_stats()
    assert p.stats()["retries"] == 0


def test_retry_policy_exhaustion_reraises_and_counts_giveup():
    p = _policy(max_retries=2)
    with pytest.raises(OSError, match="down"):
        p.run(lambda: (_ for _ in ()).throw(OSError("down")))
    s = p.stats()
    assert (s["retries"], s["giveups"], s["by_kind"]) == (2, 1, {"op": 2})


def test_retry_policy_nontransient_propagates_immediately():
    p = _policy(max_retries=5)
    calls = []

    def bad():
        calls.append(1)
        raise ValueError("not transient")

    with pytest.raises(ValueError):
        p.run(bad)
    assert len(calls) == 1 and p.stats()["retries"] == 0


def test_retry_policy_backoff_deterministic_and_bounded():
    a = RetryPolicy(seed=7, base_delay=0.1, max_delay=0.5, jitter=0.5)
    b = RetryPolicy(seed=7, base_delay=0.1, max_delay=0.5, jitter=0.5)
    da = [a.backoff_delay(i) for i in range(6)]
    assert da == [b.backoff_delay(i) for i in range(6)]
    for i, d in enumerate(da):
        base = min(0.1 * 2.0 ** i, 0.5)
        assert base <= d <= base * 1.5
    c = RetryPolicy(seed=8, base_delay=0.1, max_delay=0.5, jitter=0.5)
    assert [c.backoff_delay(i) for i in range(6)] != da


def test_retry_policy_deadline_caps_total_backoff():
    p = _policy(max_retries=100, base_delay=0.2, multiplier=1.0,
                jitter=0.0, deadline=0.5)
    with pytest.raises(OSError):
        p.run(lambda: (_ for _ in ()).throw(OSError("down")))
    s = p.stats()
    assert s["retries"] == 3 and s["giveups"] == 1


# ---------------------------------------------------------------------------
# HostBlockSource under injected faults
# ---------------------------------------------------------------------------


def test_loader_mode_survives_flaky_storage_with_exact_stats():
    X, y, w = _problem(n=64)
    reads = []

    def loader(b):
        reads.append(b)
        s = b * 16
        return X[s:s + 16], y[s:s + 16], w[s:s + 16]

    inj = FaultInjector().fail_load(2, times=2)
    pol = _policy(max_retries=3)
    src = HostBlockSource(loader=loader, n_blocks=4, retry_policy=pol,
                          fault_injector=inj)

    def step(carry, b, blk):
        return carry + torch.sum(blk[0]), b

    carry, outs = prefetched_scan(step, torch.tensor(0.0), src)
    np.testing.assert_allclose(float(carry), float(np.sum(X)), rtol=1e-5)
    assert outs == [0, 1, 2, 3]
    assert reads == [0, 1, 2, 3]
    assert inj.injected["load"] == 2
    assert pol.stats()["by_kind"] == {"block-load": 2}
    assert src.blocks_started == 4
    assert src.bytes_streamed == X.nbytes + y.nbytes + w.nbytes


def test_transfer_retry_does_not_double_count_bytes():
    X, y, w = _problem(n=64)
    inj = FaultInjector().fail_transfer(1, times=2)
    pol = _policy(max_retries=3)
    src = HostBlockSource((X, y, w), 4, retry_policy=pol, fault_injector=inj)
    clean = HostBlockSource((X, y, w), 4)
    for b in range(4):
        for t, c in zip(src.take(b), clean.take(b)):
            assert torch.equal(t, c)
    assert inj.injected["transfer"] == 2
    assert src.blocks_started == clean.blocks_started == 4
    assert src.bytes_streamed == clean.bytes_streamed
    assert pol.stats()["by_kind"] == {"device-put": 2}


def test_failed_start_without_retry_counts_nothing():
    X, y, w = _problem(n=64)
    inj = FaultInjector().fail_transfer(0, times=1)
    src = HostBlockSource((X, y, w), 4, fault_injector=inj)
    with pytest.raises(InjectedTransferError):
        src.start(0)
    assert src.blocks_started == 0 and src.bytes_streamed == 0
    assert src._inflight == {}


def test_take_recovers_from_dead_start_and_names_block_on_terminal():
    X, y, w = _problem(n=64)
    inj = FaultInjector().fail_transfer(1, times=1)
    src = HostBlockSource((X, y, w), 4, fault_injector=inj)
    with pytest.raises(InjectedTransferError):
        src.start(1)
    assert len(src.take(1)) == 3
    assert src.blocks_started == 1

    inj2 = FaultInjector().fail_transfer(2, times=100)
    pol = _policy(max_retries=1)
    src2 = HostBlockSource((X, y, w), 4, retry_policy=pol,
                           fault_injector=inj2)
    with pytest.raises(BlockFetchError, match=r"block 2/4"):
        src2.take(2)
    assert pol.stats()["giveups"] == 1


def test_injector_delay_and_random_failures_are_deterministic():
    X, y, w = _problem(n=64)
    inj = FaultInjector(seed=3).delay_load(0, 0.05)
    src = HostBlockSource((X, y, w), 4, fault_injector=inj)
    t0 = time.perf_counter()
    src.take(0)
    assert time.perf_counter() - t0 >= 0.05
    assert inj.injected["delay"] == 1

    def failures(seed):
        inj = FaultInjector(seed=seed).random_load_failures(0.5)
        src = HostBlockSource((X, y, w), 4, fault_injector=inj,
                              retry_policy=_policy(max_retries=10))
        for b in range(4):
            src.take(b)
        return inj.injected["load"]

    assert failures(11) == failures(11)


def test_discard_inflight_rolls_back_unconsumed_stats():
    X, y, w = _problem(n=64)
    src = HostBlockSource((X, y, w), 4)
    src.take(0)
    src.start(1)
    src.start(2)
    assert src.blocks_started == 3
    src.discard_inflight()
    per_block = (X.nbytes + y.nbytes + w.nbytes) // 4
    assert src.blocks_started == 1
    assert src.bytes_streamed == per_block
    assert src._inflight == {}


# ---------------------------------------------------------------------------
# GracefulDrain and ScanCheckpoint
# ---------------------------------------------------------------------------


def test_graceful_drain_traps_and_restores_signal_handlers():
    drain = GracefulDrain(signals=(signal.SIGTERM,))
    prev = signal.getsignal(signal.SIGTERM)
    with drain:
        assert drain.installed
        signal.raise_signal(signal.SIGTERM)
        assert drain.requested
    assert signal.getsignal(signal.SIGTERM) is prev
    drain.clear()
    assert not drain.requested


def test_graceful_drain_reentrant_same_drain_installs_once():
    drain = GracefulDrain(signals=(signal.SIGTERM,))
    prev = signal.getsignal(signal.SIGTERM)
    with drain:
        installed = signal.getsignal(signal.SIGTERM)
        with drain:
            assert signal.getsignal(signal.SIGTERM) is installed
            assert drain._prev[signal.SIGTERM] is prev
            signal.raise_signal(signal.SIGTERM)
            assert drain.requested
        assert signal.getsignal(signal.SIGTERM) is installed
    assert signal.getsignal(signal.SIGTERM) is prev


def test_graceful_drain_distinct_drains_chain_one_signal_reaches_both():
    outer, inner = (GracefulDrain(signals=(signal.SIGTERM,)),
                    GracefulDrain(signals=(signal.SIGTERM,)))
    prev = signal.getsignal(signal.SIGTERM)
    with outer:
        with inner:
            signal.raise_signal(signal.SIGTERM)
            assert inner.requested and outer.requested
        outer.clear()
        signal.raise_signal(signal.SIGTERM)
        assert outer.requested
    assert signal.getsignal(signal.SIGTERM) is prev


def test_graceful_drain_does_not_forward_to_foreign_handlers():
    fired = []
    prev = signal.signal(signal.SIGTERM, lambda *_: fired.append(1))
    try:
        drain = GracefulDrain(signals=(signal.SIGTERM,))
        with drain:
            signal.raise_signal(signal.SIGTERM)
            assert drain.requested
            assert fired == []
        signal.raise_signal(signal.SIGTERM)
        assert fired == [1]
    finally:
        signal.signal(signal.SIGTERM, prev)


def test_graceful_drain_off_main_thread_is_request_only():
    import threading

    out = {}

    def run():
        drain = GracefulDrain(signals=(signal.SIGTERM,))
        with drain:
            out["installed"] = drain.installed
            drain.request()
            out["requested"] = drain.requested

    t = threading.Thread(target=run)
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    assert out == {"installed": False, "requested": True}


def test_prefetched_scan_drain_flag_snapshots_and_raises(tmp_path):
    X, y, w = _problem(n=64)
    src = HostBlockSource((X, y, w), 4)
    drain = GracefulDrain()
    ck = ScanCheckpoint(str(tmp_path / "scan.ckpt"), every=100, drain=drain,
                        bind={"what": "test"})
    seen = []

    def step(carry, b, blk):
        seen.append(b)
        if b == 1:
            drain.request()
        return carry + 1, b

    with pytest.raises(Preempted) as ei:
        prefetched_scan(step, 0, src, checkpoint=ck)
    assert seen == [0, 1]
    assert ei.value.path == ck.path
    assert src._inflight == {}

    carry, outs, next_block, epoch = ck.load()
    assert (int(carry), next_block, epoch) == (2, 2, 0)
    assert [int(o) for o in outs] == [0, 1]
    seen.clear()
    carry, outs = prefetched_scan(step, int(carry), src,
                                  start_block=next_block,
                                  outs=[int(o) for o in outs])
    assert seen == [2, 3] and carry == 4 and outs == [0, 1, 2, 3]


def test_prefetched_scan_real_sigterm_drains(tmp_path):
    """A real SIGTERM inside a checkpoint scope: the block in flight
    finishes, the snapshot is saved, Preempted is raised."""
    X, y, w = _problem(n=64)
    src = HostBlockSource((X, y, w), 4)
    path = str(tmp_path / "sig.ckpt")

    def step(carry, b, blk):
        if b == 2:
            signal.raise_signal(signal.SIGTERM)
        return carry + torch.sum(blk[0]), None

    with scan_checkpoint_scope(path, every=100, bind={"k": 1}) as ck:
        with pytest.raises(Preempted):
            prefetched_scan(step, torch.tensor(0.0), src, checkpoint=ck)
    carry, _, next_block, _ = ScanCheckpoint(path, bind={"k": 1}).load()
    assert next_block == 3
    np.testing.assert_allclose(float(carry), float(X[:48].sum()), rtol=1e-5)


def test_scan_checkpoint_interval_and_bind_mismatch(tmp_path):
    X, y, w = _problem(n=64)
    src = HostBlockSource((X, y, w), 4)
    path = str(tmp_path / "scan.ckpt")
    ck = ScanCheckpoint(path, every=2, bind={"n_blocks": 4})

    def step(carry, b, blk):
        return carry + 1, None

    prefetched_scan(step, 0, src, checkpoint=ck)
    assert ck.saves == 2
    carry, outs, next_block, epoch = ck.load()
    assert int(carry) == 4 and next_block == 4

    with pytest.raises(ValueError, match="different problem"):
        ScanCheckpoint(path, bind={"n_blocks": 8}).load()

    class Other(ScanCheckpoint):
        KIND = "lloyd_bounded"

    with pytest.raises(ValueError, match="not a lloyd_bounded snapshot"):
        Other(path).load()
    ck.delete()
    ck.delete()  # a second delete is a no-op
    assert ck.load() is None


def test_injected_preemption_without_checkpoint_is_loud():
    X, y, w = _problem(n=64)
    inj = FaultInjector().preempt_at(block=1, epoch=0)
    src = HostBlockSource((X, y, w), 4, fault_injector=inj)
    with pytest.raises(Preempted, match="progress was lost"):
        prefetched_scan(lambda c, b, blk: (c, None), None, src)
    assert inj.injected["preempt"] == 1
    # one-shot: the rerun goes through
    prefetched_scan(lambda c, b, blk: (c, None), None, src)


# ---------------------------------------------------------------------------
# frames and snapshot files
# ---------------------------------------------------------------------------


def test_frame_codec_round_trip_and_errors():
    magic = b"TESTMAG1\n"
    payload = bytes(range(256)) * 3
    frame = framing.encode_frame(payload, magic=magic)
    assert len(frame) == framing.header_length(magic) + len(payload)
    assert framing.decode_frame(frame, magic=magic) == payload
    # byte for byte the JAX package's sha256 frame, both ways
    assert frame == jframing.encode_frame(payload, magic=magic)
    assert jframing.decode_frame(frame, magic=magic) == payload
    with pytest.raises(framing.FrameCorruptError, match="magic"):
        framing.decode_frame(b"X" + frame[1:], magic=magic)
    with pytest.raises(framing.FrameTruncatedError):
        framing.decode_frame(frame[:len(magic) + 5], magic=magic)
    with pytest.raises(framing.FrameTruncatedError):
        framing.decode_frame(frame[:-1], magic=magic)
    with pytest.raises(framing.FrameCorruptError, match="trailing"):
        framing.decode_frame(frame + b"\0", magic=magic)
    flipped = bytearray(frame)
    flipped[-3] ^= 1
    with pytest.raises(framing.FrameCorruptError, match="checksum"):
        framing.decode_frame(bytes(flipped), magic=magic)
    for cls in (framing.FrameTruncatedError, framing.FrameCorruptError,
                framing.PayloadError):
        assert issubclass(cls, framing.FrameError)


def test_save_pytree_atomic_overwrite_and_tensors(tmp_path):
    path = str(tmp_path / "snap.ckpt")
    ckpt.save_pytree(path, {"a": np.arange(3)}, meta={"step": 1})
    tree = {"a": torch.arange(4, dtype=torch.int32),
            "t": (torch.ones(2, 3), [torch.zeros(1)]), "n": None, "i": 7}
    ckpt.save_pytree(path, tree, meta={"step": 2})
    tree, meta = ckpt.load_pytree(path)
    assert meta["step"] == 2
    assert isinstance(tree["a"], np.ndarray) and tree["a"].dtype == np.int32
    np.testing.assert_array_equal(tree["a"], np.arange(4))
    assert isinstance(tree["t"], tuple) and isinstance(tree["t"][1], list)
    assert tree["n"] is None and int(tree["i"]) == 7
    assert not [f for f in os.listdir(tmp_path) if f.endswith(".tmp")]
    assert ckpt.load_pytree(str(tmp_path / "missing.ckpt")) is None


def test_save_pytree_truncation_sweep_raises_loudly(tmp_path):
    path = str(tmp_path / "snap.ckpt")
    ckpt.save_pytree(path, {"a": np.arange(5), "b": "x"}, meta={"k": 1})
    blob = open(path, "rb").read()
    for cut in range(len(blob)):
        with open(path, "wb") as f:
            f.write(blob[:cut])
        with pytest.raises(ckpt.CheckpointCorruptError):
            ckpt.load_pytree(path)
    with open(path, "wb") as f:
        f.write(blob)
    tree, meta = ckpt.load_pytree(path)
    assert meta["k"] == 1 and tree["b"] == "x"


def test_save_pytree_bitflip_fails_checksum(tmp_path):
    path = str(tmp_path / "snap.ckpt")
    ckpt.save_pytree(path, {"a": np.arange(64)}, meta={})
    blob = bytearray(open(path, "rb").read())
    for pos in (len(blob) - 1, len(blob) // 2, 12):
        bad = bytearray(blob)
        bad[pos] ^= 0xFF
        with open(path, "wb") as f:
            f.write(bytes(bad))
        with pytest.raises(ckpt.CheckpointCorruptError):
            ckpt.load_pytree(path)


def test_snapshots_cross_between_packages(tmp_path):
    """A snapshot written by the port loads in the JAX package, and one
    the JAX package wrote loads in the port: numpy leaves both ways."""
    p1 = str(tmp_path / "port.ckpt")
    ckpt.save_pytree(p1, {"carry": (torch.arange(3.0), torch.ones(2, 2)),
                          "outs": [torch.zeros(2)]}, meta={"kind": "k"})
    tree, meta = jckpt.load_pytree(p1)
    assert meta == {"kind": "k"}
    np.testing.assert_array_equal(tree["carry"][0], np.arange(3.0))
    assert isinstance(tree["outs"][0], np.ndarray)

    import jax.numpy as jnp

    p2 = str(tmp_path / "jax.ckpt")
    jckpt.save_pytree(p2, {"carry": (jnp.arange(3.0), jnp.ones((2, 2)))},
                      meta={"kind": "j"})
    tree, meta = ckpt.load_pytree(p2)
    assert meta == {"kind": "j"}
    assert isinstance(tree["carry"][1], np.ndarray)
    np.testing.assert_array_equal(tree["carry"][1], np.ones((2, 2)))


def test_io_counts_track_saves_and_loads(tmp_path):
    ckpt.reset_io_counts()
    path = str(tmp_path / "c.ckpt")
    ckpt.save_pytree(path, {"a": np.zeros(1000, np.float32)})
    ckpt.load_pytree(path)
    size = os.path.getsize(path)
    assert ckpt.io_counts["saves"] == 1 and ckpt.io_counts["loads"] == 1
    assert ckpt.io_counts["save_bytes"] == size == ckpt.io_counts[
        "load_bytes"]
    assert ckpt.io_counts["save_seconds"] > 0

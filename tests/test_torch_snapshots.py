"""The port's content-addressed snapshot distribution
(``dask_ml_tpu_torch/parallel/snapshots.py``) on the CPU: the cases of
``tests/test_snapshots.py`` run against the port (manifest layout, chunk
cache hygiene, resumable transfer, the typed faults: a truncation at every
chunk boundary resumes exactly, a bit flip in any chunk fails loudly and
is never retried or cached, a stale cache entry is discarded and fetched
anew, the ``slow_link`` plan slows one machine's link), then the two
packages against each other: one file gives the same manifest in both, a
port client fetches from a JAX server and a JAX client from a port server,
byte for byte, and a chunk cache filled by either serves the other.
"""

import hashlib
import os

import numpy as np
import pytest

from dask_ml_tpu_torch.parallel.faults import FaultInjector, RetryPolicy
from dask_ml_tpu_torch.parallel.snapshots import (
    ChunkCache,
    SnapshotCorruptError,
    SnapshotServer,
    SnapshotTransferError,
    _json_roundtrip_safe,
    fetch_snapshot,
    manifest_of,
    parse_address,
)


def _write_blob(path, n_bytes, seed=0):
    rng = np.random.default_rng(seed)
    data = rng.integers(0, 256, size=n_bytes, dtype=np.uint8).tobytes()
    with open(path, "wb") as f:
        f.write(data)
    return data


def _no_retry():
    return RetryPolicy(max_retries=0, base_delay=0.001)


def _fast_retry(n=3):
    return RetryPolicy(max_retries=n, base_delay=0.001, max_delay=0.01)


# -- manifest ---------------------------------------------------------------


def test_manifest_chunks_and_total_hash(tmp_path):
    path = str(tmp_path / "snap.bin")
    data = _write_blob(path, 1000)
    man = manifest_of(path, chunk_bytes=256)
    assert man["size"] == 1000
    sizes = [c["size"] for c in man["chunks"]]
    assert sizes == [256, 256, 256, 232]
    assert [c["offset"] for c in man["chunks"]] == [0, 256, 512, 768]
    assert man["total_sha256"] == hashlib.sha256(data).hexdigest()
    for c in man["chunks"]:
        piece = data[c["offset"]:c["offset"] + c["size"]]
        assert c["sha256"] == hashlib.sha256(piece).hexdigest()
    # the manifest travels a JSON control envelope: nothing non-JSON
    assert _json_roundtrip_safe(man) == man


def test_manifest_shares_chunk_addresses_across_versions(tmp_path):
    p1, p2 = str(tmp_path / "v1.bin"), str(tmp_path / "v2.bin")
    data = bytearray(_write_blob(p1, 1024, seed=1))
    data[700] ^= 0xFF  # one byte in the third 256-byte chunk
    with open(p2, "wb") as f:
        f.write(bytes(data))
    m1 = manifest_of(p1, chunk_bytes=256)
    m2 = manifest_of(p2, chunk_bytes=256)
    same = [a["sha256"] == b["sha256"]
            for a, b in zip(m1["chunks"], m2["chunks"])]
    assert same == [True, True, False, True]


def test_parse_address():
    assert parse_address("127.0.0.1:8080") == ("127.0.0.1", 8080)
    with pytest.raises(ValueError):
        parse_address("no-port")
    with pytest.raises(ValueError):
        parse_address("host:notaport")


# -- chunk cache ------------------------------------------------------------


def test_cache_put_get_roundtrip(tmp_path):
    cache = ChunkCache(str(tmp_path / "cache"))
    data = b"hello chunk"
    h = hashlib.sha256(data).hexdigest()
    cache.put(h, data)
    assert cache.get(h) == data
    assert cache.n_hits == 1


def test_cache_put_verifies_address(tmp_path):
    cache = ChunkCache(str(tmp_path / "cache"))
    with pytest.raises(SnapshotCorruptError):
        cache.put(hashlib.sha256(b"other").hexdigest(), b"not other")


def test_cache_rejects_malformed_addresses(tmp_path):
    cache = ChunkCache(str(tmp_path / "cache"))
    for bad in ("", "../evil", "a/b", "x.y"):
        with pytest.raises(ValueError):
            cache.path(bad)


def test_stale_cache_entry_discarded_not_served(tmp_path):
    cache = ChunkCache(str(tmp_path / "cache"))
    data = b"the real bytes"
    h = hashlib.sha256(data).hexdigest()
    # a stale file landed on the colliding path (same name, wrong
    # content): get() must discard it, never serve it
    with open(cache.path(h), "wb") as f:
        f.write(b"stale bytes from an old snapshot")
    assert cache.get(h) is None
    assert cache.n_stale_discarded == 1
    assert not os.path.exists(cache.path(h))


# -- server + fetch ---------------------------------------------------------


@pytest.fixture()
def snap_server(tmp_path):
    path = str(tmp_path / "snap.bin")
    data = _write_blob(path, 1000, seed=7)
    server = SnapshotServer(path, chunk_bytes=256).start()
    yield server, path, data
    server.stop()


def test_fetch_full_then_cached(snap_server, tmp_path):
    server, _path, data = snap_server
    dest = str(tmp_path / "dest.bin")
    cache_dir = str(tmp_path / "cache")
    stats = fetch_snapshot(server.address, dest, cache_dir=cache_dir,
                           retry_policy=_no_retry())
    assert stats["chunks_fetched"] == 4 and stats["chunks_cached"] == 0
    assert stats["bytes_fetched"] == 1000
    with open(dest, "rb") as f:
        assert f.read() == data
    # a respawn on the same machine: every chunk is already cached —
    # the link carries ZERO snapshot bytes (the delta-reship gate)
    dest2 = str(tmp_path / "dest2.bin")
    stats2 = fetch_snapshot(server.address, dest2, cache_dir=cache_dir,
                            retry_policy=_no_retry())
    assert stats2["chunks_fetched"] == 0 and stats2["chunks_cached"] == 4
    assert stats2["bytes_fetched"] == 0
    with open(dest2, "rb") as f:
        assert f.read() == data


def test_version_swap_reships_only_changed_chunks(snap_server, tmp_path):
    server, path, data = snap_server
    cache_dir = str(tmp_path / "cache")
    fetch_snapshot(server.address, str(tmp_path / "d1.bin"),
                   cache_dir=cache_dir, retry_policy=_no_retry())
    # swap the snapshot: flip one byte in chunk 2 (offset 512..768)
    swapped = bytearray(data)
    swapped[600] ^= 0xFF
    with open(path, "wb") as f:
        f.write(bytes(swapped))
    server.refresh()
    stats = fetch_snapshot(server.address, str(tmp_path / "d2.bin"),
                           cache_dir=cache_dir, retry_policy=_no_retry())
    assert stats["chunks_fetched"] == 1  # only the changed chunk
    assert stats["chunks_cached"] == 3
    assert stats["bytes_fetched"] == 256 < stats["bytes_total"]
    with open(str(tmp_path / "d2.bin"), "rb") as f:
        assert f.read() == bytes(swapped)


def test_server_auto_refreshes_on_stamp_change(snap_server, tmp_path):
    server, path, data = snap_server
    # grow the file by one byte so the (mtime_ns, size) stamp is
    # guaranteed to change even under coarse filesystem timestamps
    swapped = bytes(data) + b"\x01"
    with open(path, "wb") as f:
        f.write(swapped)
    # no explicit refresh(): the (mtime_ns, size) stamp triggers it
    stats = fetch_snapshot(server.address, str(tmp_path / "d.bin"),
                           cache_dir=str(tmp_path / "cache"),
                           retry_policy=_no_retry())
    assert stats["manifest_sha256"] == hashlib.sha256(swapped).hexdigest()


def test_transfer_fault_retries_under_policy(snap_server, tmp_path):
    server, _path, data = snap_server
    manifest = manifest_of(_path, chunk_bytes=256)
    by_hash = {c["sha256"]: c for c in manifest["chunks"]}
    blob = data
    calls = {"n": 0}

    def flaky(h):
        calls["n"] += 1
        if calls["n"] % 2 == 1:  # every first attempt per chunk fails
            raise SnapshotTransferError("injected link fault")
        row = by_hash[h]
        return blob[row["offset"]:row["offset"] + row["size"]]

    stats = fetch_snapshot(server.address, str(tmp_path / "d.bin"),
                           cache_dir=str(tmp_path / "cache"),
                           retry_policy=_fast_retry(), fetch_chunk=flaky)
    assert stats["chunks_fetched"] == 4
    with open(str(tmp_path / "d.bin"), "rb") as f:
        assert f.read() == data


def test_transfer_fault_without_retries_fails(snap_server, tmp_path):
    server, _path, _data = snap_server

    def always_down(h):
        raise SnapshotTransferError("link down")

    with pytest.raises(SnapshotTransferError):
        fetch_snapshot(server.address, str(tmp_path / "d.bin"),
                       cache_dir=str(tmp_path / "cache"),
                       retry_policy=_no_retry(), fetch_chunk=always_down)
    assert not os.path.exists(str(tmp_path / "d.bin"))  # no torn dest


# -- fuzz: truncation at every chunk boundary -------------------------------


def test_truncation_at_every_chunk_boundary_resumes_exactly(
        snap_server, tmp_path):
    """Kill the transfer after k chunks, for every k: the re-run must
    fetch EXACTLY the missing suffix (chunks before the kill came from
    the cache) and assemble a byte-identical snapshot."""
    server, _path, data = snap_server
    manifest = manifest_of(server.path, chunk_bytes=256)
    by_hash = {c["sha256"]: c for c in manifest["chunks"]}
    n = len(manifest["chunks"])
    assert n == 4
    for k in range(n):
        cache_dir = str(tmp_path / f"cache-{k}")
        dest = str(tmp_path / f"dest-{k}.bin")
        served = {"n": 0}

        def die_after_k(h, served=served, k=k):
            if served["n"] >= k:
                raise SnapshotTransferError(
                    f"transfer killed at chunk boundary {k}")
            served["n"] += 1
            row = by_hash[h]
            return data[row["offset"]:row["offset"] + row["size"]]

        with pytest.raises(SnapshotTransferError):
            fetch_snapshot(server.address, dest, cache_dir=cache_dir,
                           retry_policy=_no_retry(),
                           fetch_chunk=die_after_k)
        assert not os.path.exists(dest)
        # resume: only the missing suffix ships
        resumed = {"n": 0}

        def serve_all(h, resumed=resumed):
            resumed["n"] += 1
            row = by_hash[h]
            return data[row["offset"]:row["offset"] + row["size"]]

        stats = fetch_snapshot(server.address, dest, cache_dir=cache_dir,
                               retry_policy=_no_retry(),
                               fetch_chunk=serve_all)
        assert stats["chunks_cached"] == k
        assert stats["chunks_fetched"] == n - k == resumed["n"]
        with open(dest, "rb") as f:
            assert f.read() == data


def test_bit_flipped_chunk_fails_loudly_every_position(
        snap_server, tmp_path):
    """A chunk whose bytes do not hash to their address must raise
    SnapshotCorruptError immediately — no retry, no cache write —
    whichever chunk carries the flip."""
    server, _path, data = snap_server
    manifest = manifest_of(server.path, chunk_bytes=256)
    by_hash = {c["sha256"]: c for c in manifest["chunks"]}
    order = [c["sha256"] for c in manifest["chunks"]]
    for flip_at in range(len(order)):
        cache_dir = str(tmp_path / f"cache-flip-{flip_at}")
        attempts = {"n": 0}

        def flip_one(h, flip_at=flip_at, attempts=attempts):
            attempts["n"] += 1
            row = by_hash[h]
            piece = bytearray(
                data[row["offset"]:row["offset"] + row["size"]])
            if order.index(h) == flip_at:
                piece[0] ^= 0x01
            return bytes(piece)

        with pytest.raises(SnapshotCorruptError):
            fetch_snapshot(server.address,
                           str(tmp_path / f"d-{flip_at}.bin"),
                           cache_dir=cache_dir,
                           retry_policy=_fast_retry(),
                           fetch_chunk=flip_one)
        # corruption is NOT transient: exactly flip_at good fetches plus
        # ONE corrupt attempt — the policy never re-ran it
        assert attempts["n"] == flip_at + 1
        # and the poison never reached the cache
        cache = ChunkCache(cache_dir)
        assert cache.get(order[flip_at]) is None


def test_stale_cache_entry_refetched_during_transfer(
        snap_server, tmp_path):
    server, _path, data = snap_server
    manifest = manifest_of(server.path, chunk_bytes=256)
    cache_dir = str(tmp_path / "cache")
    cache = ChunkCache(cache_dir)
    # poison the cache: chunk 1's address holds different bytes
    h1 = manifest["chunks"][1]["sha256"]
    with open(cache.path(h1), "wb") as f:
        f.write(b"x" * 256)
    dest = str(tmp_path / "d.bin")
    stats = fetch_snapshot(server.address, dest, cache_dir=cache_dir,
                           retry_policy=_no_retry())
    assert stats["stale_discarded"] == 1
    assert stats["chunks_fetched"] == 4  # the stale one re-fetched too
    with open(dest, "rb") as f:
        assert f.read() == data


def test_fetch_over_real_wire_after_server_restart(tmp_path):
    """Resume across a SERVER death: kill the server mid-transfer (the
    client sees a transport fault), restart it, re-run — the cache
    carries the prefix over."""
    path = str(tmp_path / "snap.bin")
    data = _write_blob(path, 1000, seed=11)
    cache_dir = str(tmp_path / "cache")
    server = SnapshotServer(path, chunk_bytes=256).start()
    manifest = manifest_of(path, chunk_bytes=256)
    by_hash = {c["sha256"]: c for c in manifest["chunks"]}
    from dask_ml_tpu_torch.parallel.snapshots import _SnapClient

    client = _SnapClient(server.address)
    served = {"n": 0}

    def through_wire_then_die(h):
        if served["n"] >= 2:
            server.stop()  # the real socket goes dark mid-transfer
            raise SnapshotTransferError("server lost")
        served["n"] += 1
        return client.chunk(h)

    with pytest.raises(SnapshotTransferError):
        fetch_snapshot(server.address, str(tmp_path / "d.bin"),
                       cache_dir=cache_dir, retry_policy=_no_retry(),
                       fetch_chunk=through_wire_then_die)
    client.close()
    server2 = SnapshotServer(path, chunk_bytes=256).start()
    try:
        stats = fetch_snapshot(server2.address, str(tmp_path / "d.bin"),
                               cache_dir=cache_dir,
                               retry_policy=_fast_retry())
        assert stats["chunks_cached"] == 2
        assert stats["chunks_fetched"] == 2
        with open(str(tmp_path / "d.bin"), "rb") as f:
            assert f.read() == data
    finally:
        server2.stop()


def test_slow_link_plan_delays_only_target_machine(tmp_path):
    path = str(tmp_path / "snap.bin")
    _write_blob(path, 512, seed=3)
    inj = FaultInjector()
    inj.slow_link("m1", 0.05, chunks=2)
    server = SnapshotServer(path, chunk_bytes=256,
                            fault_injector=inj).start()
    try:
        import time as time_mod

        t0 = time_mod.perf_counter()
        fetch_snapshot(server.address, str(tmp_path / "a.bin"),
                       cache_dir=str(tmp_path / "ca"), machine="m0",
                       retry_policy=_no_retry())
        fast = time_mod.perf_counter() - t0
        t0 = time_mod.perf_counter()
        fetch_snapshot(server.address, str(tmp_path / "b.bin"),
                       cache_dir=str(tmp_path / "cb"), machine="m1",
                       retry_policy=_no_retry())
        slow = time_mod.perf_counter() - t0
        assert inj.injected["slow_link"] == 2
        assert slow >= 0.1  # two chunks x 0.05s
        assert slow > fast
    finally:
        server.stop()


# -- the two packages against each other -----------------------------------


@pytest.mark.parametrize("n_bytes,chunk", [(0, 256), (1, 256), (1000, 256),
                                           (1024, 256), (5000, 4096),
                                           (70_000, 4096)])
def test_manifest_equals_the_jax_package(tmp_path, n_bytes, chunk):
    from dask_ml_tpu.parallel import snapshots as jax_snapshots

    path = str(tmp_path / "snap.bin")
    _write_blob(path, n_bytes, seed=n_bytes)
    assert manifest_of(path, chunk_bytes=chunk) == \
        jax_snapshots.manifest_of(path, chunk_bytes=chunk)


def test_wire_constants_equal_the_jax_package():
    from dask_ml_tpu.parallel import snapshots as jax_snapshots
    from dask_ml_tpu_torch.parallel import snapshots

    assert snapshots.SNAP_MAGIC == jax_snapshots.SNAP_MAGIC
    assert snapshots.DEFAULT_CHUNK_BYTES == jax_snapshots.DEFAULT_CHUNK_BYTES
    # a transfer fault is an OSError in both, so RetryPolicy retries it
    assert issubclass(SnapshotTransferError, OSError)
    assert not issubclass(SnapshotCorruptError, OSError)


def test_port_client_fetches_from_a_jax_server(tmp_path):
    from dask_ml_tpu.parallel.snapshots import SnapshotServer as JaxServer

    path = str(tmp_path / "snap.bin")
    data = _write_blob(path, 3000, seed=21)
    server = JaxServer(path, chunk_bytes=512).start()
    try:
        dest = str(tmp_path / "d.bin")
        stats = fetch_snapshot(server.address, dest,
                               cache_dir=str(tmp_path / "cache"),
                               machine="m0", retry_policy=_no_retry())
        assert stats["bytes_fetched"] == stats["bytes_total"] == 3000
        assert stats["chunks_fetched"] == 6
        with open(dest, "rb") as f:
            assert f.read() == data
        assert server.n_chunks == 6 and server.n_bytes_sent == 3000
    finally:
        server.stop()


def test_jax_client_fetches_from_a_port_server(tmp_path):
    from dask_ml_tpu.parallel.faults import RetryPolicy as JaxRetry
    from dask_ml_tpu.parallel.snapshots import fetch_snapshot as jax_fetch

    path = str(tmp_path / "snap.bin")
    data = _write_blob(path, 3000, seed=22)
    server = SnapshotServer(path, chunk_bytes=512).start()
    try:
        dest = str(tmp_path / "d.bin")
        stats = jax_fetch(server.address, dest,
                          cache_dir=str(tmp_path / "cache"), machine="m1",
                          retry_policy=JaxRetry(max_retries=0))
        assert stats["bytes_fetched"] == stats["bytes_total"] == 3000
        with open(dest, "rb") as f:
            assert f.read() == data
        assert server.n_chunks == 6 and server.n_bytes_sent == 3000
    finally:
        server.stop()


def test_a_chunk_cache_serves_either_package(tmp_path):
    """The cache layout (one ``<sha256>.chunk`` file a chunk) is shared:
    a JAX fetch fills the cache, and a port fetch through it ships no
    byte; the port's server refuses nothing of the JAX manifest."""
    from dask_ml_tpu.parallel.faults import RetryPolicy as JaxRetry
    from dask_ml_tpu.parallel.snapshots import fetch_snapshot as jax_fetch

    path = str(tmp_path / "snap.bin")
    data = _write_blob(path, 2048, seed=23)
    cache_dir = str(tmp_path / "cache")
    server = SnapshotServer(path, chunk_bytes=256).start()
    try:
        jax_fetch(server.address, str(tmp_path / "a.bin"),
                  cache_dir=cache_dir, retry_policy=JaxRetry(max_retries=0))
        stats = fetch_snapshot(server.address, str(tmp_path / "b.bin"),
                               cache_dir=cache_dir, retry_policy=_no_retry())
        assert stats["bytes_fetched"] == 0
        assert stats["chunks_cached"] == stats["chunks_total"] == 8
        with open(str(tmp_path / "b.bin"), "rb") as f:
            assert f.read() == data
    finally:
        server.stop()


def test_machine_fault_plans_follow_the_jax_package():
    """``slow_link`` and ``kill_machine`` give the JAX injector's answers
    call for call, and count the same ``injected`` kinds."""
    from dask_ml_tpu.parallel.faults import FaultInjector as JaxInjector

    port, jax = FaultInjector(), JaxInjector()
    for inj in (port, jax):
        inj.slow_link("m1", 0.25, chunks=3)
        inj.slow_link("m2", 0.5)
        inj.kill_machine("m0", after_results=5)
    for machine in ("m1", "m0", "m1", "m2", "m1", "m1", "m2"):
        assert port.link_delay(machine) == jax.link_delay(machine)
    for n in (0, 4, 5, 6, 9):
        assert port.should_kill_machine("m0", n) == \
            jax.should_kill_machine("m0", n)
    assert port.should_kill_machine("m9", 100) is False
    for kind in ("slow_link", "machine_kill"):
        assert port.injected[kind] == jax.injected[kind]

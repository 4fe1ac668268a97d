"""The port's shared-memory ring (``parallel/shm.py``) and its
negotiation into the port's wire, on the CPU: every case of
``tests/test_shm.py`` run against the port (the received arrays are views
into the segment; the ring survives wraparound at every offset and
out-of-order release; a torn record kills the connection while a payload
that fails its typed decode fails only its frame, under both checksums;
the creator's close unlinks), then parity with the JAX package: a JAX
package client's segment is attached by the port's server and both rings
carry the same records byte for byte.

Segments of tests running in other processes come and go meanwhile, so
the leak checks look at the names a test created, never at ``/dev/shm``
as a whole.
"""

import struct

import numpy as np
import pytest

from dask_ml_tpu_torch.parallel import framing
from dask_ml_tpu_torch.parallel import shm as shm_lib
from dask_ml_tpu_torch.parallel.shm import ShmClient, ShmServer

CHECKSUMS = ("sha256", "crc32c")


def _pair(ring_bytes=1 << 16, checksum="crc32c"):
    cli = ShmClient(ring_bytes=ring_bytes, checksum=checksum)
    srv = ShmServer(cli.segment, ring_bytes=cli.ring_bytes,
                    checksum=checksum)
    return cli, srv


def _close(cli, srv):
    srv.close()
    cli.close(unlink=True)


def _buffer_range(ep):
    base = np.frombuffer(ep._shm.buf, dtype=np.uint8)
    addr = base.__array_interface__["data"][0]
    return addr, addr + base.nbytes


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("checksum", CHECKSUMS)
def test_round_trip_both_directions_and_checksums(checksum):
    cli, srv = _pair(checksum=checksum)
    try:
        rng = np.random.RandomState(0)
        for n in (0, 1, 7, 64, 500):
            x = rng.randn(n, 5).astype(np.float32)
            cli.send({"op": "submit", "id": f"r{n}"}, [x])
            ctrl, arrays, tok = srv.recv(timeout=5.0)
            assert ctrl == {"op": "submit", "id": f"r{n}"}
            assert np.array_equal(arrays[0], x)
            srv.send({"op": "result", "id": ctrl["id"]},
                     [np.asarray(arrays[0])])
            srv.release(tok)
            ctrl2, arrays2, tok2 = cli.recv(timeout=5.0)
            assert ctrl2["id"] == f"r{n}"
            assert np.array_equal(arrays2[0], x)
            cli.release(tok2)
            del arrays, arrays2  # drop the zero-copy views pre-close
    finally:
        _close(cli, srv)


def test_decode_is_zero_copy_into_the_segment():
    """The tentpole pin: a received array's memory IS ring memory."""
    cli, srv = _pair()
    try:
        x = np.arange(1024, dtype=np.float64).reshape(32, 32)
        cli.send({"op": "submit", "id": "z"}, [x])
        ctrl, arrays, tok = srv.recv(timeout=5.0)
        lo, hi = _buffer_range(srv)
        addr = arrays[0].__array_interface__["data"][0]
        assert lo <= addr < hi  # view into the shared segment
        assert addr + arrays[0].nbytes <= hi
        # and a plain copy is NOT in the segment (control case)
        copy_addr = np.array(arrays[0]).__array_interface__["data"][0]
        assert not (lo <= copy_addr < hi)
        del arrays
        srv.release(tok)
    finally:
        _close(cli, srv)


def test_ring_wraparound_at_every_offset():
    """Varying record sizes march the write cursor across the ring
    boundary at many distinct offsets; every message round-trips."""
    cli, srv = _pair(ring_bytes=1 << 16)
    try:
        rng = np.random.RandomState(7)
        wrapped_offsets = set()
        for i in range(1200):
            n = int(rng.randint(0, 1600))
            x = rng.randint(0, 255, size=n).astype(np.uint8)
            before = cli._writer._wpos % cli._writer._cap
            cli.send({"i": i}, [x])
            after = cli._writer._wpos % cli._writer._cap
            if after < before:
                wrapped_offsets.add(before)
            ctrl, arrays, tok = srv.recv(timeout=5.0)
            assert ctrl["i"] == i
            assert np.array_equal(arrays[0], x)
            srv.release(tok)
            del arrays
        assert len(wrapped_offsets) > 8  # genuinely exercised the seam
    finally:
        _close(cli, srv)


def test_idle_polls_after_the_ring_laps_read_empty():
    """A reader that has caught up polls the slot past the last record.
    Once the ring has lapped with records of other sizes that slot lies
    inside an earlier lap's payload; the writer's end mark keeps its
    status EMPTY, so an idle poll returns nothing instead of reading a
    stale payload byte as a torn record (bytes of 0xAB fill the payloads,
    so a stale status would read 0xABABABAB)."""
    cli, srv = _pair(ring_bytes=1 << 16)
    try:
        rng = np.random.RandomState(11)
        laps = 0
        for i in range(600):
            n = int(rng.randint(1, 3000))
            before = cli._writer._wpos // cli._writer._cap
            cli.send({"i": i}, [np.full(n, 0xAB, np.uint8)])
            laps += cli._writer._wpos // cli._writer._cap - before
            ctrl, arrays, tok = srv.recv(timeout=5.0)
            assert ctrl["i"] == i and arrays[0].size == n
            del arrays
            srv.release(tok)
            assert srv.recv(timeout=0.0) is None  # idle: nothing, no error
        assert laps > 10  # many wraps, each followed by an idle poll
    finally:
        _close(cli, srv)


def test_out_of_order_release_parks_then_sweeps():
    cli, srv = _pair(ring_bytes=1 << 16)
    try:
        for i in range(3):
            cli.send({"i": i}, [np.zeros(100, np.float32)])
        recs = [srv.recv(timeout=5.0) for _ in range(3)]
        # release the tail first: the cursor must NOT advance past the
        # held head
        srv.release(recs[2][2])
        srv.release(recs[0][2])
        srv.release(recs[1][2])
        # the whole ring is reclaimable again: a near-cap burst fits
        big = np.zeros(cli._writer.max_message_bytes() - 4096, np.uint8)
        cli.send({"op": "big"}, [big], timeout=2.0)
        ctrl, arrays, tok = srv.recv(timeout=5.0)
        assert arrays[0].nbytes == big.nbytes
        srv.release(tok)
        del recs, arrays
    finally:
        _close(cli, srv)


def test_double_release_is_idempotent():
    cli, srv = _pair()
    try:
        cli.send({"op": "x"}, [np.zeros(8, np.float32)])
        _, _, tok = srv.recv(timeout=5.0)
        srv.release(tok)
        srv.release(tok)  # no-op, no corruption
        cli.send({"op": "y"}, ())
        ctrl, _, tok2 = srv.recv(timeout=5.0)
        assert ctrl == {"op": "y"}
        srv.release(tok2)
    finally:
        _close(cli, srv)


# ---------------------------------------------------------------------------
# failure semantics: frame-level vs connection-level
# ---------------------------------------------------------------------------


def test_oversized_record_fails_the_frame_not_the_connection():
    cli, srv = _pair(ring_bytes=1 << 16)
    try:
        too_big = np.zeros((1 << 15), np.uint8)  # > cap // 2 with headers
        with pytest.raises(framing.PayloadError):
            cli.send({"op": "submit"}, [too_big])
        cli.send({"op": "after"}, ())  # the link survived
        ctrl, _, tok = srv.recv(timeout=5.0)
        assert ctrl == {"op": "after"}
        srv.release(tok)
    finally:
        _close(cli, srv)


def test_ring_full_times_out_as_connection_error():
    cli, srv = _pair(ring_bytes=1 << 16)
    try:
        payload = np.zeros(12000, np.uint8)
        with pytest.raises(ConnectionError, match="full"):
            for _ in range(100):  # nobody consumes
                cli.send({"op": "fill"}, [payload], timeout=0.2)
    finally:
        _close(cli, srv)


def test_bad_payload_releases_record_and_link_survives():
    """A record that frames correctly but fails the TYPED decode raises
    PayloadError with the record already released — the peer's next
    message still flows (frame-fails-the-caller, same as TCP)."""
    cli, srv = _pair()
    try:
        hostile = (struct.pack(">I", 3) + b"{]x",        # not JSON
                   struct.pack(">I", (1 << 32) - 1) + b"!")  # > 2 GiB claim
        for bad in hostile:
            cli._writer.write([bad], timeout=1.0, dead=cli._dead)
            with pytest.raises(framing.PayloadError):
                srv.recv(timeout=5.0)
        cli.send({"op": "good"}, ())
        ctrl, _, tok = srv.recv(timeout=5.0)
        assert ctrl == {"op": "good"}
        srv.release(tok)
    finally:
        _close(cli, srv)


def test_fuzz_torn_status_kills_the_connection():
    cli, srv = _pair()
    try:
        cli.send({"op": "x"}, [np.zeros(64, np.float32)])
        # tear the record's status word to garbage before the peer reads
        struct.pack_into(">I", cli._shm.buf, srv._reader._data, 0xDEAD)
        with pytest.raises(framing.FrameCorruptError, match="status"):
            srv.recv(timeout=1.0)
    finally:
        _close(cli, srv)


def test_fuzz_torn_length_kills_the_connection():
    cli, srv = _pair()
    try:
        cli.send({"op": "x"}, [np.zeros(64, np.float32)])
        struct.pack_into(">I", cli._shm.buf, srv._reader._data + 4,
                         0x7FFFFFFF)  # length overruns the ring
        with pytest.raises(framing.FrameCorruptError, match="torn"):
            srv.recv(timeout=1.0)
    finally:
        _close(cli, srv)


@pytest.mark.parametrize("checksum", CHECKSUMS)
def test_fuzz_payload_bit_flip_fails_digest(checksum):
    cli, srv = _pair(checksum=checksum)
    try:
        cli.send({"op": "x"}, [np.zeros(64, np.float32)])
        dlen = framing.digest_length(checksum)
        off = srv._reader._data + 8 + dlen + 10  # a payload byte
        cli._shm.buf[off] ^= 0xFF
        with pytest.raises(framing.FrameCorruptError, match="checksum"):
            srv.recv(timeout=1.0)
    finally:
        _close(cli, srv)


def test_send_after_close_raises_connection_error():
    cli, srv = _pair()
    _close(cli, srv)
    with pytest.raises(ConnectionError):
        cli.send({"op": "x"}, ())
    with pytest.raises(ConnectionError):
        srv.recv(timeout=0.01)


# ---------------------------------------------------------------------------
# attach validation (the hostile-hello surface)
# ---------------------------------------------------------------------------


def test_attach_requires_the_segment_prefix():
    with pytest.raises(framing.PayloadError, match="prefix"):
        ShmServer("psm_someoneelse")


def test_attach_to_missing_segment_is_file_not_found():
    with pytest.raises(FileNotFoundError):
        ShmServer(shm_lib.SEGMENT_PREFIX + "0" * 16)


def test_attach_rejects_foreign_magic_and_closes_mapping():
    cli = ShmClient(ring_bytes=1 << 16)
    try:
        cli._shm.buf[0:8] = b"NOTMAGIC"
        with pytest.raises(framing.FrameCorruptError, match="magic"):
            ShmServer(cli.segment)
    finally:
        cli._shm.buf[0:8] = shm_lib.SEGMENT_MAGIC
        cli.close(unlink=True)
    assert cli.segment.lstrip("/") not in shm_lib.list_segments()


def test_attach_rejects_version_checksum_and_size_mismatch():
    cli = ShmClient(ring_bytes=1 << 16, checksum="crc32c")
    try:
        with pytest.raises(framing.FrameCorruptError, match="ring_bytes"):
            ShmServer(cli.segment, ring_bytes=cli.ring_bytes * 2)
        with pytest.raises(framing.FrameCorruptError, match="checksum"):
            ShmServer(cli.segment, checksum="sha256")
        struct.pack_into(">I", cli._shm.buf, 8, 99)  # version
        with pytest.raises(framing.FrameCorruptError, match="version"):
            ShmServer(cli.segment)
        struct.pack_into(">I", cli._shm.buf, 8, shm_lib.SEGMENT_VERSION)
        struct.pack_into(">I", cli._shm.buf, 12, 77)  # checksum code
        with pytest.raises(framing.FrameCorruptError, match="unknown"):
            ShmServer(cli.segment)
        struct.pack_into(
            ">I", cli._shm.buf, 12,
            shm_lib._CHECKSUM_CODES[cli.checksum])
        struct.pack_into(">Q", cli._shm.buf, 16, 1 << 40)  # cap vs size
        with pytest.raises(framing.FrameCorruptError, match="describes"):
            ShmServer(cli.segment)
    finally:
        struct.pack_into(">Q", cli._shm.buf, 16, cli.ring_bytes)
        cli.close(unlink=True)


def test_close_unlinks_and_nothing_leaks():
    pairs = [_pair(checksum=c) for c in CHECKSUMS]
    names = [cli.segment.lstrip("/") for cli, _ in pairs]
    assert all(n.startswith(shm_lib.SEGMENT_PREFIX) for n in names)
    assert set(names) <= set(shm_lib.list_segments())
    for cli, srv in pairs:
        _close(cli, srv)
    assert not set(names) & set(shm_lib.list_segments())


def test_pure_python_crc32c_round_trips():
    """A ring record's digest, written by the C engine, is the plain
    CRC-32C table's digest of its payload, in both directions."""
    cli, srv = _pair(checksum="crc32c")

    def table_digest_holds(ring):
        dlen = ring._dlen
        base = ring._data + ring._rpos() % ring._cap
        plen = struct.unpack_from(">I", ring._mv, base + 4)[0]
        stored = bytes(ring._mv[base + 8:base + 8 + dlen])
        payload = bytes(ring._mv[base + 8 + dlen:base + 8 + dlen + plen])
        want = framing.crc32c(payload, engine="pure-python")
        return stored == struct.pack(">I", want)

    try:
        x = np.arange(256, dtype=np.int32)
        cli.send({"op": "mixed"}, [x])
        assert table_digest_holds(srv._reader)
        ctrl, arrays, tok = srv.recv(timeout=5.0)
        assert np.array_equal(arrays[0], x)
        srv.send({"op": "back"}, [np.asarray(arrays[0])])
        srv.release(tok)
        assert table_digest_holds(cli._reader)
        ctrl2, arrays2, tok2 = cli.recv(timeout=5.0)
        assert np.array_equal(arrays2[0], x)
        cli.release(tok2)
        del arrays, arrays2
    finally:
        _close(cli, srv)


# ---------------------------------------------------------------------------
# negotiation into the fleet wire
# ---------------------------------------------------------------------------


def _echo_registry():
    from dask_ml_tpu_torch.parallel.serving import ModelRegistry

    class _Echo:
        n_features_in_ = 4

        def predict(self, X):
            return np.asarray(X)

    reg = ModelRegistry()
    reg.register("echo", _Echo())
    return reg


def _loop():
    from dask_ml_tpu_torch.parallel.serving import ServingLoop

    lp = ServingLoop(_echo_registry(), max_batch_rows=256,
                     coalesce_window_s=0.0, device="cpu")
    lp.start()
    return lp


def test_fleet_negotiates_shm_and_round_trips():
    from dask_ml_tpu_torch.parallel.fleet import FleetClient, FleetServer

    lp = _loop()
    server = FleetServer(lp).start()
    try:
        with FleetClient(server.address) as cli:
            assert cli._shm is not None
            assert cli.n_shm_connects == 1
            assert server.n_shm_conns == 1
            x = np.random.RandomState(0).randn(33, 4).astype(np.float32)
            out = cli.call("echo", x, timeout=30)
            assert np.array_equal(out, x)
            assert cli.ping()
            assert server.n_frame_errors == 0
            name = cli._shm.segment.lstrip("/")
            assert name in shm_lib.list_segments()
        assert name not in shm_lib.list_segments()  # close unlinked it
    finally:
        server.stop()
        lp.stop()


def test_fleet_falls_back_to_tcp_when_server_disables_shm(monkeypatch):
    from dask_ml_tpu_torch.parallel.fleet import FleetClient, FleetServer

    offered = []

    class Recording(ShmClient):
        def __init__(self, **kw):
            super().__init__(**kw)
            offered.append(self.segment.lstrip("/"))

    monkeypatch.setattr(shm_lib, "ShmClient", Recording)
    lp = _loop()
    server = FleetServer(lp, shm=False).start()
    try:
        with FleetClient(server.address) as cli:
            assert cli._shm is None
            assert server.n_shm_conns == 0
            x = np.random.RandomState(0).randn(5, 4).astype(np.float32)
            assert np.array_equal(cli.call("echo", x, timeout=30), x)
            # the refused offer was unlinked at once
            assert len(offered) == 1
            assert offered[0] not in shm_lib.list_segments()
    finally:
        server.stop()
        lp.stop()


def test_fleet_client_can_opt_out_of_shm():
    from dask_ml_tpu_torch.parallel.fleet import FleetClient, FleetServer

    lp = _loop()
    server = FleetServer(lp).start()
    try:
        with FleetClient(server.address, shm=False) as cli:
            assert cli._shm is None
            x = np.ones((3, 4), np.float32)
            assert np.array_equal(cli.call("echo", x, timeout=30), x)
    finally:
        server.stop()
        lp.stop()


def test_fleet_shm_responses_are_copied_out_of_the_ring():
    """The client-side copy discipline: results stay valid after the
    ring record is recycled by later traffic."""
    from dask_ml_tpu_torch.parallel.fleet import FleetClient, FleetServer

    lp = _loop()
    server = FleetServer(lp).start()
    try:
        with FleetClient(server.address,
                         shm_ring_bytes=1 << 16) as cli:
            assert cli._shm is not None
            rng = np.random.RandomState(3)
            xs = [rng.randn(40, 4).astype(np.float32) for _ in range(40)]
            outs = [cli.call("echo", x, timeout=30) for x in xs]
            for x, out in zip(xs, outs):
                assert np.array_equal(out, x)  # survived ring reuse
            lo, hi = _buffer_range(cli._shm)
            addr = outs[-1].__array_interface__["data"][0]
            assert not (lo <= addr < hi)  # NOT a view into the segment
    finally:
        server.stop()
        lp.stop()


# ---------------------------------------------------------------------------
# parity with the JAX package: one layout, both directions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("checksum", CHECKSUMS)
def test_jax_client_segment_attached_by_the_port_server(checksum):
    """The JAX package's client creates the segment; the port's server
    attaches and reads its requests in place, the JAX client reads the
    port's responses: the header, the record layout and both digests are
    the same bytes."""
    from dask_ml_tpu.parallel import shm as jax_shm

    cli = jax_shm.ShmClient(ring_bytes=1 << 16, checksum=checksum)
    try:
        srv = ShmServer(cli.segment, ring_bytes=cli.ring_bytes,
                        checksum=checksum)
        assert srv.checksum == checksum and srv.ring_bytes == cli.ring_bytes
        rng = np.random.RandomState(3)
        for i in range(300):  # crosses the ring seam many times
            x = rng.randn(int(rng.randint(0, 120)), 3).astype(np.float32)
            cli.send({"op": "submit", "id": f"j{i}"}, [x])
            ctrl, arrays, tok = srv.recv(timeout=5.0)
            assert ctrl == {"op": "submit", "id": f"j{i}"}
            assert np.array_equal(arrays[0], x)
            srv.send({"id": ctrl["id"], "ok": True}, [arrays[0] * 2])
            srv.release(tok)
            del arrays
            ctrl2, out, tok2 = cli.recv(timeout=5.0)
            assert ctrl2 == {"id": f"j{i}", "ok": True}
            assert np.array_equal(out[0], x * 2)
            cli.release(tok2)
            del out
        srv.close()
    finally:
        cli.close(unlink=True)


def test_port_record_bytes_equal_the_jax_record_bytes():
    """One message written by each package's ring writer into a segment
    of the same size: the two rings hold the same bytes."""
    from dask_ml_tpu.parallel import shm as jax_shm

    x = np.arange(40, dtype=np.float64).reshape(8, 5)
    rings = []
    for mod in (shm_lib, jax_shm):
        cli = mod.ShmClient(ring_bytes=1 << 16)
        try:
            cli.send({"op": "submit", "id": "same"}, [x])
            start = cli._writer._data
            rings.append(bytes(cli._shm.buf[start:start + 1024]))
            header = bytes(cli._shm.buf[0:24])  # magic, version, code, cap
            rings.append(header)
        finally:
            cli.close(unlink=True)
    assert rings[0] == rings[2]
    assert rings[1] == rings[3]


def test_port_segments_carry_the_port_prefix():
    """Each package's leak sweep sees its own segments: the port names
    its segments apart from the JAX package's, and attaches to both."""
    from dask_ml_tpu.parallel import shm as jax_shm

    assert not shm_lib.SEGMENT_PREFIX.startswith(jax_shm.SEGMENT_PREFIX)
    assert jax_shm.SEGMENT_PREFIX in shm_lib.ATTACH_PREFIXES
    cli = ShmClient(ring_bytes=1 << 16)
    try:
        name = cli.segment.lstrip("/")
        assert name in shm_lib.list_segments()
        assert name not in jax_shm.list_segments()
    finally:
        cli.close(unlink=True)

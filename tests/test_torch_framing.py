"""The port's frame codec and typed payload (``parallel/framing.py``) on
the CPU: every case of ``tests/test_framing.py`` run against the port,
then parity with the JAX package. The port's C CRC-32C engine, its plain
version, the JAX package's ``crc32c`` and ``google_crc32c`` give the same
digests at every length from 0 to 4,096 and at unaligned offsets; the
typed payload's bytes are the JAX package's for every wire dtype; a frame
written by either package decodes in the other under both checksums.
"""

import io
import socket
import threading

import numpy as np
import pytest

from dask_ml_tpu_torch.parallel import framing

MAGIC = b"TESTMAG1\n"


def test_round_trip():
    for payload in (b"", b"x", b"hello world" * 100, bytes(range(256))):
        frame = framing.encode_frame(payload, magic=MAGIC)
        assert framing.decode_frame(frame, magic=MAGIC) == payload


def test_header_length_accounts_for_magic():
    frame = framing.encode_frame(b"abc", magic=MAGIC)
    assert len(frame) == framing.header_length(MAGIC) + 3


def test_decode_truncation_sweep():
    """Every proper prefix of a frame fails loudly — the property the
    checkpoint sweep relies on, pinned at codec level."""
    frame = framing.encode_frame(b"payload-bytes", magic=MAGIC)
    for cut in range(len(frame)):
        blob = frame[:cut]
        with pytest.raises(framing.FrameError):
            framing.decode_frame(blob, magic=MAGIC)


def test_decode_bit_flip_sweep():
    """Any single flipped payload or digest byte fails the checksum."""
    frame = bytearray(framing.encode_frame(b"payload-bytes", magic=MAGIC))
    start = len(MAGIC) + 8  # flip digest and payload bytes
    for i in range(start, len(frame)):
        blob = bytearray(frame)
        blob[i] ^= 0xFF
        with pytest.raises(framing.FrameCorruptError):
            framing.decode_frame(bytes(blob), magic=MAGIC)


def test_decode_trailing_bytes_are_corruption():
    frame = framing.encode_frame(b"abc", magic=MAGIC)
    with pytest.raises(framing.FrameCorruptError):
        framing.decode_frame(frame + b"extra", magic=MAGIC)


def test_decode_wrong_magic():
    frame = framing.encode_frame(b"abc", magic=MAGIC)
    with pytest.raises(framing.FrameCorruptError):
        framing.decode_frame(frame, magic=b"OTHERMAG\n")


def test_stream_read_write_multiple_frames():
    buf = io.BytesIO()
    payloads = [b"first", b"", b"third" * 1000]
    for p in payloads:
        framing.write_frame(buf, p, magic=MAGIC)
    buf.seek(0)
    out = []
    while True:
        p = framing.read_frame(buf, magic=MAGIC)
        if p is None:
            break
        out.append(p)
    assert out == payloads


def test_stream_clean_eof_vs_torn_frame():
    buf = io.BytesIO()
    assert framing.read_frame(buf, magic=MAGIC) is None  # clean EOF
    frame = framing.encode_frame(b"payload", magic=MAGIC)
    for cut in (1, len(MAGIC), len(MAGIC) + 3, len(frame) - 1):
        torn = io.BytesIO(frame[:cut])
        with pytest.raises(framing.FrameTruncatedError):
            framing.read_frame(torn, magic=MAGIC)


def test_stream_max_payload_cap():
    buf = io.BytesIO(framing.encode_frame(b"x" * 100, magic=MAGIC))
    with pytest.raises(framing.FrameCorruptError):
        framing.read_frame(buf, magic=MAGIC, max_payload=10)


def test_socket_transport_partial_reads():
    """The stream reader reassembles frames across arbitrary socket
    segmentation (the wire protocol's real transport)."""
    a, b = socket.socketpair()
    payload = bytes(range(256)) * 64  # 16 KiB
    frame = framing.encode_frame(payload, magic=MAGIC)

    def drip():
        for i in range(0, len(frame), 1000):
            a.sendall(frame[i:i + 1000])
        a.close()

    t = threading.Thread(target=drip)
    t.start()
    try:
        assert framing.read_frame(b, magic=MAGIC) == payload
        assert framing.read_frame(b, magic=MAGIC) is None  # peer closed
    finally:
        t.join()
        b.close()


# ---------------------------------------------------------------------------
# the typed wire payload (pickle-free)
# ---------------------------------------------------------------------------


def test_payload_round_trip_arrays_and_control():
    import numpy as np

    control = {"op": "submit", "id": "r1", "model": "m",
               "priority": 3, "deadline": 0.5, "nested": {"k": [1, 2]}}
    arrays = [np.arange(12, dtype=np.float32).reshape(3, 4),
              np.array([], dtype=np.int64),
              np.array(7, dtype=np.uint8)]
    payload = framing.encode_payload(control, arrays)
    ctrl, out = framing.decode_payload(payload)
    assert ctrl == control  # the arrays descriptor list is stripped
    assert len(out) == len(arrays)
    for a, b in zip(arrays, out):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert np.array_equal(a, b)


def test_payload_no_object_dtype_either_direction():
    import numpy as np

    with pytest.raises(framing.PayloadError):
        framing.encode_payload({}, [np.array([object()], dtype=object)])
    # hand-built hostile descriptor: decode refuses by allowlist
    import json

    for dtype in ("object", "str_", "void", "complex128", "S16", "<U4"):
        ctrl = json.dumps({"arrays": [{"dtype": dtype, "shape": [1]}]},
                          separators=(",", ":")).encode()
        blob = len(ctrl).to_bytes(4, "big") + ctrl + b"\x00" * 16
        with pytest.raises(framing.PayloadError):
            framing.decode_payload(blob)


def test_payload_truncation_sweep():
    """Every proper prefix of a typed payload fails loudly — the frame
    codec guards the stream, this guards the STRUCTURE."""
    import numpy as np

    payload = framing.encode_payload(
        {"op": "submit", "id": "x"}, [np.ones((2, 3), np.float32)])
    for cut in range(len(payload)):
        with pytest.raises(framing.PayloadError):
            framing.decode_payload(payload[:cut])


def test_payload_trailing_bytes_are_an_error():
    payload = framing.encode_payload({"op": "ping"})
    with pytest.raises(framing.PayloadError):
        framing.decode_payload(payload + b"x")


def test_payload_hostile_shapes_and_caps():
    import json

    import numpy as np

    def blob(meta, extra=b""):
        ctrl = json.dumps({"arrays": meta},
                          separators=(",", ":")).encode()
        return len(ctrl).to_bytes(4, "big") + ctrl + extra

    hostile = [
        blob([{"dtype": "float32", "shape": [-1]}]),
        blob([{"dtype": "float32", "shape": [True]}]),
        blob([{"dtype": "float32", "shape": "4"}]),
        blob([{"dtype": "float32", "shape": [1] * 9}]),     # > MAX_NDIM
        blob([{"dtype": "float32", "shape": [2 ** 60]}]),   # huge alloc ask
        blob([{"dtype": "float32"}]),                        # no shape
        blob(["not-a-descriptor"]),
        blob([{"dtype": "float32", "shape": [2]}], b"\x00" * 4),  # short buf
        blob([{"dtype": "float32", "shape": []}] * 65),      # > MAX_ARRAYS
    ]
    for b in hostile:
        with pytest.raises(framing.PayloadError):
            framing.decode_payload(b)
    # control-length prefix overrunning the payload / over the cap
    with pytest.raises(framing.PayloadError):
        framing.decode_payload(b"\xff\xff\xff\xff" + b"{}")
    with pytest.raises(framing.PayloadError):
        framing.decode_payload(
            (framing.MAX_CONTROL_BYTES + 1).to_bytes(4, "big"))
    # a zero-dim descriptor consuming 0 bytes is legal
    ctrl, arrays = framing.decode_payload(
        blob([{"dtype": "float32", "shape": [0, 4]}]))
    assert arrays[0].shape == (0, 4)
    assert isinstance(np.asarray(arrays[0]), np.ndarray)


def test_payload_control_must_be_json_object():
    for head in (b"[]", b"42", b'"s"', b"nope"):
        blob = len(head).to_bytes(4, "big") + head
        with pytest.raises(framing.PayloadError):
            framing.decode_payload(blob)


def test_checkpoint_uses_shared_codec(tmp_path):
    """The snapshot format IS this codec under the checkpoint magic —
    re-pointing checkpoints at framing.py changed no bytes on disk."""
    from dask_ml_tpu_torch import checkpoint as ckpt

    path = str(tmp_path / "snap.ckpt")
    ckpt.save_pytree(path, {"a": 1}, meta={"k": "v"})
    blob = open(path, "rb").read()
    import pickle

    body = framing.decode_frame(blob, magic=ckpt._SNAPSHOT_MAGIC)
    payload = pickle.loads(body)
    assert payload["meta"] == {"k": "v"} and payload["tree"] == {"a": 1}


# ---------------------------------------------------------------------------
# integrity tiering: crc32c wire frames, sha256 snapshots
# ---------------------------------------------------------------------------


CHECKSUMS = ("sha256", "crc32c")


def test_checksum_registry_and_digest_lengths():
    assert set(framing.CHECKSUMS) == set(CHECKSUMS)
    assert framing.digest_length("sha256") == 32
    assert framing.digest_length("crc32c") == 4
    assert framing.WIRE_CHECKSUM == "crc32c"
    with pytest.raises(ValueError):
        framing.digest_length("md5")


def test_crc32c_known_answer_both_engines():
    """CRC-32C (Castagnoli) of b"123456789" is 0xE3069283, from the C
    engine and from the plain version, fed in chunks and through a
    memoryview."""
    kat = (0xE3069283).to_bytes(4, "big")

    def digest(engine):
        h = framing._new_hasher("crc32c", engine)
        h.update(b"1234")
        h.update(memoryview(b"56789"))
        return h.digest()

    assert [digest(e) for e in framing.CRC32C_ENGINES] == [kat, kat]


@pytest.mark.parametrize("checksum", CHECKSUMS)
def test_frame_round_trip_any_checksum(checksum):
    payload = bytes(range(256)) * 7
    frame = framing.encode_frame(payload, magic=MAGIC, checksum=checksum)
    assert framing.decode_frame(frame, magic=MAGIC,
                                checksum=checksum) == payload
    assert len(frame) == framing.header_length(
        MAGIC, checksum=checksum) + len(payload)


@pytest.mark.parametrize("checksum", CHECKSUMS)
def test_frame_bit_flip_sweep_any_checksum(checksum):
    frame = framing.encode_frame(b"payload-bytes", magic=MAGIC,
                                 checksum=checksum)
    for i in range(len(MAGIC) + 8, len(frame)):
        blob = bytearray(frame)
        blob[i] ^= 0xFF
        with pytest.raises(framing.FrameCorruptError):
            framing.decode_frame(bytes(blob), magic=MAGIC,
                                 checksum=checksum)


def test_frame_checksum_mismatch_is_corruption():
    frame = framing.encode_frame(b"abc", magic=MAGIC, checksum="crc32c")
    with pytest.raises(framing.FrameError):
        framing.decode_frame(frame, magic=MAGIC, checksum="sha256")


def test_write_frame_returns_payload_byte_count():
    buf = io.BytesIO()
    assert framing.write_frame(buf, b"abcde", magic=MAGIC) == 5
    import numpy as np

    parts = framing.encode_payload_parts(
        {"op": "x"}, [np.zeros((3, 4), np.float32)])
    total = sum(p.nbytes if isinstance(p, memoryview) else len(p)
                for p in parts)
    buf2 = io.BytesIO()
    assert framing.write_frame_parts(buf2, parts, magic=MAGIC) == total


def test_parts_encoding_is_byte_identical_to_joined():
    """encode_payload_parts/write_frame_parts are pure perf: the bytes
    on the wire are EXACTLY the single-buffer encoding's."""
    import numpy as np

    control = {"op": "submit", "id": "r9"}
    arrays = [np.arange(24, dtype=np.float32).reshape(2, 3, 4),
              np.zeros((0, 5), np.int64)]
    joined = framing.encode_payload(control, arrays)
    assert b"".join(framing.encode_payload_parts(control, arrays)) \
        == joined
    for checksum in CHECKSUMS:
        a, b = io.BytesIO(), io.BytesIO()
        framing.write_frame(a, joined, magic=MAGIC, checksum=checksum)
        framing.write_frame_parts(
            b, framing.encode_payload_parts(control, arrays),
            magic=MAGIC, checksum=checksum)
        assert a.getvalue() == b.getvalue()


# ---------------------------------------------------------------------------
# payload decode edge cases
# ---------------------------------------------------------------------------


def test_payload_zero_row_arrays_round_trip():
    import numpy as np

    arrays = [np.zeros((0,), np.float64), np.zeros((0, 7), np.float32),
              np.zeros((3, 0, 2), np.int32)]
    ctrl, out = framing.decode_payload(
        framing.encode_payload({"op": "z"}, arrays))
    for a, b in zip(arrays, out):
        assert a.shape == b.shape and a.dtype == b.dtype


def test_payload_non_contiguous_inputs_made_contiguous_at_encode():
    import numpy as np

    base = np.arange(48, dtype=np.float32).reshape(6, 8)
    hostile = [base.T, base[::2], base[:, 1::3], base[::-1]]
    ctrl, out = framing.decode_payload(
        framing.encode_payload({"op": "nc"}, hostile))
    for a, b in zip(hostile, out):
        assert np.array_equal(a, b)
        assert b.flags["C_CONTIGUOUS"]


def test_payload_caps_at_exact_boundary():
    """MAX_ARRAYS buffers and MAX_NDIM dims are ACCEPTED; one more of
    either is refused (the cap is a boundary, not a fudge factor)."""
    import numpy as np

    at_cap = [np.zeros(1, np.uint8)] * framing.MAX_ARRAYS
    ctrl, out = framing.decode_payload(
        framing.encode_payload({}, at_cap))
    assert len(out) == framing.MAX_ARRAYS
    with pytest.raises(framing.PayloadError):
        framing.decode_payload(framing.encode_payload(
            {}, [np.zeros(1, np.uint8)] * (framing.MAX_ARRAYS + 1)))
    deep = np.zeros((1,) * framing.MAX_NDIM, np.float32)
    ctrl, out = framing.decode_payload(
        framing.encode_payload({}, [deep]))
    assert out[0].ndim == framing.MAX_NDIM
    with pytest.raises(framing.PayloadError):
        framing.decode_payload(framing.encode_payload(
            {}, [np.zeros((1,) * (framing.MAX_NDIM + 1), np.float32)]))


def test_payload_over_two_gib_control_length_fails_the_frame():
    """A control-length prefix past 2 GiB is a PayloadError — the FRAME
    fails, the connection-level codec never sees it (transport survival
    is pinned in test_fleet.py / test_shm.py on the live wires)."""
    import struct as _struct

    for hlen in (1 << 31, (1 << 32) - 1, framing.MAX_CONTROL_BYTES + 1):
        blob = _struct.pack(">I", hlen) + b"{}"
        with pytest.raises(framing.PayloadError):
            framing.decode_payload(blob)


def test_payload_decode_from_memoryview_is_zero_copy():
    """bytes in → owned copies; memoryview in → views INTO the buffer
    (the shm ring's contract)."""
    import numpy as np

    x = np.arange(64, dtype=np.float32).reshape(8, 8)
    payload = framing.encode_payload({"op": "v"}, [x])
    mv = memoryview(bytearray(payload))  # writable backing store
    ctrl, out = framing.decode_payload(mv)
    src = np.frombuffer(mv, dtype=np.uint8)
    lo = src.__array_interface__["data"][0]
    hi = lo + src.nbytes
    addr = out[0].__array_interface__["data"][0]
    assert lo <= addr < hi
    # and mutating the backing store shows through the view
    out_before = out[0][0, 0]
    mv[-x.nbytes] ^= 0xFF
    assert out[0][0, 0] != out_before


# ---------------------------------------------------------------------------
# the C engine: the port's own, and it never gives way quietly
# ---------------------------------------------------------------------------


def test_engine_is_the_port_c_library():
    assert framing.crc32c_engine() == "port-c"
    assert framing.CRC32C_ENGINES == ("port-c", "pure-python")
    with pytest.raises(ValueError):
        framing.crc32c(b"x", engine="zlib")


def test_engine_build_failure_raises_never_falls_back(monkeypatch):
    """A library that cannot be built or loaded fails the digest and the
    engine query; nothing gives way to the table."""
    from dask_ml_tpu_torch._kernels import build

    def broken(name):
        raise RuntimeError(f"cc {name}.c failed: simulated")

    monkeypatch.setattr(framing, "_crc_lib", None)
    monkeypatch.setattr(build, "load", broken)
    with pytest.raises(RuntimeError, match="simulated"):
        framing.crc32c(b"abc")
    with pytest.raises(RuntimeError, match="simulated"):
        framing.crc32c_engine()
    with pytest.raises(RuntimeError, match="simulated"):
        framing.encode_frame(b"abc", magic=MAGIC, checksum="crc32c")
    # the plain version stays available where asked for by name
    assert framing.crc32c(b"123456789", engine="pure-python") == 0xE3069283


def test_streaming_updates_equal_one_shot():
    rng = np.random.default_rng(5)
    data = rng.integers(0, 256, 10_000, dtype=np.uint8).tobytes()
    want = framing.crc32c(data)
    for cuts in ([1], [7, 8, 9], [4095, 4096, 4097], list(range(0, 10_000,
                                                                 997))):
        h = framing._new_hasher("crc32c")
        prev = 0
        for c in cuts + [len(data)]:
            h.update(memoryview(data)[prev:c])
            prev = c
        assert int.from_bytes(h.digest(), "big") == want


def test_hash_seconds_histogram_mirrors_the_digests():
    from dask_ml_tpu_torch import config_context
    from dask_ml_tpu_torch.parallel import telemetry

    telemetry.reset_telemetry()
    try:
        with config_context(telemetry=True):
            framing.encode_frame(b"abc", magic=MAGIC, checksum="crc32c")
            framing.encode_frame(b"abc", magic=MAGIC)
            framing.encode_frame(b"abcd", magic=MAGIC)
        hist = telemetry.metrics().snapshot()["histograms"]
        assert hist["wire.hash_seconds{algo=crc32c}"]["count"] == 1
        assert hist["wire.hash_seconds{algo=sha256}"]["count"] == 2
    finally:
        telemetry.reset_telemetry()


# ---------------------------------------------------------------------------
# parity with the JAX package
# ---------------------------------------------------------------------------


def _seeded(n, seed):
    return np.random.default_rng(seed).integers(
        0, 256, n, dtype=np.uint8).tobytes()


def test_crc32c_parity_every_length_to_4096():
    """The port's C engine, its plain version, the JAX package's crc32c
    and google_crc32c: one digest at every length 0..4,096."""
    import google_crc32c

    from dask_ml_tpu.parallel import framing as jax_framing

    data = _seeded(4096, 11)
    for n in range(4097):
        chunk = data[:n]
        c = framing.crc32c(chunk)
        assert c == google_crc32c.value(chunk), n
        assert c == jax_framing.crc32c(chunk), n
        assert c == framing.crc32c(chunk, engine="pure-python"), n


def test_crc32c_parity_at_unaligned_offsets():
    import google_crc32c

    from dask_ml_tpu.parallel import framing as jax_framing

    base = np.frombuffer(_seeded(8192 + 64, 12), np.uint8)
    for off in range(17):
        for n in (0, 1, 3, 7, 8, 9, 15, 16, 17, 63, 64, 65, 1000, 4096):
            view = memoryview(base)[off:off + n]
            want = google_crc32c.value(bytes(view))
            assert framing.crc32c(view) == want, (off, n)
            assert framing.crc32c(base[off:off + n]) == want, (off, n)
            assert jax_framing.crc32c(bytes(view)) == want, (off, n)
            assert framing.crc32c(view, engine="pure-python") == want


@pytest.mark.parametrize("dtype", sorted(framing.PAYLOAD_DTYPES))
def test_payload_bytes_identical_to_the_jax_package(dtype):
    from dask_ml_tpu.parallel import framing as jax_framing

    assert jax_framing.PAYLOAD_DTYPES == framing.PAYLOAD_DTYPES
    rng = np.random.default_rng(13)
    arrays = [
        (rng.standard_normal((5, 3)) * 50).astype(dtype),
        np.zeros((0, 4), dtype),
        np.asarray(rng.integers(0, 2), dtype=dtype),
        (rng.standard_normal((4, 6)) * 9).astype(dtype)[:, ::2],
    ]
    control = {"op": "submit", "id": "r-7", "model": "km",
               "method": "predict", "priority": 2, "deadline": None}
    port = framing.encode_payload(control, arrays)
    assert port == jax_framing.encode_payload(control, arrays)
    assert b"".join(framing.encode_payload_parts(control, arrays)) == port
    for pkg in (framing, jax_framing):
        ctrl, out = pkg.decode_payload(port)
        assert ctrl == control
        for a, b in zip(arrays, out):
            assert a.dtype == b.dtype and a.shape == b.shape
            assert np.array_equal(a, b)


@pytest.mark.parametrize("checksum", CHECKSUMS)
@pytest.mark.parametrize("writer", ["port", "jax"])
def test_frames_cross_decode_between_packages(checksum, writer):
    from dask_ml_tpu.parallel import framing as jax_framing

    w, r = ((framing, jax_framing) if writer == "port"
            else (jax_framing, framing))
    payloads = [b"", b"x", _seeded(70_000, 14),
                framing.encode_payload({"op": "ping", "id": "p"})]
    for p in payloads:
        frame = w.encode_frame(p, magic=framing.WIRE_MAGIC,
                               checksum=checksum)
        assert r.decode_frame(frame, magic=framing.WIRE_MAGIC,
                              checksum=checksum) == p
    buf = io.BytesIO()
    for p in payloads:
        w.write_frame(buf, p, magic=framing.WIRE_MAGIC, checksum=checksum)
    buf.seek(0)
    got = []
    while True:
        p = r.read_frame(buf, magic=framing.WIRE_MAGIC, checksum=checksum)
        if p is None:
            break
        got.append(p)
    assert got == payloads
    assert framing.WIRE_MAGIC == jax_framing.WIRE_MAGIC
    assert framing.WIRE_CHECKSUM == jax_framing.WIRE_CHECKSUM

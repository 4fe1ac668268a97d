"""Length-prefixed, checksummed frames for snapshot files and the serving
wire, and the typed (pickle-free) payload the wire speaks (the
counterpart of ``dask_ml_tpu/parallel/framing.py``).

Frame layout, everything big-endian::

    magic (the owner's, with a version byte)
    8-byte unsigned payload length
    checksum(payload) — 32-byte sha256 or 4-byte CRC-32C (Castagnoli)
    payload

The layout, both digests and the typed payload are the JAX package's byte
for byte, so a frame or a payload written by either package decodes in the
other. A frame that is missing bytes raises :class:`FrameTruncatedError`;
a foreign magic, a failed digest or trailing bytes raise
:class:`FrameCorruptError`.

**Integrity tiers.** Snapshots and checkpoints keep sha256 (the default:
a file is written once and read across process lifetimes). The wire's
data frames and shared-memory ring records use CRC-32C
(:data:`WIRE_CHECKSUM`), hashed once per request per hop. The checksum is
a codec parameter, not a frame field: each magic's owner fixes its tier.

**The CRC-32C engine** is the port's own C library,
``_kernels/csrc/crc32c.c`` (slice by 8, portable C), built with the host C
compiler at first use and loaded with ``ctypes`` (``_kernels/build.py``);
:func:`crc32c_engine` names it ``"port-c"``. The table loop in Python is
its plain version: it gives the same digest, at a few MB/s, and runs only
where a caller asks for it (``engine="pure-python"``). A build or load
failure of the C engine raises; nothing gives way to the table quietly.

:func:`encode_frame` / :func:`decode_frame` work on whole byte strings
(the snapshot files), :func:`read_frame` / :func:`write_frame` /
:func:`write_frame_parts` on stream objects with ``recv``-style partial
reads (the sockets).

**The typed wire payload** (:func:`encode_payload` /
:func:`decode_payload`, layout documented there) deserializes no object:
a JSON control envelope under a size cap, then dtype / shape-tagged
buffers against an allowlist. A payload that fails its caps or structure
raises :class:`PayloadError`, which the serving layer maps to a per-frame
error response (the frame was intact, so the connection survives).
:func:`encode_payload_parts` + :func:`write_frame_parts` send the same
bytes without concatenating them: one digest pass, buffers written from
the caller's memory.
"""

from __future__ import annotations

import hashlib
import json
import struct
import threading
import time
from typing import Optional

import numpy as np

__all__ = [
    "FrameError",
    "FrameTruncatedError",
    "FrameCorruptError",
    "PayloadError",
    "encode_frame",
    "decode_frame",
    "read_frame",
    "write_frame",
    "write_frame_parts",
    "encode_payload",
    "encode_payload_parts",
    "decode_payload",
    "header_length",
    "digest_length",
    "crc32c",
    "crc32c_engine",
    "WIRE_MAGIC",
    "WIRE_CHECKSUM",
    "CHECKSUMS",
    "PAYLOAD_DTYPES",
]

#: the serving wire's magic; version 3 frames the typed payload under
#: CRC-32C (a sha256 peer of version 2 fails the magic check)
WIRE_MAGIC = b"DMLTWIRE3\n"

#: the wire's integrity tier (snapshots and checkpoints keep sha256)
WIRE_CHECKSUM = "crc32c"

_LEN_BYTES = 8
_SHA256_BYTES = 32
_CRC32C_BYTES = 4

#: the two integrity tiers
CHECKSUMS = ("sha256", "crc32c")

#: the CRC-32C engines: the port's C library and its plain version
CRC32C_ENGINES = ("port-c", "pure-python")


class FrameError(RuntimeError):
    """Base class for framing failures."""


class FrameTruncatedError(FrameError):
    """The buffer or stream ended before the frame did (a torn write, a cut
    connection): the header promised more bytes than arrived."""


class FrameCorruptError(FrameError):
    """The frame is structurally complete but wrong: foreign magic, or a
    payload whose digest does not match the header's."""


class PayloadError(FrameError):
    """A typed wire payload failed decoding although its frame was intact:
    a malformed control envelope, a dtype outside the allowlist, a shape
    that disagrees with the bytes, or a cap exceeded. The error belongs to
    one request; the connection keeps serving."""


# ---------------------------------------------------------------------------
# checksum engines
# ---------------------------------------------------------------------------

# CRC-32C: reflected polynomial 0x82F63B78, init and xorout 0xFFFFFFFF,
# the table of the plain version
_CRC32C_TABLE = []
for _i in range(256):
    _c = _i
    for _ in range(8):
        _c = (_c >> 1) ^ 0x82F63B78 if _c & 1 else _c >> 1
    _CRC32C_TABLE.append(_c)
del _i, _c


class _PureCrc32c:
    """Streaming CRC-32C in Python with hashlib's update/digest shape: the
    plain version of the C engine."""

    def __init__(self):
        self._crc = 0

    def update(self, data) -> None:
        table = _CRC32C_TABLE
        c = self._crc ^ 0xFFFFFFFF
        for b in bytes(data):
            c = table[(c ^ b) & 0xFF] ^ (c >> 8)
        self._crc = c ^ 0xFFFFFFFF

    def digest(self) -> bytes:
        return struct.pack(">I", self._crc)


_crc_lib = None
_crc_lock = threading.Lock()


def _crc_update():
    """The C engine's ``dml_crc32c_update``, built and loaded at the first
    call (a failure raises)."""
    global _crc_lib
    lib = _crc_lib
    if lib is None:
        with _crc_lock:
            if _crc_lib is None:
                from dask_ml_tpu_torch._kernels import build

                _crc_lib = build.load("crc32c")
            lib = _crc_lib
    return lib.dml_crc32c_update


class _CCrc32c:
    """The port's C engine behind hashlib's update/digest shape. Any
    contiguous buffer (bytes, bytearray, a memoryview over shared memory,
    a numpy array) is hashed in place through its address: one pass, no
    copy."""

    __slots__ = ("_crc", "_update")

    def __init__(self):
        self._crc = 0
        self._update = _crc_update()

    def update(self, data) -> None:
        a = np.frombuffer(data, dtype=np.uint8)
        if a.size:
            self._crc = self._update(self._crc, a.ctypes.data, a.size)

    def digest(self) -> bytes:
        return struct.pack(">I", self._crc)


def _resolve_engine(engine: Optional[str]) -> str:
    engine = "port-c" if engine is None else engine
    if engine not in CRC32C_ENGINES:
        raise ValueError(
            f"unknown crc32c engine {engine!r} (supported: "
            f"{CRC32C_ENGINES})")
    return engine


def crc32c_engine() -> str:
    """The CRC-32C engine of every digest that names none: ``"port-c"``,
    the C library, loaded here if it is not yet (which raises on a build
    or load failure)."""
    _crc_update()
    return "port-c"


def crc32c(data, *, engine: Optional[str] = None) -> int:
    """CRC-32C of ``data`` as an unsigned 32-bit int; ``engine`` picks
    ``"port-c"`` (the default) or ``"pure-python"``."""
    h = _new_hasher("crc32c", engine)
    h.update(data)
    return struct.unpack(">I", h.digest())[0]


def _new_hasher(checksum: str, engine: Optional[str] = None):
    if checksum == "sha256":
        return hashlib.sha256()
    if checksum == "crc32c":
        if _resolve_engine(engine) == "port-c":
            return _CCrc32c()
        return _PureCrc32c()
    raise ValueError(
        f"unknown checksum {checksum!r} (supported: {CHECKSUMS})")


def digest_length(checksum: str) -> int:
    """Digest size in bytes of one of :data:`CHECKSUMS`."""
    if checksum == "sha256":
        return _SHA256_BYTES
    if checksum == "crc32c":
        return _CRC32C_BYTES
    raise ValueError(
        f"unknown checksum {checksum!r} (supported: {CHECKSUMS})")


def _digest(checksum: str, chunks) -> bytes:
    """One digest pass over ``chunks``, with the ``wire.hash_seconds
    {algo=}`` histogram at this, the only hash site (with telemetry off it
    costs one boolean)."""
    from dask_ml_tpu_torch.parallel import telemetry

    h = _new_hasher(checksum)
    if not telemetry.enabled():
        for c in chunks:
            h.update(c)
        return h.digest()
    t0 = time.perf_counter()
    for c in chunks:
        h.update(c)
    d = h.digest()
    telemetry.metrics().histogram(
        "wire.hash_seconds", algo=checksum).observe(time.perf_counter() - t0)
    return d


def header_length(magic: bytes, checksum: str = "sha256") -> int:
    """Total header size for ``magic``: magic + length + digest."""
    return len(magic) + _LEN_BYTES + digest_length(checksum)


def encode_frame(payload: bytes, *, magic: bytes,
                 checksum: str = "sha256") -> bytes:
    """``magic + len(payload) (8B BE) + checksum(payload) + payload``."""
    return (magic + struct.pack(">Q", len(payload))
            + _digest(checksum, (payload,)) + payload)


def decode_frame(data: bytes, *, magic: bytes,
                 checksum: str = "sha256") -> bytes:
    """Decode one whole-buffer frame into its payload, checking magic,
    length and digest. ``data`` must be exactly one frame: trailing bytes
    are corruption, not a second frame."""
    dlen = digest_length(checksum)
    if data[:len(magic)] != magic:
        raise FrameCorruptError(
            f"bad frame magic {data[:len(magic)]!r} (expected {magic!r})")
    rest = data[len(magic):]
    if len(rest) < _LEN_BYTES + dlen:
        raise FrameTruncatedError(
            f"truncated frame header ({len(data)} bytes)")
    (length,) = struct.unpack(">Q", rest[:_LEN_BYTES])
    digest = rest[_LEN_BYTES:_LEN_BYTES + dlen]
    payload = rest[_LEN_BYTES + dlen:]
    if len(payload) < length:
        raise FrameTruncatedError(
            f"frame payload is {len(payload)} bytes but the header "
            f"recorded {length}")
    if len(payload) > length:
        raise FrameCorruptError(
            f"frame carries {len(payload) - length} trailing bytes past "
            f"the recorded payload length {length}")
    if _digest(checksum, (payload,)) != digest:
        raise FrameCorruptError("frame payload checksum mismatch")
    return payload


def _read_exact(stream, n: int) -> bytes:
    """Read exactly ``n`` bytes from a stream with ``recv`` (a socket) or
    ``read`` (a file), across partial reads; fewer only at EOF."""
    recv = getattr(stream, "recv", None) or stream.read
    chunks = []
    got = 0
    while got < n:
        chunk = recv(n - got)
        if not chunk:
            break
        chunks.append(chunk)
        got += len(chunk)
    return b"".join(chunks)


def read_frame(stream, *, magic: bytes,
               max_payload: Optional[int] = None,
               checksum: str = "sha256") -> Optional[bytes]:
    """Read one frame from a stream into its payload, or ``None`` on a
    clean EOF (no byte at all: the peer closed between frames).

    EOF inside a frame raises :class:`FrameTruncatedError`; a wrong magic
    or a failed digest raises :class:`FrameCorruptError`. ``max_payload``
    bounds the allocation a hostile or corrupt length may ask for."""
    dlen = digest_length(checksum)
    head = _read_exact(stream, len(magic))
    if not head:
        return None
    if len(head) < len(magic):
        raise FrameTruncatedError(
            f"truncated frame magic ({len(head)} bytes)")
    if head != magic:
        raise FrameCorruptError(
            f"bad frame magic {head!r} (expected {magic!r})")
    meta = _read_exact(stream, _LEN_BYTES + dlen)
    if len(meta) < _LEN_BYTES + dlen:
        raise FrameTruncatedError(
            f"truncated frame header ({len(head) + len(meta)} bytes)")
    (length,) = struct.unpack(">Q", meta[:_LEN_BYTES])
    if max_payload is not None and length > max_payload:
        raise FrameCorruptError(
            f"frame payload length {length} exceeds the {max_payload}-byte "
            "cap")
    digest = meta[_LEN_BYTES:]
    payload = _read_exact(stream, length)
    if len(payload) < length:
        raise FrameTruncatedError(
            f"frame payload is {len(payload)} bytes but the header "
            f"recorded {length}")
    if _digest(checksum, (payload,)) != digest:
        raise FrameCorruptError("frame payload checksum mismatch")
    return payload


def write_frame(stream, payload: bytes, *, magic: bytes,
                checksum: str = "sha256") -> int:
    """Write one frame to a stream with ``sendall`` (a socket) or
    ``write`` (a file). Returns the payload byte count."""
    return write_frame_parts(stream, (payload,), magic=magic,
                             checksum=checksum)


def write_frame_parts(stream, parts, *, magic: bytes,
                      checksum: str = "sha256") -> int:
    """Write one frame whose payload is the concatenation of ``parts``
    (bytes or memoryviews) without building it: one digest pass across
    the parts, each part sent from its own buffer. Returns the payload
    byte count (the ``wire.bytes`` increment)."""
    parts = [p if isinstance(p, (bytes, bytearray, memoryview))
             else memoryview(p) for p in parts]
    total = sum(p.nbytes if isinstance(p, memoryview) else len(p)
                for p in parts)
    header = (magic + struct.pack(">Q", total)
              + _digest(checksum, parts))
    send = getattr(stream, "sendall", None)
    if send is not None:
        # a small frame leaves in one syscall; a large buffer is sent from
        # its own memory rather than copied into a joined one
        if total < (64 << 10):
            send(b"".join([header, *parts]))
        else:
            send(header)
            for p in parts:
                send(p)
        return total
    stream.write(header)
    for p in parts:
        stream.write(p)
    flush = getattr(stream, "flush", None)
    if flush is not None:
        flush()
    return total


# ---------------------------------------------------------------------------
# the typed wire payload: JSON control envelope + dtype/shape-tagged buffers
# ---------------------------------------------------------------------------

#: numpy dtypes allowed on the wire: fixed-width numerics only (no object,
#: void or string dtype; no bfloat16, which numpy does not have)
PAYLOAD_DTYPES = frozenset({
    "bool",
    "int8", "int16", "int32", "int64",
    "uint8", "uint16", "uint32", "uint64",
    "float16", "float32", "float64",
})

#: decode caps: the frame's ``max_payload`` bounds the total allocation,
#: these bound its shape
MAX_CONTROL_BYTES = 1 << 20   # control envelope: 1 MiB of JSON
MAX_ARRAYS = 64               # buffers per payload
MAX_NDIM = 8                  # dims per buffer

_CTRL_LEN_BYTES = 4


def encode_payload_parts(control: dict, arrays=()) -> list:
    """One wire message as a list of parts ``[prefix, buf, ...]``:
    ``prefix`` is the control length and the control JSON, each ``buf`` a
    memoryview over a (C-contiguous) array's own memory.
    ``b"".join(parts)`` is exactly :func:`encode_payload`'s bytes; the
    parts can be hashed and written without joining them
    (:func:`write_frame_parts`). A non-contiguous array is made contiguous
    here, the only copy.

    Layout (inside one :data:`WIRE_MAGIC` frame)::

        4-byte unsigned BE control length
        control JSON (utf-8): ``control`` plus an ``"arrays"`` list of
            ``{"dtype", "shape"}`` descriptors, one per buffer
        the raw array buffers, C-contiguous, concatenated in order

    ``control`` must be JSON-serializable; each array's dtype must be in
    :data:`PAYLOAD_DTYPES`.
    """
    metas = []
    bufs = []
    for a in arrays:
        a = np.asarray(a)
        shape = list(a.shape)  # before ascontiguousarray's 0-d → 1-d
        a = np.ascontiguousarray(a)
        name = a.dtype.name
        if name not in PAYLOAD_DTYPES:
            raise PayloadError(
                f"dtype {name!r} is not wire-encodable "
                f"(allowed: {sorted(PAYLOAD_DTYPES)})")
        metas.append({"dtype": name, "shape": shape})
        bufs.append(memoryview(a.reshape(-1)).cast("B"))
    ctrl = dict(control)
    if "arrays" in ctrl:
        raise PayloadError(
            "'arrays' is the codec's buffer-descriptor key; a control "
            "envelope cannot carry its own")
    ctrl["arrays"] = metas
    head = json.dumps(ctrl, separators=(",", ":")).encode("utf-8")
    if len(head) > MAX_CONTROL_BYTES:
        raise PayloadError(
            f"control envelope is {len(head)} bytes "
            f"(cap {MAX_CONTROL_BYTES})")
    return [struct.pack(">I", len(head)) + head, *bufs]


def encode_payload(control: dict, arrays=()) -> bytes:
    """One wire message as one byte string: the concatenation of
    :func:`encode_payload_parts`."""
    return b"".join(encode_payload_parts(control, arrays))


def decode_payload(payload, *,
                   max_control_bytes: int = MAX_CONTROL_BYTES):
    """Decode one typed wire message into ``(control, arrays)``.

    ``payload`` may be ``bytes`` (the socket path) or a ``memoryview``
    (the shared-memory path: the arrays are then views into that buffer,
    no copy).

    Strict: the control length is capped, the envelope must be a JSON
    object, each buffer descriptor must carry an allowlisted dtype and a
    shape of at most :data:`MAX_NDIM` non-negative dims, the described
    bytes must tile the rest of the payload exactly, and at most
    :data:`MAX_ARRAYS` buffers are accepted. Any violation raises
    :class:`PayloadError`; no object is ever deserialized.
    """
    if len(payload) < _CTRL_LEN_BYTES:
        raise PayloadError(
            f"payload is {len(payload)} bytes, too short for the "
            "control-length prefix")
    (hlen,) = struct.unpack_from(">I", payload, 0)
    if hlen > max_control_bytes:
        raise PayloadError(
            f"control envelope length {hlen} exceeds the "
            f"{max_control_bytes}-byte cap")
    if _CTRL_LEN_BYTES + hlen > len(payload):
        raise PayloadError(
            f"control envelope length {hlen} overruns the "
            f"{len(payload)}-byte payload")
    try:
        control = json.loads(
            bytes(payload[_CTRL_LEN_BYTES:_CTRL_LEN_BYTES + hlen])
            .decode("utf-8"))
    except (UnicodeDecodeError, ValueError) as e:
        raise PayloadError(f"control envelope is not valid JSON: {e}")
    if not isinstance(control, dict):
        raise PayloadError(
            f"control envelope must be a JSON object, got "
            f"{type(control).__name__}")
    metas = control.pop("arrays", [])
    if not isinstance(metas, list) or len(metas) > MAX_ARRAYS:
        raise PayloadError(
            "control 'arrays' must be a list of at most "
            f"{MAX_ARRAYS} descriptors")
    arrays = []
    off = _CTRL_LEN_BYTES + hlen
    for i, m in enumerate(metas):
        if not isinstance(m, dict):
            raise PayloadError(f"array descriptor {i} is not an object")
        name = m.get("dtype")
        if name not in PAYLOAD_DTYPES:
            raise PayloadError(
                f"array {i} dtype {name!r} is not wire-decodable "
                f"(allowed: {sorted(PAYLOAD_DTYPES)})")
        shape = m.get("shape")
        if (not isinstance(shape, list) or len(shape) > MAX_NDIM
                or not all(isinstance(s, int) and not isinstance(s, bool)
                           and 0 <= s for s in shape)):
            raise PayloadError(
                f"array {i} shape {shape!r} is not a list of <= "
                f"{MAX_NDIM} non-negative integers")
        dt = np.dtype(name)
        n = 1
        for s in shape:
            n *= s
        nbytes = n * dt.itemsize
        if off + nbytes > len(payload):
            raise PayloadError(
                f"array {i} ({name}, shape {tuple(shape)}) needs "
                f"{nbytes} bytes but only {len(payload) - off} remain")
        arrays.append(np.frombuffer(
            payload, dtype=dt, count=n, offset=off).reshape(shape))
        off += nbytes
    if off != len(payload):
        raise PayloadError(
            f"payload carries {len(payload) - off} trailing bytes past "
            "the described buffers")
    return control, arrays

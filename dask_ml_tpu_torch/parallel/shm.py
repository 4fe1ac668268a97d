"""Shared-memory ring transport: the local data plane under the typed
serving wire (the counterpart of ``dask_ml_tpu/parallel/shm.py``; the
segment layout is that module's byte for byte, so either package attaches
to the other's segment).

On one machine a client and a replica can map the same memory, so a
request is written once by the client and read in place by the replica:
no socket copy and no loopback round trip. One
:class:`multiprocessing.shared_memory.SharedMemory` segment per
connection, created by the client, carries two single-producer /
single-consumer rings (client → server requests, server → client
responses). A message is one ring record::

    u32 status      (EMPTY → READY → FREE, or the WRAP / WRAP_FREE marks)
    u32 payload length
    digest          (the wire's integrity tier: CRC-32C by default,
                     sha256 supported)
    payload         (exactly the typed bytes of framing.encode_payload)
    padding to 8 bytes

:func:`~dask_ml_tpu_torch.parallel.framing.decode_payload` decodes a
memoryview over the record in place, so the arrays a replica receives are
numpy views into the segment. The consumer holds the record (READY,
tracked by a token) until the request is served, then releases it (FREE);
a sweep moves the read cursor over contiguous FREE records, so requests
that finish out of order never block the ring behind a slow one.

Publication order is the SPSC contract: the writer clears the status of
the slot past its record (the end mark, where a reader that has caught up
polls next), fills the length, the digest and the payload, and stores
READY last; the reader touches a record only after it reads READY. Each
cursor is an aligned 8-byte value written by one side only. (The JAX
package's writer sets no end mark: once its ring laps with records of
other sizes, an idle reader can read a stale payload byte as a status and
drop the connection as torn; ROADMAP's caveats.)

Negotiation lives in the fleet layer (``op="shm_hello"`` over the
established TCP connection): the client creates a segment and names it,
the server attaches (which succeeds only when both share a kernel) and
answers yes or no; on no, traffic stays on the framed TCP wire with the
same semantics. The TCP socket stays open either way as the doorbell and
the liveness channel, so a ``kill -9`` of either end shows as it does on
the socket wire.

Segment hygiene: the client (the creator) unlinks on close; its
``resource_tracker`` covers an abnormal death. The server unregisters its
attachment from its own tracker (which would otherwise unlink the
client's live segment when the replica process exits, the respawn path).
Segment names carry :data:`SEGMENT_PREFIX`, so :func:`list_segments` can
sweep ``/dev/shm`` for leaks. The port's prefix differs from the JAX
package's (``dmlt_shm_``), so each package's sweep sees its own segments
only; a server attaches to a segment of either prefix
(:data:`ATTACH_PREFIXES`), so a JAX package client upgrades to the ring
against a port server.
"""

from __future__ import annotations

import os
import struct
import threading
import time
import uuid
from typing import Optional

from dask_ml_tpu_torch.parallel import framing

__all__ = [
    "ShmClient",
    "ShmServer",
    "DEFAULT_RING_BYTES",
    "SEGMENT_PREFIX",
    "list_segments",
]

#: 8-byte segment magic + layout version (bumped on any layout change:
#: an attach to a foreign/stale layout must fail loudly, never misparse)
SEGMENT_MAGIC = b"DMLTSHM1"
SEGMENT_VERSION = 1

#: every segment the port creates starts with this: the /dev/shm leak
#: sweep's probe
SEGMENT_PREFIX = "dmltt_shm_"

#: the prefixes a server attaches to: the port's, and the JAX package's
#: (whose clients create ``dmlt_shm_`` segments of the same layout)
ATTACH_PREFIXES = (SEGMENT_PREFIX, "dmlt_shm_")

#: per-direction ring capacity. Large enough that a full serving batch
#: of requests is in flight without backpressure; one message is capped
#: at half the ring (guarantees a wrapping record can always make
#: progress).
DEFAULT_RING_BYTES = 8 << 20

_HEADER_BYTES = 64
_RING_META_BYTES = 64
_REC_HEADER = 8  # u32 status + u32 payload length
_ALIGN = 8

_EMPTY, _READY, _FREE, _WRAP, _WRAP_FREE = 0, 1, 2, 3, 4

_CHECKSUM_CODES = {"sha256": 1, "crc32c": 2}
_CHECKSUM_NAMES = {v: k for k, v in _CHECKSUM_CODES.items()}


def list_segments() -> list:
    """Live dask-ml-tpu shm segments on this machine (``/dev/shm``
    scan) — the zero-leak gate's probe."""
    try:
        entries = os.listdir("/dev/shm")
    except OSError:
        return []
    return sorted(e for e in entries if e.startswith(SEGMENT_PREFIX))


def _align8(n: int) -> int:
    return (n + _ALIGN - 1) & ~(_ALIGN - 1)


def _nbytes(p) -> int:
    return p.nbytes if isinstance(p, memoryview) else len(p)


class _Ring:
    """One SPSC ring region of the segment (meta + data offsets are
    fixed by the creator; both sides derive them from the header)."""

    def __init__(self, mv, meta_off: int, data_off: int, cap: int,
                 checksum: str):
        self._mv = mv
        self._meta = meta_off
        self._data = data_off
        self._cap = cap
        self._checksum = checksum
        self._dlen = framing.digest_length(checksum)

    def _status(self, off: int) -> int:
        return struct.unpack_from(">I", self._mv, self._data + off)[0]

    def _set_status(self, off: int, st: int) -> None:
        struct.pack_into(">I", self._mv, self._data + off, st)

    def _plen(self, off: int) -> int:
        return struct.unpack_from(">I", self._mv, self._data + off + 4)[0]

    def _rpos(self) -> int:
        return struct.unpack_from(">Q", self._mv, self._meta)[0]

    def _set_rpos(self, v: int) -> None:
        struct.pack_into(">Q", self._mv, self._meta, v)

    def rec_size(self, plen: int) -> int:
        return _align8(_REC_HEADER + self._dlen + plen)


class _RingWriter(_Ring):
    """The producing side: waits for space (bounded), writes the record,
    publishes READY last.

    The end mark: before it publishes a record, the writer clears the
    status word of the slot just past it (and, on a wrap, the slot at the
    ring head it jumps to). A reader that has caught up polls exactly
    there, and once the ring has lapped with other record sizes that word
    would otherwise hold a stale payload byte of an earlier lap, which the
    reader would take for a torn record. The space check keeps one
    header's room for the mark, so it never touches a record the reader
    still holds."""

    def __init__(self, *args):
        super().__init__(*args)
        self._wpos = 0
        self._lock = threading.Lock()

    def max_message_bytes(self) -> int:
        return self._cap // 2 - _REC_HEADER - self._dlen

    def write(self, parts, *, timeout: Optional[float],
              dead: threading.Event) -> int:
        total = sum(_nbytes(p) for p in parts)
        size = self.rec_size(total)
        if size > self._cap // 2:
            raise framing.PayloadError(
                f"message of {total} bytes exceeds this shm ring's "
                f"{self.max_message_bytes()}-byte record cap — raise "
                "ring_bytes on the client or let this link fall back to "
                "the TCP wire")
        deadline = (None if timeout is None
                    else time.perf_counter() + float(timeout))
        with self._lock:
            pause = 5e-05
            while True:
                off = self._wpos % self._cap
                need = (size if off + size <= self._cap
                        else (self._cap - off) + size)
                free = self._cap - (self._wpos - self._rpos())
                if free >= need + _REC_HEADER:  # the record and its end mark
                    break
                if dead.is_set():
                    raise ConnectionError(
                        "shm transport closed while awaiting ring space")
                if deadline is not None \
                        and time.perf_counter() >= deadline:
                    raise ConnectionError(
                        f"shm ring stayed full for {timeout}s: the peer "
                        "stopped consuming")
                time.sleep(pause)
                pause = min(pause * 2.0, 1e-03)
            if off + size > self._cap:
                # tail remnant too small for this record: mark the jump
                # and start at the ring head (the free check above
                # already covered the skipped bytes); the head's status is
                # cleared first, for a reader that follows the jump at once
                self._set_status(0, _EMPTY)
                self._set_status(off, _WRAP)
                self._wpos += self._cap - off
                off = 0
            self._set_status((off + size) % self._cap, _EMPTY)  # end mark
            base = self._data + off
            struct.pack_into(">I", self._mv, base + 4, total)
            self._mv[base + _REC_HEADER:base + _REC_HEADER + self._dlen] \
                = framing._digest(self._checksum, parts)
            pos = base + _REC_HEADER + self._dlen
            for p in parts:
                n = _nbytes(p)
                self._mv[pos:pos + n] = p
                pos += n
            self._set_status(off, _READY)  # publish LAST
            self._wpos += size
        return total


class _RingReader(_Ring):
    """The consuming side: polls for READY records, hands out in-place
    payload views with a release token, sweeps contiguous FREE records
    to advance the shared read cursor."""

    def __init__(self, *args):
        super().__init__(*args)
        self._next = 0
        self._swept = 0
        self._held: dict = {}
        self._lock = threading.Lock()

    def poll(self):
        """One non-blocking attempt → ``(payload_view, token)`` or
        ``None``. A structurally-invalid record (fuzzed status/length,
        failed digest) raises :class:`FrameCorruptError` — ring
        alignment is gone, the connection must die, exactly like a torn
        TCP frame."""
        while True:
            off = self._next % self._cap
            st = self._status(off)
            if st == _EMPTY:
                return None
            if st == _WRAP:
                with self._lock:
                    self._set_status(off, _WRAP_FREE)
                    self._next += self._cap - off
                    self._sweep()
                continue
            if st != _READY:
                raise framing.FrameCorruptError(
                    f"shm ring record at offset {off} has invalid "
                    f"status {st}")
            plen = self._plen(off)
            size = self.rec_size(plen)
            if off + size > self._cap:
                raise framing.FrameCorruptError(
                    f"shm ring record at offset {off} overruns the ring "
                    f"(torn length {plen})")
            base = self._data + off
            digest = bytes(
                self._mv[base + _REC_HEADER:base + _REC_HEADER
                         + self._dlen])
            payload = self._mv[base + _REC_HEADER + self._dlen:
                               base + _REC_HEADER + self._dlen + plen]
            if framing._digest(self._checksum, (payload,)) != digest:
                raise framing.FrameCorruptError(
                    "shm ring record checksum mismatch")
            token = self._next
            with self._lock:
                self._held[token] = size
            self._next += size
            return payload, token

    def release(self, token: int) -> None:
        with self._lock:
            size = self._held.pop(token, None)
            if size is None:
                return
            self._set_status(token % self._cap, _FREE)
            self._sweep()

    def _sweep(self) -> None:
        # under self._lock: advance the shared cursor over every
        # contiguous released record (out-of-order releases park as FREE
        # until the head of the line frees)
        rpos = self._swept
        while rpos < self._next:
            off = rpos % self._cap
            st = self._status(off)
            if st == _FREE:
                size = self.rec_size(self._plen(off))
                self._set_status(off, _EMPTY)
                rpos += size
            elif st == _WRAP_FREE:
                self._set_status(off, _EMPTY)
                rpos += self._cap - off
            else:
                break
        if rpos != self._swept:
            self._swept = rpos
            self._set_rpos(rpos)


class _ShmEndpoint:
    """Common send/recv/release surface of both ends (the transport
    seam the fleet layer drives; `_reader`/`_writer`/`_shm` are set by
    the subclass constructors)."""

    checksum: str
    ring_bytes: int

    def __init__(self):
        self._dead = threading.Event()
        self.n_sent = 0
        self.n_received = 0

    @property
    def segment(self) -> str:
        return self._shm.name

    @property
    def closed(self) -> bool:
        return self._dead.is_set()

    def send(self, control: dict, arrays=(), *,
             timeout: Optional[float] = 30.0) -> int:
        """Encode one typed message and write it into the outgoing ring
        (single digest pass, buffers copied once — caller memory →
        shared memory). Returns the payload byte count."""
        from dask_ml_tpu_torch.parallel import telemetry

        if self._dead.is_set():
            raise ConnectionError("shm transport is closed")
        parts = framing.encode_payload_parts(control, arrays)
        n = self._writer.write(parts, timeout=timeout, dead=self._dead)
        self.n_sent += 1
        if telemetry.enabled():
            telemetry.metrics().counter(
                "wire.bytes", transport="shm").inc(n)
        return n

    def recv(self, timeout: Optional[float] = 0.05):
        """Poll the incoming ring for one message →
        ``(control, arrays, token)`` or ``None`` after ``timeout``.
        The arrays are ZERO-COPY views into the shared segment — they
        stay valid until ``release(token)``, which the caller owes
        exactly once per received message. A payload that fails its
        typed decode raises :class:`PayloadError` with the record
        already released (frame intact → the connection survives)."""
        deadline = (None if timeout is None
                    else time.perf_counter() + float(timeout))
        spin_until = time.perf_counter() + 1e-04
        pause = 2e-05
        while True:
            if self._dead.is_set():
                raise ConnectionError("shm transport is closed")
            rec = self._reader.poll()
            if rec is not None:
                break
            now = time.perf_counter()
            if deadline is not None and now >= deadline:
                return None
            if now >= spin_until:
                # escalating backoff: an actively-fed ring is drained at
                # tens-of-µs latency, an idle one costs ~500 GIL
                # acquisitions/s instead of 20k (many idle connections
                # must not starve the ones doing work)
                time.sleep(pause)
                pause = min(pause * 1.5, 2e-03)
        payload, token = rec
        try:
            control, arrays = framing.decode_payload(payload)
        except framing.PayloadError:
            self._reader.release(token)
            raise
        self.n_received += 1
        return control, arrays, token

    def release(self, token: int) -> None:
        """Return one received record to the ring (every ``recv`` owes
        exactly one — after the LAST read of its array views)."""
        if self._dead.is_set():
            return
        try:
            self._reader.release(token)
        except (ValueError, TypeError):
            pass  # segment already unmapped by a concurrent close

    def _close_mapping(self) -> None:
        self._dead.set()
        try:
            self._shm.close()
        except BufferError:
            # numpy views into the segment are still alive (held
            # records); the mapping falls with them at GC — what must
            # not leak is the /dev/shm NAME, and unlink (creator-side)
            # does not require the mapping to be gone
            pass
        except OSError:
            pass


class ShmClient(_ShmEndpoint):
    """The creating end (one per fleet-client connection): allocates the
    segment, lays out both rings, writes requests, reads responses.
    Owns the segment name — :meth:`close` unlinks it."""

    def __init__(self, *, ring_bytes: int = DEFAULT_RING_BYTES,
                 checksum: str = framing.WIRE_CHECKSUM):
        from multiprocessing import shared_memory

        super().__init__()
        if checksum not in _CHECKSUM_CODES:
            raise ValueError(
                f"unknown checksum {checksum!r} "
                f"(supported: {tuple(_CHECKSUM_CODES)})")
        cap = _align8(max(int(ring_bytes), 1 << 16))
        self.checksum = checksum
        self.ring_bytes = cap
        total = _HEADER_BYTES + 2 * (_RING_META_BYTES + cap)
        name = SEGMENT_PREFIX + uuid.uuid4().hex[:16]
        self._shm = shared_memory.SharedMemory(
            name=name, create=True, size=total)
        mv = self._shm.buf
        mv[0:len(SEGMENT_MAGIC)] = SEGMENT_MAGIC
        struct.pack_into(">I", mv, 8, SEGMENT_VERSION)
        struct.pack_into(">I", mv, 12, _CHECKSUM_CODES[checksum])
        struct.pack_into(">Q", mv, 16, cap)
        struct.pack_into(">Q", mv, 24, os.getpid())  # creator pid
        m0 = _HEADER_BYTES
        d0 = m0 + _RING_META_BYTES
        m1 = d0 + cap
        d1 = m1 + _RING_META_BYTES
        # ring 0: client → server; ring 1: server → client
        self._writer = _RingWriter(mv, m0, d0, cap, checksum)
        self._reader = _RingReader(mv, m1, d1, cap, checksum)

    def hello(self) -> dict:
        """The ``op="shm_hello"`` control envelope the fleet client
        sends over the established TCP connection to negotiate this
        segment."""
        return {"op": "shm_hello", "segment": self.segment,
                "ring_bytes": self.ring_bytes,
                "checksum": self.checksum,
                "version": SEGMENT_VERSION}

    def close(self, *, unlink: bool = True) -> None:
        self._close_mapping()
        if unlink:
            try:
                self._shm.unlink()
            except FileNotFoundError:
                pass
            except OSError:
                pass


class ShmServer(_ShmEndpoint):
    """The attaching end (the replica): maps the client's segment by
    name — possible only when both ends share a kernel, which IS the
    same-machine test the negotiation relies on — validates the layout
    header, reads requests, writes responses. Never unlinks (the
    creator owns the name)."""

    def __init__(self, segment: str, *,
                 ring_bytes: Optional[int] = None,
                 checksum: Optional[str] = None):
        from multiprocessing import shared_memory

        super().__init__()
        segment = str(segment)
        if not segment.startswith(ATTACH_PREFIXES):
            raise framing.PayloadError(
                f"shm segment name must carry one of the prefixes "
                f"{ATTACH_PREFIXES}, got {segment!r}")
        self._shm = shared_memory.SharedMemory(name=segment)
        # Python 3.10's resource tracker registers ATTACHED segments too
        # (bpo-39959) and would unlink the client's live segment when
        # THIS process exits — exactly the replica-respawn path. The
        # creator owns cleanup; drop the spurious registration — but
        # only cross-process: a same-process attach (in-process tests)
        # was a no-op on the tracker's name set, and unregistering
        # there would strip the CREATOR's entry instead.
        try:
            creator_pid = struct.unpack_from(">Q", self._shm.buf, 24)[0]
            if creator_pid != os.getpid():
                from multiprocessing import resource_tracker

                resource_tracker.unregister(
                    self._shm._name, "shared_memory")
        except Exception:  # pragma: no cover - best-effort hygiene
            pass
        try:
            mv = self._shm.buf
            if bytes(mv[0:len(SEGMENT_MAGIC)]) != SEGMENT_MAGIC:
                raise framing.FrameCorruptError(
                    f"shm segment {segment!r} has a foreign magic")
            version = struct.unpack_from(">I", mv, 8)[0]
            if version != SEGMENT_VERSION:
                raise framing.FrameCorruptError(
                    f"shm segment {segment!r} has layout version "
                    f"{version}, this peer speaks {SEGMENT_VERSION}")
            code = struct.unpack_from(">I", mv, 12)[0]
            cname = _CHECKSUM_NAMES.get(code)
            if cname is None:
                raise framing.FrameCorruptError(
                    f"shm segment {segment!r} declares unknown checksum "
                    f"code {code}")
            cap = struct.unpack_from(">Q", mv, 16)[0]
            expected = _HEADER_BYTES + 2 * (_RING_META_BYTES + cap)
            if cap <= 0 or self._shm.size < expected:
                raise framing.FrameCorruptError(
                    f"shm segment {segment!r} is {self._shm.size} bytes "
                    f"but its header describes {expected}")
            if ring_bytes is not None and int(ring_bytes) != cap:
                raise framing.FrameCorruptError(
                    f"shm hello declared ring_bytes={ring_bytes} but "
                    f"the segment header says {cap}")
            if checksum is not None and checksum != cname:
                raise framing.FrameCorruptError(
                    f"shm hello declared checksum={checksum!r} but the "
                    f"segment header says {cname!r}")
        except BaseException:
            self._close_mapping()
            raise
        self.checksum = cname
        self.ring_bytes = int(cap)
        m0 = _HEADER_BYTES
        d0 = m0 + _RING_META_BYTES
        m1 = d0 + cap
        d1 = m1 + _RING_META_BYTES
        # mirror of the client: ring 0 is inbound here, ring 1 outbound
        self._reader = _RingReader(mv, m0, d0, cap, cname)
        self._writer = _RingWriter(mv, m1, d1, cap, cname)

    def close(self) -> None:
        self._close_mapping()

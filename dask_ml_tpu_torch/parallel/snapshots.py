"""Content-addressed, chunk-level snapshot distribution over the framed
wire (the counterpart of ``dask_ml_tpu/parallel/snapshots.py``).

The process fleet ships its model registry to its replicas as a snapshot
file (``parallel/replica.py``). On one box that is a path; across machines
it is bytes on a link, and a registry that re-ships whole on every respawn
turns a machine loss into a transfer storm. So:

- **Content addressing.** A snapshot is cut into fixed-size chunks; each
  chunk's address is its sha256 (:func:`manifest_of`). Two versions that
  differ in one model share every other chunk's address, so a version
  swap re-ships only what changed.
- **One chunk cache a machine.** :class:`ChunkCache` keeps chunks by hash
  in the machine's workdir, shared by every replica there, so a respawn
  or a second replica on that machine fetches the manifest only. Writes
  are atomic (a temporary file renamed into place: replicas race safely);
  reads verify the hash again, so a stale or bit-flipped entry is
  discarded and fetched anew, never served.
- **Resumable transfer.** :func:`fetch_snapshot` keeps each verified chunk
  in the cache before it asks for the next; a transfer killed at any chunk
  boundary resumes with the missing suffix only. The assembly is checked
  against the manifest's whole-file sha256 before it is renamed into
  place.
- **Typed faults.** A transport failure (a socket error, a torn frame)
  raises :class:`SnapshotTransferError`, an ``OSError``, which
  :class:`~dask_ml_tpu_torch.parallel.faults.RetryPolicy` retries with
  backoff and a new connection. A chunk whose bytes do not hash to their
  address raises :class:`SnapshotCorruptError` and is never retried: the
  frame's checksum already rules out noise on the link, so a bad hash
  means a lying server or a poisoned store.

The wire is the port's frame codec (:mod:`dask_ml_tpu_torch.parallel.
framing`, sha256 frames) under its own magic (:data:`SNAP_MAGIC`, the JAX
package's bytes) carrying the typed payload: a JSON control envelope
(``op="manifest"`` / ``op="chunk"``) and at most one uint8 buffer, with no
object deserialization. Manifests, chunk addresses and frames are the JAX
package's, so a port client fetches from a JAX :class:`SnapshotServer`
and the reverse. :class:`SnapshotServer` runs in the router process and
serves chunks by hash with range reads (the snapshot is never held in
memory); ``FaultInjector.slow_link`` plans delay the chunks sent to one
machine. The traffic stays on TCP: the shared-memory ring is the serving
wire's, not the snapshots'.
"""

from __future__ import annotations

import hashlib
import json
import os
import socket
import tempfile
import threading
from typing import Optional

import numpy as np

from dask_ml_tpu_torch.parallel import framing

__all__ = [
    "SNAP_MAGIC",
    "SnapshotError",
    "SnapshotCorruptError",
    "SnapshotTransferError",
    "manifest_of",
    "ChunkCache",
    "SnapshotServer",
    "fetch_snapshot",
    "parse_address",
]

#: snapshot-wire magic: the shared frame layout (magic + length + sha256)
#: under its own version byte, so a snapshot socket can never be confused
#: with the request wire (``DMLTWIRE3``) or a registry file on disk
SNAP_MAGIC = b"DMLTSNAP1\n"

#: default chunk size — large enough that manifest overhead is noise,
#: small enough that a one-model edit in a big registry shares most
#: chunk addresses with its predecessor
DEFAULT_CHUNK_BYTES = 4 * 1024 * 1024


class SnapshotError(RuntimeError):
    """Base class for snapshot-distribution failures."""


class SnapshotCorruptError(SnapshotError):
    """Chunk bytes do not hash to their content address (or an assembled
    snapshot fails its manifest hash). Deliberately NOT transient: the
    frame checksum already caught link corruption upstream, so this is a
    lying peer or a poisoned store — loud, never retried."""


class SnapshotTransferError(SnapshotError, OSError):
    """The transfer itself failed (socket error, torn frame, server
    refused). Subclasses ``OSError`` so the default
    :class:`~dask_ml_tpu_torch.parallel.faults.RetryPolicy` retries it."""


def _sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def manifest_of(path: str, *,
                chunk_bytes: int = DEFAULT_CHUNK_BYTES) -> dict:
    """Chunk the file at ``path`` into fixed-size pieces and return its
    manifest: per-chunk ``{sha256, size, offset}`` rows plus the
    whole-file sha256 — the complete recipe for a content-addressed,
    resumable fetch."""
    chunk_bytes = int(chunk_bytes)
    if chunk_bytes < 1:
        raise ValueError("chunk_bytes must be >= 1")
    chunks = []
    total = hashlib.sha256()
    offset = 0
    with open(path, "rb") as f:
        while True:
            data = f.read(chunk_bytes)
            if not data:
                break
            total.update(data)
            chunks.append({"sha256": _sha256(data), "size": len(data),
                           "offset": offset})
            offset += len(data)
    return {"total_sha256": total.hexdigest(), "size": offset,
            "chunk_bytes": chunk_bytes, "chunks": chunks}


class ChunkCache:
    """Per-machine content-addressed chunk store: one file per chunk,
    named by its sha256. ``put`` verifies before writing (atomically);
    ``get`` re-verifies after reading — an entry whose CONTENT no longer
    matches its address (bit rot, a stale file landed on the colliding
    path) is discarded and counted, and the caller re-fetches."""

    def __init__(self, root: str):
        self.root = str(root)
        os.makedirs(self.root, exist_ok=True)
        self._lock = threading.Lock()
        self.n_hits = 0
        self.n_stale_discarded = 0

    def path(self, sha256: str) -> str:
        if not sha256 or os.sep in sha256 or "." in sha256:
            raise ValueError(f"malformed chunk address {sha256!r}")
        return os.path.join(self.root, f"{sha256}.chunk")

    def get(self, sha256: str) -> Optional[bytes]:
        p = self.path(sha256)
        try:
            with open(p, "rb") as f:
                data = f.read()
        except OSError:
            return None
        if _sha256(data) != sha256:
            # stale/corrupt entry on the colliding path: resume exactly
            # by treating it as a miss (and never serving it)
            with self._lock:
                self.n_stale_discarded += 1
            try:
                os.unlink(p)
            except OSError:
                pass
            return None
        with self._lock:
            self.n_hits += 1
        return data

    def put(self, sha256: str, data: bytes) -> None:
        if _sha256(data) != sha256:
            raise SnapshotCorruptError(
                f"chunk does not hash to its address {sha256[:12]}… "
                f"({len(data)} bytes)")
        p = self.path(sha256)
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(data)
            os.replace(tmp, p)  # concurrent replicas race atomically
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise


class SnapshotServer:
    """Serves one snapshot file's manifest and chunks over the framed
    wire (module docstring has the protocol). Runs in the ROUTER
    process; chunk reads are range reads against the file, verified
    against the cached manifest before sending — the server never ships
    bytes that stopped matching their address (a half-written swap reads
    as an error, and the client retries after the atomic rename lands).

    ``refresh()`` re-manifests after the snapshot file is replaced
    (version swap); it also runs automatically when the file's
    (mtime, size) changes. ``fault_injector`` arms per-machine
    ``slow_link`` plans (the client labels its requests with its
    machine name)."""

    def __init__(self, path: str, host: str = "127.0.0.1", port: int = 0,
                 *, chunk_bytes: int = DEFAULT_CHUNK_BYTES,
                 fault_injector=None):
        self.path = str(path)
        self.chunk_bytes = int(chunk_bytes)
        self._injector = fault_injector
        self._lock = threading.Lock()
        self._manifest: Optional[dict] = None
        self._by_hash: dict = {}
        self._stamp: Optional[tuple] = None
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, int(port)))
        self._sock.listen(64)
        self.address = self._sock.getsockname()
        self._stop = threading.Event()
        self._accept_thread: Optional[threading.Thread] = None
        self._conns: list = []
        self.n_manifests = 0
        self.n_chunks = 0
        self.n_bytes_sent = 0

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> "SnapshotServer":
        if self._accept_thread is not None:
            return self
        self.refresh()
        self._accept_thread = threading.Thread(
            target=self._accept_loop, name="snapshot-server-accept",
            daemon=True)
        self._accept_thread.start()
        return self

    def __enter__(self) -> "SnapshotServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self) -> None:
        self._stop.set()
        try:
            self._sock.close()
        except OSError:
            pass
        for conn in list(self._conns):
            try:
                conn.close()
            except OSError:
                pass

    def refresh(self) -> dict:
        """(Re)manifest the snapshot file — call after replacing it, or
        let the (mtime, size) stamp trigger it lazily."""
        st = os.stat(self.path)
        manifest = manifest_of(self.path, chunk_bytes=self.chunk_bytes)
        with self._lock:
            self._manifest = manifest
            self._by_hash = {c["sha256"]: c for c in manifest["chunks"]}
            self._stamp = (st.st_mtime_ns, st.st_size)
        return manifest

    def _current_manifest(self) -> dict:
        try:
            st = os.stat(self.path)
            stamp = (st.st_mtime_ns, st.st_size)
        except OSError as e:
            raise SnapshotTransferError(
                f"snapshot file unreadable: {e!r}")
        with self._lock:
            if self._manifest is not None and self._stamp == stamp:
                return self._manifest
        return self.refresh()

    # -- the wire ----------------------------------------------------------

    def _accept_loop(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _addr = self._sock.accept()
            except OSError:
                return  # listener closed
            self._conns.append(conn)
            threading.Thread(target=self._serve_conn, args=(conn,),
                             name="snapshot-server-conn",
                             daemon=True).start()

    def _serve_conn(self, conn) -> None:
        try:
            while not self._stop.is_set():
                try:
                    payload = framing.read_frame(conn, magic=SNAP_MAGIC)
                except framing.FrameError as e:
                    self._reply(conn, {"ok": False,
                                       "error": type(e).__name__,
                                       "message": str(e)})
                    return
                if payload is None:
                    return  # clean EOF
                try:
                    self._handle(conn, payload)
                except OSError:
                    return  # peer went away mid-reply
        finally:
            try:
                conn.close()
            except OSError:
                pass
            if conn in self._conns:
                self._conns.remove(conn)

    def _reply(self, conn, control: dict, arrays=()) -> None:
        framing.write_frame(conn, framing.encode_payload(control, arrays),
                            magic=SNAP_MAGIC)

    def _handle(self, conn, payload: bytes) -> None:
        try:
            msg, _arrays = framing.decode_payload(payload)
            op = msg.get("op")
            if op == "manifest":
                manifest = self._current_manifest()
                self.n_manifests += 1
                self._reply(conn, {"ok": True, "manifest": manifest})
                return
            if op != "chunk":
                raise ValueError(f"unknown snapshot op {op!r}")
            h = str(msg.get("sha256") or "")
            machine = str(msg.get("machine") or "")
            manifest = self._current_manifest()
            with self._lock:
                row = self._by_hash.get(h)
            if row is None:
                raise KeyError(f"no chunk {h[:12]}… in current manifest")
            with open(self.path, "rb") as f:
                f.seek(int(row["offset"]))
                data = f.read(int(row["size"]))
            if _sha256(data) != h:
                # the file changed under the manifest (mid-swap read):
                # an error the client retries, never silent bad bytes
                raise SnapshotError(
                    f"chunk {h[:12]}… changed on disk; re-fetch the "
                    "manifest")
            if self._injector is not None:
                delay = self._injector.link_delay(machine)
                if delay > 0.0:
                    import time as time_mod

                    time_mod.sleep(delay)
            self.n_chunks += 1
            self.n_bytes_sent += len(data)
            self._reply(conn, {"ok": True, "sha256": h},
                        arrays=(np.frombuffer(data, dtype=np.uint8),))
        except OSError:
            raise
        except Exception as e:  # noqa: BLE001 — per-request error delivery
            self._reply(conn, {"ok": False, "error": type(e).__name__,
                               "message": str(e)})


class _SnapClient:
    """One reconnecting snapshot-wire connection (request/response,
    strictly sequential — chunk fetches pipeline through the cache, not
    the socket)."""

    def __init__(self, address, timeout: Optional[float] = 30.0):
        self.address = (address[0], int(address[1]))
        self.timeout = timeout
        self._sock = None

    def close(self) -> None:
        if self._sock is not None:
            try:
                self._sock.close()
            except OSError:
                pass
            self._sock = None

    def _roundtrip(self, control: dict) -> tuple:
        try:
            if self._sock is None:
                self._sock = socket.create_connection(
                    self.address, timeout=self.timeout)
            framing.write_frame(self._sock,
                                framing.encode_payload(control),
                                magic=SNAP_MAGIC)
            payload = framing.read_frame(self._sock, magic=SNAP_MAGIC)
            if payload is None:
                raise SnapshotTransferError(
                    "snapshot server closed the connection")
            return framing.decode_payload(payload)
        except (OSError, framing.FrameError) as e:
            # drop the connection: the NEXT attempt (under the caller's
            # RetryPolicy) reconnects cleanly
            self.close()
            if isinstance(e, SnapshotTransferError):
                raise
            raise SnapshotTransferError(
                f"snapshot transfer failed: {e!r}")

    def manifest(self) -> dict:
        msg, _arrays = self._roundtrip({"op": "manifest"})
        if not msg.get("ok"):
            raise SnapshotTransferError(
                f"manifest refused: [{msg.get('error')}] "
                f"{msg.get('message')}")
        return dict(msg["manifest"])

    def chunk(self, sha256: str, machine: str = "") -> bytes:
        msg, arrays = self._roundtrip(
            {"op": "chunk", "sha256": str(sha256),
             "machine": str(machine)})
        if not msg.get("ok"):
            raise SnapshotTransferError(
                f"chunk {sha256[:12]}… refused: [{msg.get('error')}] "
                f"{msg.get('message')}")
        if len(arrays) != 1:
            raise SnapshotTransferError(
                f"chunk response carried {len(arrays)} buffers")
        return arrays[0].tobytes()


def fetch_snapshot(address, dest_path: str, *, cache_dir: str,
                   machine: str = "", retry_policy=None,
                   timeout: Optional[float] = 30.0,
                   fetch_chunk=None) -> dict:
    """Fetch the server's current snapshot into ``dest_path`` through
    the per-machine :class:`ChunkCache` at ``cache_dir``; returns the
    transfer accounting (``bytes_fetched`` is the delta the link
    actually carried — the quantity the fleet's re-ship gates measure).

    Every verified chunk persists to the cache BEFORE the next is
    requested, so a fetch killed mid-transfer resumes exactly; transport
    faults retry under ``retry_policy`` (default: a fresh
    :class:`~dask_ml_tpu_torch.parallel.faults.RetryPolicy`); a chunk whose
    bytes do not hash to their address raises
    :class:`SnapshotCorruptError` immediately. ``fetch_chunk`` overrides
    the wire fetch (tests inject truncation/corruption there)."""
    from dask_ml_tpu_torch.parallel import telemetry
    from dask_ml_tpu_torch.parallel.faults import RetryPolicy

    retry = retry_policy if retry_policy is not None else RetryPolicy()
    cache = ChunkCache(cache_dir)
    client = _SnapClient(address, timeout=timeout)
    stale0 = cache.n_stale_discarded
    try:
        manifest = retry.run(client.manifest, kind="snapshot.manifest")
        stats = {"chunks_total": len(manifest["chunks"]),
                 "chunks_fetched": 0, "chunks_cached": 0,
                 "bytes_fetched": 0, "bytes_total": int(manifest["size"]),
                 "stale_discarded": 0}
        d = os.path.dirname(os.path.abspath(dest_path)) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".snap.tmp")
        try:
            total = hashlib.sha256()
            with os.fdopen(fd, "wb") as out:
                for row in manifest["chunks"]:
                    h = row["sha256"]
                    data = cache.get(h)
                    if data is None:
                        if fetch_chunk is not None:
                            data = retry.run(
                                lambda h=h: fetch_chunk(h),
                                kind="snapshot.chunk", detail=h[:12])
                        else:
                            data = retry.run(
                                lambda h=h: client.chunk(h, machine),
                                kind="snapshot.chunk", detail=h[:12])
                        # content address is the trust boundary: verify
                        # BEFORE the cache (put re-checks) and fail loud
                        # — the frame checksum already ruled out link
                        # noise, so a mismatch is a lying peer
                        if _sha256(data) != h:
                            raise SnapshotCorruptError(
                                f"fetched chunk does not hash to "
                                f"{h[:12]}…")
                        cache.put(h, data)
                        stats["chunks_fetched"] += 1
                        stats["bytes_fetched"] += len(data)
                        if telemetry.enabled():
                            telemetry.metrics().counter(
                                "snapshot.bytes_fetched",
                                machine=machine or "local",
                            ).inc(len(data))
                    else:
                        stats["chunks_cached"] += 1
                    total.update(data)
                    out.write(data)
                out.flush()
                os.fsync(out.fileno())
            if total.hexdigest() != manifest["total_sha256"]:
                raise SnapshotCorruptError(
                    "assembled snapshot does not hash to the manifest's "
                    "total_sha256")
            os.replace(tmp, dest_path)
        except BaseException:
            try:
                os.unlink(tmp)
            except OSError:
                pass
            raise
    finally:
        client.close()
    stats["stale_discarded"] = cache.n_stale_discarded - stale0
    stats["manifest_sha256"] = manifest["total_sha256"]
    return stats


def parse_address(spec: str) -> tuple:
    """``"host:port"`` → ``(host, port)`` (the replica CLI's snapshot
    server argument)."""
    host, _, port = str(spec).rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(f"malformed snapshot server address {spec!r} "
                         "(want host:port)")
    return (host, int(port))


def _json_roundtrip_safe(manifest: dict) -> dict:
    """Manifest rows travel a JSON control envelope — assert nothing
    non-JSON leaked in (used by tests as the wire-layout pin)."""
    return json.loads(json.dumps(manifest))

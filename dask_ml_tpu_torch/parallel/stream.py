"""Host→device block streaming for data larger than the card's memory
(counterpart of ``dask_ml_tpu/parallel/stream.py``).

- :class:`HostBlockSource` owns host arrays (or a per-block loader) and
  copies block ``b`` to the card on a copy stream of its own, so block
  ``b+1`` moves while block ``b`` is computed.
- :func:`prefetched_scan` is the host-driven scan over such a source:
  ``prefetch`` copies kept in flight ahead of the consuming step (2 is
  double buffering), or, at depth 0, the strict serial schedule (copy,
  wait, compute, wait) that the overlap is measured against.

The transfer design. A copy overlaps compute only if the host memory is
page-locked: from pageable memory ``cudaMemcpyAsync`` returns only once
the driver has staged the bytes, so the host loop waits on every copy.

- Arrays mode registers the owned arrays in place
  (``cudaHostRegister``, through ``torch.cuda.cudart()``) when the source
  is made: a block is then a view of locked memory and its copy is one
  DMA that the host only enqueues. Registration is process-wide in the
  driver, so it is counted per buffer and undone when the last source
  over the buffer goes away, after its copies have completed.
- Loader-mode blocks, blocks encoded on the host (a CSR slice as ELL) and
  a padded tail are fresh arrays each time: they are copied into pinned
  memory from PyTorch's caching host allocator (``pin_memory``), which
  keeps each staging buffer until the copy out of it is done.

Each block's copies are issued on the source's ``torch.cuda.Stream`` and
followed by one event; :meth:`HostBlockSource.take` makes the consumer's
stream wait on that event (no host wait) and records the block's tensors
on that stream for the caching allocator. The host buffers a copy reads
stay referenced until its event has completed, blocks dropped by
:meth:`HostBlockSource.discard_inflight` included. Nothing here
synchronizes the whole device; only the depth-0 schedule waits, on
purpose, on the consumer's stream.

The trajectory contract: a source of B blocks fed to ``admm_streamed`` or
``streamed_moments`` gives the same result as a callable ``block_fn``
handing over the same block contents, because both modes run one
per-block function.
"""

from __future__ import annotations

import copy
import threading
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from dask_ml_tpu_torch.config import resolve_device
from dask_ml_tpu_torch.ops.sparse import SparseRows, ell_from_csr
from dask_ml_tpu_torch.parallel import precision, telemetry
from dask_ml_tpu_torch.parallel.faults import BlockFetchError, Preempted

__all__ = ["HostBlockSource", "prefetched_scan"]


def _is_scipy_sparse(a) -> bool:
    import scipy.sparse

    return scipy.sparse.issparse(a)


def _logical_nbytes(a) -> int:
    """What a block element would weigh dense: n·d·itemsize for a sparse
    element, ``nbytes`` for a dense array."""
    if isinstance(a, SparseRows):
        n, d = a.shape
        return int(n) * int(d) * int(np.dtype(a.values.dtype).itemsize)
    return int(a.nbytes)


def _leaves(a) -> list:
    """The arrays or tensors of one block element."""
    return [a.values, a.cols] if isinstance(a, SparseRows) else [a]


def _map_element(fn, a):
    """``fn`` over the leaves of one block element."""
    if isinstance(a, SparseRows):
        return SparseRows(fn(a.values), fn(a.cols), a.d)
    return fn(a)


def _torch_dtype(np_dtype) -> torch.dtype:
    return torch.from_numpy(np.empty(0, np_dtype)).dtype


# ---------------------------------------------------------------------------
# page-locked host buffers
# ---------------------------------------------------------------------------

#: in-place registrations of this process: base pointer → [bytes, users];
#: the driver refuses a second registration of the same range
_registered: dict = {}
_registered_lock = threading.Lock()


def _check(err, what: str) -> None:
    if int(err) != 0:
        raise RuntimeError(f"{what} failed with cudaError {int(err)} "
                           f"({err!r})")


class _PinnedHost:
    """Host arrays registered in place with ``cudaHostRegister`` for the
    life of this object. :meth:`note` records the event of a copy out of
    the memory; :meth:`close` waits for those before unregistering, so no
    DMA reads memory that is no longer locked."""

    def __init__(self, arrays: Sequence[np.ndarray]):
        self._arrays = [a for a in arrays if a.nbytes]
        self._ranges = []
        self._events: list = []
        cudart = torch.cuda.cudart()
        try:
            for a in self._arrays:
                ptr, size = int(a.ctypes.data), int(a.nbytes)
                with _registered_lock:
                    entry = _registered.get(ptr)
                    if entry is None:
                        _check(cudart.cudaHostRegister(ptr, size, 0),
                               f"cudaHostRegister of {size} bytes")
                        _registered[ptr] = [size, 1]
                    elif entry[0] == size:
                        entry[1] += 1
                    else:
                        raise RuntimeError(
                            f"host buffer at {ptr:#x} is already registered "
                            f"with {entry[0]} bytes, not {size}")
                self._ranges.append((ptr, size))
        except BaseException:
            self.close()
            raise

    def covers(self, a: np.ndarray) -> bool:
        """Does ``a`` lie inside a registered array?"""
        p = int(a.ctypes.data)
        return any(b <= p and p + a.nbytes <= b + s for b, s in self._ranges)

    def note(self, event) -> None:
        self._events = [e for e in self._events if not e.query()]
        self._events.append(event)

    def close(self) -> None:
        for e in self._events:
            e.synchronize()
        self._events = []
        if not self._ranges:
            return
        cudart = torch.cuda.cudart()
        with _registered_lock:
            for ptr, _ in self._ranges:
                entry = _registered[ptr]
                entry[1] -= 1
                if entry[1] == 0:
                    del _registered[ptr]
                    _check(cudart.cudaHostUnregister(ptr),
                           "cudaHostUnregister")
        self._ranges = []

    def __del__(self):
        self.close()


# ---------------------------------------------------------------------------
# the source
# ---------------------------------------------------------------------------


class HostBlockSource:
    """A host-resident row-block source for the streamed solvers.

    Two ways to make one:

    - ``HostBlockSource((X, y, w), n_blocks=40)`` — a tuple of host arrays
      sharing axis 0 (``(X, w)`` for PCA, ``(X, y, w)`` for the GLMs), cut
      into ``n_blocks`` equal row blocks. Arrays are made contiguous and,
      on the card, registered in place so that every block copy is one
      DMA. An element may be a scipy sparse matrix (each block's CSR slice
      is encoded as ELL at the source-wide slot bucket) or a
      :class:`~dask_ml_tpu_torch.ops.sparse.SparseRows` container.
    - ``HostBlockSource(loader=f, n_blocks=40)`` — ``f(b)`` returns block
      ``b`` as a tuple of host arrays (the out-of-core path). A scipy
      sparse element is encoded at the slot bucket of block 0's element
      at its position (block 0 is read to learn it when another block
      comes first), fixed from then on: a later block with a wider row
      raises.

    ``transform`` is applied to the block tuple by the consumer, on the
    device (the facade's intercept append). ``prefetch`` is the depth the
    consumers use by default: 2 double-buffers, 0 is the strict serial
    schedule. ``device`` is where blocks go (default: the configured one).

    A ragged tail pads: when the rows do not split into equal blocks, or
    the loader's last block is short, it is zero-padded to the common
    block shape (:func:`~dask_ml_tpu_torch.parallel.shapes.pad_tail`).
    Zero rows are weight-0 rows for every consumer here. ``pad_tail=None``
    pads only when the block tuple's last array is 1-D (the weight vector
    of every consumer here); pass ``False`` when it is not a weight,
    ``True`` to vouch for one. A short block that is not the tail always
    raises.

    ``retry_policy`` (:class:`~dask_ml_tpu_torch.parallel.faults.RetryPolicy`)
    makes block reads and copies survive transient failures;
    ``fault_injector`` injects such failures. ``storage_dtype`` is the
    wire dtype: ``"policy"`` (the default) takes the active precision
    policy's storage dtype (bf16 under ``precision="bf16"``, none under
    ``"auto"``), ``None`` streams uncast, or a dtype. The cast is
    :func:`~dask_ml_tpu_torch.parallel.precision.cast_wire` on the host,
    at transfer (``host_block`` stays the exact host view): floating
    leaves with ``ndim >= 2`` narrow into page-locked memory, labels,
    weights and a container's columns never do, and nothing widens.

    Counters: ``bytes_streamed`` (bytes copied), ``logical_bytes_streamed``
    (what the same blocks weigh dense) and ``blocks_started``. They count
    a copy once it is issued, a retried copy once, and
    :meth:`discard_inflight` takes back copies that were issued but never
    consumed, so they equal what compute consumed. With the ``telemetry``
    knob on, the same sites add to ``stream.bytes_streamed``,
    ``stream.logical_bytes_streamed`` and ``stream.blocks_started``, and,
    with ``host_rank`` set (the elastic tier sets it), to
    ``stream.bytes{host=<rank>}``."""

    def __init__(self, arrays: Optional[Sequence] = None,
                 n_blocks: Optional[int] = None, *,
                 loader: Optional[Callable[[int], tuple]] = None,
                 transform: Optional[Callable] = None,
                 prefetch: int = 2, device=None,
                 retry_policy=None, fault_injector=None,
                 pad_tail: Optional[bool] = None,
                 storage_dtype="policy", host_rank: Optional[int] = None):
        if (arrays is None) == (loader is None):
            raise ValueError(
                "pass exactly one of `arrays` (host array tuple) or "
                "`loader` (per-block callable)")
        if n_blocks is None or int(n_blocks) < 1:
            raise ValueError("n_blocks must be a positive integer")
        if isinstance(storage_dtype, str) and storage_dtype == "policy":
            storage_dtype = precision.resolve().storage_dtype()
        storage_dtype = precision.as_dtype(storage_dtype)
        self.n_blocks = int(n_blocks)
        self.prefetch = int(prefetch)
        self.transform = transform
        self.pad_tail = pad_tail if pad_tail is None else bool(pad_tail)
        self.storage_dtype = storage_dtype
        self.device = resolve_device(device)
        self._loader = loader
        self._arrays: Optional[tuple] = None
        self._rows = None
        # per-position ELL slot buckets of sparse elements, fixed once
        self._ell_k: dict = {}
        self._pinned = None
        if arrays is not None:
            self._arrays = self._own(arrays)
            n = self._arrays[0].shape[0]
            if n % self.n_blocks and not self._may_pad(self._arrays):
                raise ValueError(
                    f"{n} rows do not split into {self.n_blocks} equal "
                    "blocks; padding the tail needs a trailing 1-D per-row "
                    "weight array in the block tuple (zero rows are inert "
                    "only under weights) or an explicit pad_tail=True — "
                    "otherwise pad the tail rows (weight 0) yourself")
            self._rows = -(-n // self.n_blocks)
            if self.device.type == "cuda":
                self._pinned = _PinnedHost(
                    [leaf for a in self._arrays if not _is_scipy_sparse(a)
                     for leaf in _leaves(a)])
        self.retry_policy = retry_policy
        self.fault_injector = fault_injector
        #: the elastic process rank this source streams for: with it set,
        #: copied bytes also go to the ``stream.bytes{host=<rank>}``
        #: counter, so a multi-host fit's bytes break down by host
        self.host_rank = None if host_rank is None else int(host_rank)
        self._stream = None
        self._inflight: dict = {}
        self._inflight_bytes: dict = {}
        self._retired: list = []
        self._out_struct = None
        self.bytes_streamed = 0
        self.logical_bytes_streamed = 0
        self.blocks_started = 0

    def _own(self, arrays) -> tuple:
        """The arrays as this source keeps them: contiguous and writable
        (a tensor view of a read-only array is refused), sparse matrices
        as CSR with their slot bucket noted."""
        from dask_ml_tpu_torch.parallel.shapes import bucket_nnz

        def dense(a):
            a = np.ascontiguousarray(a)
            return a if a.flags.writeable else a.copy()

        out = []
        for i, a in enumerate(arrays):
            if _is_scipy_sparse(a):
                a = a.tocsr()
                row_nnz = np.diff(a.indptr)
                self._ell_k[i] = bucket_nnz(
                    int(row_nnz.max()) if a.shape[0] else 0)
            elif isinstance(a, SparseRows):
                a = SparseRows(dense(a.values), dense(a.cols), a.d)
            else:
                a = dense(a)
            out.append(a)
        n = out[0].shape[0]
        if any(a.shape[0] != n for a in out[1:]):
            raise ValueError(
                f"all arrays must share axis 0: got lengths "
                f"{[a.shape[0] for a in out]}")
        return tuple(out)

    def _may_pad(self, blk) -> bool:
        if self.pad_tail is not None:
            return self.pad_tail
        return len(blk) >= 2 and np.asarray(blk[-1]).ndim == 1

    # -- host side ---------------------------------------------------------

    def host_block(self, b: int) -> tuple:
        """Block ``b`` as host arrays (views of the owned arrays, or the
        loader's output), the tail padded. Under a ``retry_policy``
        transient read failures back off and retry."""
        if not 0 <= b < self.n_blocks:
            raise IndexError(f"block {b} out of range [0, {self.n_blocks})")

        def coerce(i, a):
            if isinstance(a, SparseRows):
                return SparseRows(np.asarray(a.values), np.asarray(a.cols),
                                  a.d)
            if _is_scipy_sparse(a):
                return ell_from_csr(a.tocsr(), k=self._loader_bucket(i, b, a))
            return np.asarray(a)

        def read():
            if self.fault_injector is not None:
                self.fault_injector.on_load(b)
            if self._arrays is not None:
                s = b * self._rows
                blk = []
                for i, a in enumerate(self._arrays):
                    part = a[s:s + self._rows]
                    if _is_scipy_sparse(part):
                        part = ell_from_csr(part, k=self._ell_k[i])
                    blk.append(part)
                blk = tuple(blk)
            else:
                blk = tuple(coerce(i, a)
                            for i, a in enumerate(self._loader(b)))
            return self._pad_block(b, blk)

        if self.retry_policy is None:
            return read()
        return self.retry_policy.run(read, kind="block-load",
                                     detail=f"block {b}")

    def _loader_bucket(self, i: int, b: int, a) -> int:
        """The slot bucket of the sparse element at position ``i`` of a
        loader's blocks: learned from block 0 (read now if block ``b`` is
        another), so it does not depend on which block a host reads first
        (an elastic host's shard, a resume) and every roster encodes each
        block at one width."""
        from dask_ml_tpu_torch.parallel.shapes import bucket_nnz

        k = self._ell_k.get(("loader", i))
        if k is None:
            if b != 0:
                if self.fault_injector is not None:
                    self.fault_injector.on_load(0)
                a = self._loader(0)[i]
            a = a.tocsr()
            row_nnz = np.diff(a.indptr)
            k = bucket_nnz(int(row_nnz.max()) if a.shape[0] else 0)
            self._ell_k[("loader", i)] = k
        return k

    def _pad_block(self, b: int, blk: tuple) -> tuple:
        """Zero-pad a short tail block to the common row count (see the
        class docstring); a short block that is not the tail raises."""
        if self.pad_tail is False or not self._may_pad(blk):
            return blk
        rows = int(blk[0].shape[0])
        if self._rows is None:
            # loader mode learns the common shape from any block but the
            # last; if the first read is the tail (a resume landing
            # there), block 0 is read to learn it
            if b < self.n_blocks - 1 or self.n_blocks == 1:
                self._rows = rows
                return blk
            if self.fault_injector is not None:
                self.fault_injector.on_load(0)
            self._rows = int(np.shape(self._loader(0)[0])[0])
        if rows == self._rows:
            return blk
        if rows > self._rows:
            raise ValueError(
                f"block {b} has {rows} rows, more than the common block "
                f"shape of {self._rows}; only the ragged TAIL may be short")
        if b != self.n_blocks - 1:
            raise ValueError(
                f"block {b} has {rows} rows but the common block shape is "
                f"{self._rows}; only the ragged TAIL (block "
                f"{self.n_blocks - 1}) may be short — a short interior "
                "block means truncated input, which padding would hide")
        from dask_ml_tpu_torch.parallel.shapes import pad_tail

        return pad_tail(blk, self._rows)

    @property
    def out_struct(self) -> tuple:
        """One block as the consumer sees it (after ``transform``), as
        tensors on the ``meta`` device: shapes and dtypes, no data. Cached:
        in loader mode it reads block 0 once."""
        if self._out_struct is None:
            def meta(a):
                dt = (a.dtype if isinstance(a, torch.Tensor)
                      else _torch_dtype(a.dtype))
                return torch.empty(a.shape, dtype=dt, device="meta")

            structs = tuple(_map_element(meta, a)
                            for a in self._cast_wire(self.host_block(0),
                                                     pin=False))
            if self.transform is not None:
                structs = tuple(self.transform(structs))
            self._out_struct = structs
        return self._out_struct

    # -- the transfer pipeline ---------------------------------------------

    def _copy_stream(self):
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        return self._stream

    def _cast_wire(self, blk: tuple, pin: bool = True) -> tuple:
        """The block on the wire dtype (a no-op without one); on the card
        the narrowed leaves are written into page-locked memory."""
        return precision.cast_wire(blk, self.storage_dtype,
                                   pin=pin and self.device.type == "cuda")

    def _put(self, blk: tuple):
        """Block tensors on the device, and what must outlive the copy:
        ``(tensors, event, host buffers)``. On the card the copies run on
        the source's stream from locked memory (the registered arrays, or
        a pinned staging copy) and one event follows them; on the CPU the
        block is copied into fresh tensors."""
        if self.device.type != "cuda":
            dev = tuple(_map_element(
                lambda a: (a.clone() if isinstance(a, torch.Tensor)
                           else torch.tensor(a)), a) for a in blk)
            return dev, None, None
        keep = []

        def one(a):
            if isinstance(a, torch.Tensor):  # narrowed by the wire cast
                h = a if a.is_pinned() else a.pin_memory()
            else:
                h = torch.from_numpy(a)
                if self._pinned is None or not self._pinned.covers(a):
                    h = h.pin_memory()
            keep.append(h)
            return h.to(self.device, non_blocking=True)

        stream = self._copy_stream()
        with torch.cuda.stream(stream):
            dev = tuple(_map_element(one, a) for a in blk)
            event = torch.cuda.Event()
            event.record(stream)
        if self._pinned is not None:
            self._pinned.note(event)
        return dev, event, keep

    def _retire(self, event, keep) -> None:
        """Keep ``keep`` referenced until ``event`` has completed."""
        self._retired = [r for r in self._retired if not r[0].query()]
        if event is not None:
            self._retired.append((event, keep))

    def start(self, b: int) -> None:
        """Issue the copy of block ``b`` to the device. Idempotent while
        the block is in flight. Under a ``retry_policy`` a transient
        failure backs off and re-issues; the counters move once the copy
        is issued, so a retried copy counts once."""
        if b in self._inflight:
            return
        with telemetry.span("stream.transfer", block=b):
            blk = self.host_block(b)
            # logical: what the block weighs dense and uncast, so logical /
            # wire is the combined sparse and precision reduction
            logical = sum(_logical_nbytes(a) for a in blk)
            blk = self._cast_wire(blk)

            def put():
                if self.fault_injector is not None:
                    self.fault_injector.on_transfer(b)
                return self._put(blk)

            if self.retry_policy is None:
                entry = put()
            else:
                entry = self.retry_policy.run(put, kind="device-put",
                                              detail=f"block {b}")
            nbytes = sum(int(leaf.nbytes) for a in blk
                         for leaf in _leaves(a))
        self._inflight[b] = entry
        self._inflight_bytes[b] = (nbytes, logical)
        self.bytes_streamed += nbytes
        self.logical_bytes_streamed += logical
        self.blocks_started += 1
        self._mirror(nbytes, logical, 1)

    def _mirror(self, wire: int, logical: int, blocks: int) -> None:
        """The registry mirrors of the three counters (and the per-host
        one), moved at the counters' own sites."""
        if not telemetry.enabled():
            return
        reg = telemetry.metrics()
        reg.counter("stream.bytes_streamed").inc(wire)
        reg.counter("stream.logical_bytes_streamed").inc(logical)
        reg.counter("stream.blocks_started").inc(blocks)
        if self.host_rank is not None:
            reg.counter("stream.bytes", host=str(self.host_rank)).inc(wire)

    def take(self, b: int) -> tuple:
        """Device tensors of block ``b``: in flight already when the
        pipeline prefetched it, started now otherwise. The consumer's
        current stream waits on the block's copies (the host does not), and
        the tensors are recorded on that stream. A terminal fetch failure
        raises :class:`~dask_ml_tpu_torch.parallel.faults.BlockFetchError`
        naming the block."""
        entry = self._inflight.pop(b, None)
        if entry is None:
            try:
                self.start(b)
            except (IndexError, BlockFetchError):
                raise
            except Exception as e:
                raise BlockFetchError(
                    f"block {b}/{self.n_blocks}: fetch failed terminally "
                    f"after retries ({type(e).__name__}: {e})") from e
            entry = self._inflight.pop(b)
        self._inflight_bytes.pop(b, None)
        dev, event, keep = entry
        if event is not None:
            cur = torch.cuda.current_stream(self.device)
            cur.wait_event(event)
            for a in dev:
                for t in _leaves(a):
                    t.record_stream(cur)
            self._retire(event, keep)
        return dev

    def discard_inflight(self) -> None:
        """Drop copies issued but not consumed (end of a run, an early
        stop, a preemption), take them back out of the counters, and wait
        for their copies to finish so that no host buffer is released
        under a running DMA. Copies issued before a :meth:`reset_stats`
        were never counted and are dropped without subtracting."""
        for b in list(self._inflight):
            entry = self._inflight_bytes.pop(b, None)
            if entry is not None:
                wire, logical = entry
                self.bytes_streamed -= wire
                self.logical_bytes_streamed -= logical
                self.blocks_started -= 1
                self._mirror(-wire, -logical, -1)
            _, event, _ = self._inflight.pop(b)
            if event is not None:
                event.synchronize()
        self._retire(None, None)

    def reset_stats(self) -> None:
        """Zero the counters between timed runs. Copies still in flight
        were counted against the old counters, so a later
        :meth:`discard_inflight` subtracts nothing for them. The retry
        policy keeps its own counters."""
        self.bytes_streamed = 0
        self.logical_bytes_streamed = 0
        self.blocks_started = 0
        self._inflight_bytes = {b: None for b in self._inflight}

    def close(self) -> None:
        """Discard in-flight copies and drop this source's hold on the
        registered host memory (unregistered once no source holds it)."""
        self.discard_inflight()
        for event, _ in self._retired:
            event.synchronize()
        self._retired = []
        self._pinned = None

    def with_transform(self, fn: Callable) -> "HostBlockSource":
        """A copy of this source whose blocks pass through ``fn`` after
        any existing transform. It shares the host arrays, their
        registration, the retry policy and the fault injector; its
        counters start at 0."""
        src = copy.copy(self)
        inner = self.transform
        src.transform = fn if inner is None else (
            lambda blk: fn(inner(blk)))
        src._stream = None
        src._inflight = {}
        src._inflight_bytes = {}
        src._retired = []
        src._out_struct = None
        src.reset_stats()
        return src


def _sync(device) -> None:
    """The depth-0 schedule's barrier: the host waits for the consumer's
    stream (which has waited on the block's copies)."""
    if device.type == "cuda":
        torch.cuda.current_stream(device).synchronize()


def prefetched_scan(step, carry, source: HostBlockSource, *,
                    prefetch: Optional[int] = None, wrap: bool = False,
                    checkpoint=None, epoch: int = 0, start_block: int = 0,
                    outs: Optional[list] = None, blocks=None):
    """Host-driven scan over a :class:`HostBlockSource`.

    ``step(carry, b, block) -> (carry, out)`` issues device work; returns
    ``(carry, outs)`` with ``outs`` the per-block list.

    ``prefetch`` (default: the source's) copies are kept in flight ahead
    of compute; ``wrap=True`` lets the lookahead run past the last block
    into block 0, priming the next epoch of an outer loop over the same
    source. Depth 0 is the serial baseline: each block's copy completes
    before its compute is issued, and the compute completes before the
    next copy is issued.

    ``checkpoint``
    (:class:`~dask_ml_tpu_torch.parallel.faults.ScanCheckpoint`): after
    every block the scan saves ``(carry, outs, next_block, epoch)`` when
    the interval says so, and polls the drain flag and the source's fault
    injector; a requested drain discards queued copies, saves and raises
    :class:`~dask_ml_tpu_torch.parallel.faults.Preempted`. Without a
    checkpoint an injected preemption raises ``Preempted`` with the
    progress lost. ``start_block`` / ``outs`` / ``epoch`` are a loaded
    snapshot's resume coordinates: the scan replays from the first
    incomplete block on a bit-identical trajectory.

    ``blocks`` (the elastic tier, ``parallel/elastic.py``) is an explicit
    sequence of block ids to consume, this host's shard of a shuffled
    epoch, in place of ``range(n_blocks)``. ``start_block`` is then a
    position in that sequence, ``step`` still receives the global block
    id, and snapshots save the sequence under ``meta["blocks"]``, so a
    resume replays it whatever the roster has become. ``wrap=True`` is
    refused with a sequence: the next epoch's order is the elastic
    loop's to know."""
    if blocks is None:
        seq, saved_seq = range(source.n_blocks), None
    else:
        if wrap:
            raise ValueError(
                "wrap=True cannot combine with an explicit blocks= "
                "sequence: the lookahead would need the next epoch's "
                "permutation, which only the elastic loop knows")
        seq = saved_seq = [int(b) for b in blocks]
    n = len(seq)
    depth = source.prefetch if prefetch is None else int(prefetch)
    outs = [] if outs is None else list(outs)
    start_block = int(start_block)
    injector = source.fault_injector

    def after_block(pos, carry):
        """Snapshot or drain after the block at position ``pos`` (the
        resume coordinate); the injector's plans key on the block id."""
        b = seq[pos]
        preempt = injector is not None and injector.should_preempt(b, epoch)
        if checkpoint is None:
            if preempt:
                source.discard_inflight()
                raise Preempted(
                    f"preempted after block {b} of epoch {epoch} with no "
                    "checkpoint configured; progress was lost")
            return
        drain = checkpoint.drain
        if preempt or (drain is not None and drain.requested):
            source.discard_inflight()
            checkpoint.save(carry, outs, pos + 1, epoch, reason="preempt",
                            blocks=saved_seq)
            raise Preempted(
                f"graceful drain: snapshot at block {pos + 1}/{n} of epoch "
                f"{epoch} saved to {checkpoint.path}; re-run with the same "
                "checkpoint path to resume", path=checkpoint.path)
        checkpoint.tick(carry, outs, pos + 1, epoch, blocks=saved_seq)

    if depth <= 0:
        for pos in range(start_block, n):
            b = seq[pos]
            with telemetry.span("stream.block", block=b, epoch=epoch):
                blk = source.take(b)
                _sync(source.device)
                carry, out = step(carry, b, blk)
                _sync(source.device)
            outs.append(out)
            after_block(pos, carry)
        return carry, outs
    for j in range(min(depth, n - start_block)):
        source.start(seq[start_block + j])
    for pos in range(start_block, n):
        b = seq[pos]
        with telemetry.span("stream.block", block=b, epoch=epoch):
            blk = source.take(b)
            nxt = pos + depth
            if nxt < n:
                source.start(seq[nxt])
            elif wrap and nxt - n < n:
                source.start(seq[nxt - n])
            carry, out = step(carry, b, blk)
        outs.append(out)
        after_block(pos, carry)
    return carry, outs

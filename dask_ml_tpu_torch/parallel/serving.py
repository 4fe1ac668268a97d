"""Online inference of the PyTorch port: continuously batched serving on
one device (the counterpart of ``dask_ml_tpu/parallel/serving.py``).

- :class:`ModelRegistry` holds fitted estimators behind stable names.
  Registering one builds a *runner* per served method — KMeans,
  MiniBatchKMeans and the sketched KMeans assignment
  (``models/kmeans.py::predict_labels`` / ``predict_labels_sketched``, the
  fused distance kernel K2), the GLMs' ``predict`` / ``predict_proba``
  (``linear_model/glm.py::eta_program`` and the shared host epilogues),
  PCA's ``transform`` (``decomposition/pca.py::transform_program``), and
  the landmark models' ``predict`` (``SpectralClustering`` and
  ``KernelKMeans._assign_staged``: the kernel strip, the extension, K2)
  — each closing over the fitted state, staged on the device once. Any
  other estimator (a foreign one included) gets a host runner, so the
  batching path serves everything.
- :class:`ServingLoop` owns one dispatch thread and a bounded queue.
  ``submit()`` validates a request on the host and returns a
  ``concurrent.futures.Future``; the dispatch thread coalesces the queued
  requests of one (model, method) into a micro-batch, pads it on the host
  to a :class:`~dask_ml_tpu_torch.parallel.shapes.PadPolicy` bucket in
  the precision wire dtype, copies it to the device once, runs the
  family's runner and hands each caller its rows.
- **Served equals direct.** A runner calls the same function as the
  estimator's own method, and each output row depends only on its input
  row and the fitted state, so a served result equals the direct call
  however the requests were coalesced or padded — bit for bit for the
  K2 families, whose scores are one in-order ``fmaf`` chain a row. The
  dense GLM and PCA runners are plain products (cuBLAS on the card, whose
  algorithm may depend on the row count), see ROADMAP's caveats.
- **Compile once.** A loop's :meth:`ServingLoop.warmup` runs every
  (model, method, bucket) through the serving path, which builds and
  loads every kernel library the runners launch; steady traffic then
  builds and loads nothing
  (:func:`~dask_ml_tpu_torch.parallel.shapes.track_compiles`).
- **Streams.** On a CUDA device each loop owns a ``torch.cuda.Stream``
  that its dispatch thread makes current, so two loops on one card do not
  serialize on the default stream; fitted state is staged and then its
  stream synchronized before any other stream reads it, and a batch's
  results are read to the host with a blocking copy on the loop's stream.
- **Observability** goes through
  :mod:`~dask_ml_tpu_torch.parallel.telemetry`: ``serving.request`` spans
  on the blocking client path, ``serving.batch`` spans in the dispatch
  thread, the ``serving.queue_depth`` / ``serving.batch_occupancy`` /
  ``serving.window_s`` gauges, per-model ``serving.requests`` /
  ``serving.rows`` / ``serving.batches`` / ``serving.errors`` /
  ``serving.shed`` counters, and the ``serving.request_seconds`` /
  ``serving.batch_seconds`` / ``serving.batch_rows`` /
  ``serving.occupancy`` histograms. The dispatch thread inherits the
  caller's configuration at :meth:`ServingLoop.start`, and its telemetry
  knob when that was on.
- **Lifecycle.** The loop composes with
  :class:`~dask_ml_tpu_torch.parallel.faults.GracefulDrain` (stop
  accepting, flush every queued batch, resolve every future, exit). A
  :class:`~dask_ml_tpu_torch.parallel.faults.FaultInjector` transfer fault
  fails the affected batch's requests only, retried under a
  :class:`~dask_ml_tpu_torch.parallel.faults.RetryPolicy` when one is
  given, and never wedges the queue. A runner whose kernel fails to build
  or launch fails that batch's futures with the error; nothing falls back
  to the host.
- **Admission.** ``submit(priority=, deadline=)``: the dispatcher takes
  the earliest deadline first (priority breaks ties and orders the
  requests without a deadline), and a request whose deadline passes
  before dispatch is shed with :class:`DeadlineExceeded`. Once a stop or
  a drain begins ``submit`` raises :class:`ServingStopped`, and the
  dispatch thread's exit fails whatever it can no longer serve: a future
  is never left pending, even when the thread dies (``fatal``).
- **Versions.** Registry entries carry a monotonic ``version``;
  ``publish()`` and ``build()`` + ``install()`` are the hot-swap seams of
  :class:`~dask_ml_tpu_torch.parallel.fleet.ServingFleet`.

- **Over a mesh of ranks** (``ServingLoop(mesh=)``, in a
  ``torch.distributed`` world) every rank of the mesh starts the loop. The
  lowest rank leads: it alone holds the queue, the coalescer, the futures
  and the registry that serves, and only it accepts ``submit``. Each
  padded batch's bucket is a multiple of the mesh's data-shard count; for
  each batch the leader broadcasts a header (kind, model version, method,
  padded rows, width) and then the batch over the loop's process group,
  every rank runs the runner on its own row block (K2 / K2-x for the K2
  families), and the blocks come back to the leader by ``all_gather``, in
  data-shard order. Before a model version's first batch the leader
  broadcasts the version itself (the estimator, its tensors pickled from
  the host) and the followers build their runners from it: a
  ``publish``, ``install`` or fleet ``swap`` on the leader reaches every
  rank with its next batch, and a follower never runs another version
  than the leader's. A runner that raises on any rank gives an error
  marker in place of its block, so every rank still reaches the gather
  and the leader fails that batch alone. The followers serve until the
  leader broadcasts a stop (its ``stop()``); a follower's ``stop()``
  waits for it. The loop's group (the mesh's ranks plus the leader) is
  made with ``new_group`` at ``start()``, which every rank of the world
  must reach in the same order.

``ParallelPostFit(serving=loop)`` makes the wrapper a client of a loop (a
``ServingFleet`` drops in the same way).
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
import logging
import threading
import time
from collections import deque
from concurrent.futures import Future
from typing import Callable, Optional

import numpy as np
import torch

from dask_ml_tpu_torch.parallel.shapes import PadPolicy

__all__ = [
    "ServingLoop",
    "ModelRegistry",
    "ServedModel",
    "ServingError",
    "ServingClosed",
    "ServingStopped",
    "ServingQueueFull",
    "DeadlineExceeded",
    "DEFAULT_SERVING_POLICY",
    "serving_buckets",
]


class ServingError(RuntimeError):
    """Base class of the serving errors."""


class ServingClosed(ServingError):
    """The loop is draining or stopped: it accepts no new requests."""


class ServingStopped(ServingClosed):
    """The loop has stopped (a drain finished, ``stop(drain=False)``, or
    the dispatch thread died): a request that reached it will never be
    served there. ``submit()`` raises it once a stop or drain has begun,
    and every future the stopped loop can no longer serve gets it. The
    fleet router takes it as the signal to re-route and replay."""


class ServingQueueFull(ServingError):
    """The bounded queue is full (backpressure): retry with backoff or
    shed load. A fleet first spills over to a sibling replica."""


class DeadlineExceeded(ServingError):
    """The request's deadline passed before it could be dispatched: it
    was shed. Raised by ``submit()`` when the deadline is already past,
    set on the future when it expires in the queue."""


#: the header kinds a mesh loop's leader broadcasts: stop, run a batch,
#: take a model version
_HDR_STOP, _HDR_RUN, _HDR_MODEL = 0, 1, 2

#: the loop's process group timeout. A follower waits in a broadcast for
#: the leader's next header as long as the server is idle, which has no
#: bound; every rank reaches every gather (a runner's error travels as a
#: marker), so the timeout only ends a collective whose peer died
_FOLLOW_TIMEOUT = datetime.timedelta(days=7)


@dataclasses.dataclass
class _BlockFailed:
    """A rank's block in place of its output when its runner raised."""

    rank: int
    error: str

#: the serving bucket policy: powers of two from 32 rows. ``waste_cap=1``
#: keeps one bucket an octave (a handful of warmed shapes for any mix of
#: request sizes) at the price of up to 2x padded rows a batch
DEFAULT_SERVING_POLICY = PadPolicy(waste_cap=1.0, min_rows=32)


def serving_buckets(policy: PadPolicy, max_rows: int, align: int = 1):
    """The distinct bucket sizes ``policy`` gives batches of 1 ..
    ``max_rows`` rows (the shapes :meth:`ServingLoop.warmup` runs),
    ascending; the top one covers ``max_rows``."""
    out = []
    n = 1
    while n <= int(max_rows):
        b = policy.bucket(n, align=align)
        out.append(b)
        n = b + 1
    return out


# ---------------------------------------------------------------------------
# per-family runners
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class _Runner:
    """One served method: ``kind`` ``"device"`` (``run`` takes the staged,
    padded device batch and returns padded host outputs) or ``"host"``
    (``run`` takes the unpadded host batch)."""

    kind: str
    run: Callable


class _Staged:
    """Fitted state on a device, staged once per device: ``make(dev)``
    returns the tensors, and the stream they were queued on is
    synchronized before any other stream may read them. Staged at build
    time on the configured device; a loop on another device stages its own
    copy at its first batch (or its warmup)."""

    def __init__(self, make: Callable):
        self._make = make
        self._lock = threading.Lock()
        self._by_dev: dict = {}

    def stage(self, dev: torch.device):
        dev = torch.device(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        got = self._by_dev.get(dev)
        if got is not None:
            return got
        with self._lock:
            got = self._by_dev.get(dev)
            if got is None:
                got = tuple(self._make(dev))
                if dev.type == "cuda":
                    torch.cuda.current_stream(dev).synchronize()
                self._by_dev[dev] = got
        return got


def _f32_on(a, dev):
    return torch.as_tensor(np.array(a, dtype=np.float32), device=dev)


def _labels_to_host(labels, n_clusters: int) -> np.ndarray:
    """The assignment's host epilogue: a uint8 copy for at most 255
    clusters (a quarter of the bytes), widened to int32 on the host."""
    if int(n_clusters) <= 255:
        return labels.to(torch.uint8).cpu().numpy().astype(np.int32)
    return labels.cpu().numpy()


def _glm_runners(est, dev) -> dict:
    from dask_ml_tpu_torch.linear_model import glm as glm_lib

    staged = _Staged(lambda d: (_f32_on(est._coef, d),))
    staged.stage(dev)
    intercept = bool(est.fit_intercept)

    def eta(Xs):
        (coef,) = staged.stage(Xs.device)
        return glm_lib.eta_program(Xs, coef, intercept=intercept) \
            .cpu().numpy()

    runners = {}
    family = getattr(est, "family", None)
    if hasattr(est, "predict_proba"):  # classifier
        multiclass = getattr(est, "multiclass", "ovr")
        classes = getattr(est, "classes_", None)

        def run_proba(Xs):
            return glm_lib.proba_from_eta(eta(Xs), multiclass)

        def run_predict(Xs):
            return glm_lib.labels_from_proba(run_proba(Xs), classes)

        runners["predict_proba"] = _Runner("device", run_proba)
        runners["predict"] = _Runner("device", run_predict)
    elif family == "poisson":
        runners["predict"] = _Runner("device", lambda Xs: np.exp(eta(Xs)))
    else:  # linear
        runners["predict"] = _Runner("device", eta)
    return runners


def _kmeans_runners(est, dev) -> dict:
    from dask_ml_tpu_torch.models import kmeans as km_core

    k = int(est.n_clusters)
    if getattr(est, "fast_transform_", None) is not None:
        # a sketched model assigns through predict_labels_sketched, as
        # KMeans.predict does (against sketch_centers_)
        staged = _Staged(lambda d: est._sketch_args(d))
        staged.stage(dev)

        def run_sketched(Xs):
            labels = km_core.predict_labels_sketched(
                Xs, *staged.stage(Xs.device))
            return _labels_to_host(labels, k)

        return {"predict": _Runner("device", run_sketched)}

    staged = _Staged(lambda d: (_f32_on(est.cluster_centers_, d),))
    staged.stage(dev)

    def run(Xs):
        (centers,) = staged.stage(Xs.device)
        return _labels_to_host(km_core.predict_labels(Xs, centers), k)

    return {"predict": _Runner("device", run)}


def _pca_runners(est, dev) -> dict:
    from dask_ml_tpu_torch.decomposition import pca as pca_lib

    staged = _Staged(lambda d: (_f32_on(est.mean_, d),
                                _f32_on(est.components_, d),
                                _f32_on(est.explained_variance_, d)))
    staged.stage(dev)
    whiten = bool(est.whiten)

    def run(Xs):
        mean, components, ev = staged.stage(Xs.device)
        return pca_lib.transform_program(
            Xs, mean, components, ev, whiten=whiten).cpu().numpy()

    return {"transform": _Runner("device", run)}


def _landmark_runners(est) -> dict:
    def run(Xs):
        return est._assign_staged(Xs).cpu().numpy().astype(np.int32)

    return {"predict": _Runner("device", run)}


def _host_runners(est, methods) -> dict:
    """Any other estimator (foreign ones included): the loop still
    coalesces concurrent requests into one host batch a dispatch, but no
    device state is staged."""
    out = {}
    for m in methods:
        fn = getattr(est, m, None)
        if callable(fn):
            out[m] = _Runner("host", fn)
    return out


_SERVABLE_METHODS = ("predict", "predict_proba", "transform")


def _build_runners(est, methods=None) -> dict:
    """Family detection → runners; ``methods`` restricts the served
    surface (default: every servable method of the family). Device
    families stage their fitted state on the configured device."""
    from dask_ml_tpu_torch.cluster.k_means import KMeans
    from dask_ml_tpu_torch.cluster.kernel_kmeans import KernelKMeans
    from dask_ml_tpu_torch.cluster.minibatch import MiniBatchKMeans
    from dask_ml_tpu_torch.cluster.spectral import SpectralClustering
    from dask_ml_tpu_torch.config import resolve_device
    from dask_ml_tpu_torch.decomposition.pca import PCA
    from dask_ml_tpu_torch.linear_model.glm import _GLM

    if isinstance(est, (KMeans, MiniBatchKMeans)):
        # MiniBatchKMeans has KMeans' fitted surface and is never sketched
        runners = _kmeans_runners(est, resolve_device())
    elif isinstance(est, KernelKMeans):
        runners = _landmark_runners(est)
    elif isinstance(est, SpectralClustering):
        km = getattr(est, "assign_labels_", None)
        if isinstance(km, KMeans) and not callable(est.affinity):
            runners = _landmark_runners(est)
        else:  # a callable kernel or a foreign assigner: host path
            runners = _host_runners(est, _SERVABLE_METHODS)
    elif isinstance(est, PCA):
        runners = _pca_runners(est, resolve_device())
    elif isinstance(est, _GLM):
        runners = _glm_runners(est, resolve_device())
    else:
        runners = _host_runners(est, _SERVABLE_METHODS)
    if methods is not None:
        missing = [m for m in methods if m not in runners]
        if missing:
            raise ValueError(
                f"estimator {type(est).__name__} cannot serve "
                f"method(s) {missing}; available: {sorted(runners)}")
        runners = {m: runners[m] for m in methods}
    if not runners:
        raise ValueError(
            f"estimator {type(est).__name__} exposes none of "
            f"{_SERVABLE_METHODS}")
    return runners


def _n_features_of(est) -> Optional[int]:
    for attr, width in (
        # landmark models first: their cluster_centers_ live in the
        # l-dimensional feature space, not the input space
        ("_landmarks_", lambda a: a.shape[1]),
        ("cluster_centers_", lambda a: a.shape[1]),
        ("mean_", lambda a: a.shape[0]),
    ):
        a = getattr(est, attr, None)
        if a is not None:
            return int(width(np.asarray(a)))
    coef = getattr(est, "_coef", None)
    if coef is not None:
        return int(np.asarray(coef).shape[-1]
                   - (1 if getattr(est, "fit_intercept", False) else 0))
    nf = getattr(est, "n_features_in_", None)
    return int(nf) if nf is not None else None


@dataclasses.dataclass
class ServedModel:
    """A registered, fitted estimator: its runners by method, the request
    width it expects (``n_features``; ``None`` turns the width check off
    for a host model that declares none), and its registry version (0
    until installed). A dispatched batch holds its ServedModel, so a new
    version never disturbs work in flight."""

    name: str
    estimator: object
    runners: dict
    n_features: Optional[int]
    version: int = 0

    @property
    def methods(self) -> tuple:
        return tuple(sorted(self.runners))


class ModelRegistry:
    """Named, fitted estimators behind one or more serving loops.

    ``register`` builds the family runners (staging the fitted state on
    the device once); ``ensure`` is its idempotent form keyed on the
    estimator's identity, which ``ParallelPostFit`` uses. Every installed
    entry carries a registry-wide monotonic version. :meth:`publish`
    replaces whatever holds a name (the hot-swap seam), while batches
    already dispatched finish on the ServedModel they resolved;
    :meth:`build`, a warmup, then :meth:`install` splits it so the new
    version is warm before it takes traffic. ``invalidate`` then
    ``register`` is the refit path for the same estimator object."""

    def __init__(self):
        self._lock = threading.Lock()
        self._models: dict = {}
        self._by_id: dict = {}  # id(estimator) -> name (ensure()'s memo)
        self._next_version = 0

    def build(self, name: str, estimator, *, methods=None) -> ServedModel:
        """A ServedModel (family detection, runners over staged state),
        not installed: version 0 until :meth:`install`."""
        return ServedModel(name=str(name), estimator=estimator,
                           runners=_build_runners(estimator, methods),
                           n_features=_n_features_of(estimator))

    def install(self, model: ServedModel) -> ServedModel:
        """Publish ``model`` under its name with the next version,
        replacing any holder (use :meth:`register` where a replacement
        should be an error)."""
        with self._lock:
            self._next_version += 1
            model.version = self._next_version
            prior = self._models.get(model.name)
            if prior is not None and prior.estimator is not model.estimator:
                self._by_id.pop(id(prior.estimator), None)
            self._models[model.name] = model
            self._by_id[id(model.estimator)] = model.name
        return model

    def publish(self, name: str, estimator, *, methods=None) -> ServedModel:
        """Hot-swap: build and install in one call. Requests dispatched
        from now on take the new version; batches in flight finish on the
        old one."""
        return self.install(self.build(name, estimator, methods=methods))

    def register(self, name: str, estimator, *, methods=None) -> ServedModel:
        model = self.build(name, estimator, methods=methods)
        with self._lock:
            prior = self._models.get(model.name)
            if prior is not None and prior.estimator is not estimator:
                raise ValueError(
                    f"model name {model.name!r} is already registered to a "
                    "different estimator; unregister it first (or pick a "
                    "distinct name, or publish() to hot-swap)")
            self._next_version += 1
            model.version = self._next_version
            self._models[model.name] = model
            self._by_id[id(estimator)] = model.name
        return model

    def version(self, name: str) -> int:
        """The installed version serving ``name`` (KeyError if absent)."""
        return self.get(name).version

    def ensure(self, estimator, name: Optional[str] = None) -> str:
        """Register ``estimator`` unless this object already is; returns
        its name."""
        with self._lock:
            existing = self._by_id.get(id(estimator))
            if existing is not None and existing in self._models \
                    and self._models[existing].estimator is estimator:
                return existing
        if name is None:
            name = f"{type(estimator).__name__.lower()}-{id(estimator):x}"
        return self.register(name, estimator).name

    def get(self, name: str) -> ServedModel:
        with self._lock:
            model = self._models.get(str(name))
        if model is None:
            raise KeyError(f"no model registered under {name!r}")
        return model

    def names(self) -> list:
        with self._lock:
            return sorted(self._models)

    def unregister(self, name: str) -> None:
        with self._lock:
            model = self._models.pop(str(name), None)
            if model is not None:
                self._by_id.pop(id(model.estimator), None)

    def invalidate(self, estimator) -> None:
        """Drop every entry serving ``estimator`` (by identity): called
        when a refit changes the state its runners staged."""
        with self._lock:
            stale = [n for n, m in self._models.items()
                     if m.estimator is estimator]
            for n in stale:
                del self._models[n]
            self._by_id.pop(id(estimator), None)


# ---------------------------------------------------------------------------
# the serving loop
# ---------------------------------------------------------------------------


def _fail_future(fut: Future, exc: BaseException) -> bool:
    """Deliver ``exc`` to ``fut`` whatever its state: claims an unclaimed
    future first (a cancelled one is dropped), and tolerates one claimed
    or resolved by a racing path. True when this call delivered it."""
    if fut.done():
        return False
    try:
        if not fut.set_running_or_notify_cancel():
            return False  # the client cancelled it in the queue
    except RuntimeError:
        pass  # already claimed by the dispatch path
    try:
        fut.set_exception(exc)
        return True
    except Exception:
        return False  # resolved already: the race went the other way


@dataclasses.dataclass(eq=False)  # identity equality: the queue removes
class _Request:                   # this request, not equal contents
    model: str
    method: str
    X: np.ndarray
    n: int
    future: Future
    t_enqueue: float
    #: coalesce key: (model, method) for device runners; host runners
    #: split by input dtype too, so a foreign estimator sees each
    #: request's rows in the dtype the caller passed
    key: tuple = ()
    #: a higher priority wins among equal deadlines; ``deadline`` is the
    #: absolute perf_counter instant past which the request is shed
    #: (None: best effort, after every deadline)
    priority: int = 0
    deadline: Optional[float] = None
    #: admission sequence (first in, first out within one deadline and
    #: priority)
    seq: int = 0

    def edf_key(self) -> tuple:
        """Earliest deadline first, then higher priority, then arrival."""
        d = self.deadline if self.deadline is not None else float("inf")
        return (d, -self.priority, self.seq)


class ServingLoop:
    """A dispatch loop that coalesces concurrent requests into padded
    micro-batches on one device (the module docstring has the design).

    Parameters
    ----------
    registry : ModelRegistry, optional
        Shared registry; a private one by default.
    policy : PadPolicy
        Bucket policy (default :data:`DEFAULT_SERVING_POLICY`).
    max_batch_rows : int
        Row budget of a micro-batch and the largest request
        (:attr:`max_request_rows`).
    max_queue : int
        Queue capacity in requests; ``submit`` past it raises
        :class:`ServingQueueFull`.
    coalesce_window_s : float or "adaptive"
        Extra time the dispatcher may wait, after picking a batch's first
        request, for the batch to fill. ``"adaptive"`` (the default):
        the predicted time for the batch to fill its current pad bucket
        at the submit-side rows/s rate, clamped to
        ``coalesce_window_max_s`` and to the batch's tightest deadline
        (less a compute margin), zero when arrivals went idle. A float is
        a fixed window (0 never waits).
    coalesce_window_max_s : float
        Ceiling of the adaptive window (default 10 ms).
    device : torch.device or str, optional
        Where the batches run; default the configured device, resolved by
        :meth:`start` in the calling thread.
    mesh : Mesh, optional
        A :class:`~dask_ml_tpu_torch.parallel.mesh.Mesh` of ranks: every
        rank of it starts the loop and runs its row block of each batch
        (module docstring). Without a world, a mesh of one rank is one
        device.
    drain, retry_policy, fault_injector
        A :class:`~dask_ml_tpu_torch.parallel.faults.GracefulDrain`; a
        :class:`~dask_ml_tpu_torch.parallel.faults.RetryPolicy` for
        transient copy failures; a
        :class:`~dask_ml_tpu_torch.parallel.faults.FaultInjector` whose
        ``on_transfer`` hook the batch staging calls.
    """

    def __init__(self, registry: Optional[ModelRegistry] = None, *,
                 policy: Optional[PadPolicy] = None,
                 max_batch_rows: int = 2048,
                 max_queue: int = 4096,
                 coalesce_window_s="adaptive",
                 coalesce_window_max_s: float = 0.010,
                 device=None,
                 mesh=None,
                 drain=None,
                 retry_policy=None,
                 fault_injector=None,
                 name: str = "serving",
                 _group=None,
                 _leader: Optional[int] = None):
        self.registry = registry if registry is not None else ModelRegistry()
        self.policy = policy if policy is not None else DEFAULT_SERVING_POLICY
        self.max_batch_rows = int(max_batch_rows)
        self.max_queue = int(max_queue)
        if isinstance(coalesce_window_s, str):
            if coalesce_window_s != "adaptive":
                raise ValueError(
                    f"coalesce_window_s must be a float or 'adaptive', "
                    f"got {coalesce_window_s!r}")
            self.coalesce_window_s = "adaptive"
        else:
            self.coalesce_window_s = float(coalesce_window_s)
        self.coalesce_window_max_s = float(coalesce_window_max_s)
        self.name = str(name)
        self._device_arg = device
        self._mesh = mesh
        # a ServingFleet over meshes names its router's rank and the group
        self._leader_arg = _leader
        self._group = _group
        #: over a mesh: the model versions the leader has sent, and a
        #: follower's ServedModels (or build errors) by version
        self._sent: set = set()
        self._mirror: dict = {}
        #: "leader", "follower" (a rank of the mesh that runs blocks),
        #: "idle" (a world rank outside the loop's group), or None: one
        #: device, no collective
        self.role = None
        self._follower: Optional[threading.Thread] = None
        self._drain = drain
        self._retry_policy = retry_policy
        self._fault_injector = fault_injector

        self._cond = threading.Condition()
        self._queue: deque = deque()
        self._closed = False
        self._stopped = True
        self._stopped_requested = False
        self._thread: Optional[threading.Thread] = None
        self._config: dict = {}
        self._telemetry_inherit = False
        self._device: Optional[torch.device] = None
        self._stream = None
        self._wire = None
        #: the bucket alignment: one device holds a whole batch
        self._align = 1
        self._batch_seq = 0
        self._submit_seq = 0
        self._last_beat = time.monotonic()
        #: the exception that killed the dispatch thread (None: clean);
        #: submit() raises with it, the fleet's monitor reads it
        self.fatal: Optional[BaseException] = None
        #: EWMA of the reported batch latency in seconds (what
        #: serving.batch_seconds observes, an injected slow-replica
        #: penalty included); the fleet router balances on it
        self._latency_ewma = 0.0
        # the adaptive window's state, written under _cond at submit and
        # read without it at dispatch (floats): inter-arrival gap EWMA,
        # rows-per-request EWMA, last arrival
        self._ia_ewma = 0.0
        self._arrival_rows_ewma = 0.0
        self._last_arrival: Optional[float] = None
        #: the window chosen for the last batch (serving.window_s)
        self.last_window_s = 0.0
        #: True while the dispatch thread runs a batch: load the queue no
        #: longer shows, which the fleet router counts
        self.busy = False
        # operational counts (stats(); observability is the telemetry
        # registry)
        self.n_submitted = 0
        self.n_completed = 0
        self.n_errors = 0
        self.n_batches = 0
        self.rows_served = 0
        self.n_shed = 0

    # -- lifecycle ---------------------------------------------------------

    @property
    def max_request_rows(self) -> int:
        """The largest request ``submit`` accepts (``ParallelPostFit``
        chunks above it)."""
        return self.max_batch_rows

    @property
    def device(self) -> Optional[torch.device]:
        """The device the batches run on (set by :meth:`start`)."""
        return self._device

    def start(self) -> "ServingLoop":
        """Resolve the device, the wire dtype and the configuration in the
        calling thread (so its scoped configuration holds), then start the
        dispatch thread."""
        from dask_ml_tpu_torch.config import resolve_device, thread_config
        from dask_ml_tpu_torch.parallel import precision as precision_lib
        from dask_ml_tpu_torch.parallel import telemetry

        if self._thread is not None and self._thread.is_alive():
            return self
        if self._follower is not None and self._follower.is_alive():
            return self
        dev = resolve_device(self._device_arg)
        if self._mesh is not None:
            dev = self._join_mesh(dev)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self._device = dev
        if dev.type == "cuda" and self._stream is None:
            self._stream = torch.cuda.Stream(dev)
        self._wire = precision_lib.staging_wire_dtype()
        cfg = thread_config()
        self._telemetry_inherit = telemetry.enabled()
        # the dispatch thread runs under the caller's configuration, but
        # with the telemetry knob off it installs no override of it: the
        # thread then follows the process-wide knob, so
        # set_config(telemetry=True) on a running loop takes effect
        cfg.pop("telemetry", None)
        if self._telemetry_inherit:
            cfg["telemetry"] = True
        self._config = cfg
        self._closed = False
        self._stopped = False
        self._stopped_requested = False
        self.fatal = None
        self._last_beat = time.monotonic()
        self._sent, self._mirror = set(), {}
        if self.role == "idle":
            return self
        if self.role == "follower":
            self._follower = threading.Thread(
                target=self._follow, name=f"{self.name}-follow",
                daemon=True)
            self._follower.start()
            return self
        self._thread = threading.Thread(
            target=self._run, name=f"{self.name}-dispatch", daemon=True)
        self._thread.start()
        return self

    def _join_mesh(self, dev: torch.device) -> torch.device:
        """Take this rank's role on the loop's mesh and make (or take) the
        loop's process group; returns the device the rank serves on."""
        from dask_ml_tpu_torch.config import resolve_device
        from dask_ml_tpu_torch.parallel import mesh as mesh_lib

        m = self._mesh
        if not isinstance(m, mesh_lib.Mesh):
            raise TypeError(
                "ServingLoop mesh must be a dask_ml_tpu_torch.parallel.mesh."
                f"Mesh, got {type(m).__name__}")
        import torch.distributed as dist

        if not (dist.is_available() and dist.is_initialized()):
            if m.size != 1:
                raise ServingError(
                    f"ServingLoop over the {m.shape} mesh needs its ranks' "
                    "world: runtime.initialize on every rank, then build the "
                    "mesh")
            self.role = None  # one device, no collective
            return dev

        ranks = sorted(int(r) for r in m.devices.reshape(-1))
        self._leader = (ranks[0] if self._leader_arg is None
                        else int(self._leader_arg))
        self._members = sorted(set(ranks) | {self._leader})
        if self._group is None:
            self._group = dist.new_group(self._members,
                                         timeout=_FOLLOW_TIMEOUT)
        me = dist.get_rank()
        self.role = ("leader" if me == self._leader else
                     "follower" if me in ranks else "idle")
        self._align = mesh_lib.n_data_shards(m)
        # each rank's data shard, from its coordinates on the grid
        self._shard_of = {}
        axes = mesh_lib.data_axes(m)
        for coords in np.ndindex(*m.devices.shape):
            at = dict(zip(m.axis_names, coords))
            i = 0
            for a in axes:
                i = i * m.shape[a] + at[a]
            self._shard_of[int(m.devices[coords])] = i
        return resolve_device(m.device) if m.device is not None else dev

    def __enter__(self) -> "ServingLoop":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    def stop(self, drain: bool = True, timeout: Optional[float] = 30.0):
        """Stop the loop. ``drain=True`` (default) stops accepting, lets
        the dispatch thread flush every queued batch and resolves every
        future before returning; ``drain=False`` fails the queued requests
        with :class:`ServingStopped` at once. Over a mesh the leader's
        stop ends the followers; a follower's ``stop()`` waits (up to
        ``timeout``) for the leader's."""
        if self.role in ("follower", "idle"):
            f = self._follower
            if f is not None and f.is_alive():
                f.join(timeout)
            self._closed = True
            self._stopped = f is None or not f.is_alive()
            return
        dropped: list = []
        with self._cond:
            self._closed = True
            if not drain:
                dropped = list(self._queue)
                self._queue = deque()
            self._stopped_requested = True
            self._cond.notify_all()
        for r in dropped:
            _fail_future(r.future, ServingStopped(
                "serving loop stopped without drain"))
        t = self._thread
        if t is not None and t.is_alive() \
                and t is not threading.current_thread():
            t.join(timeout)
        self._stopped = True

    @property
    def closed(self) -> bool:
        return self._closed

    @property
    def stopped(self) -> bool:
        return self._stopped

    def queue_depth(self) -> int:
        """The queued request count (the ``serving.queue_depth`` gauge's
        value), read by the fleet router with telemetry on or off."""
        with self._cond:
            return len(self._queue)

    def latency_s(self) -> float:
        """EWMA of the reported batch latency in seconds."""
        return self._latency_ewma

    def heartbeat_age(self) -> float:
        """Seconds since the dispatch thread last showed it was alive. It
        beats at every collect, never inside a runner, so a batch longer
        than the fleet's heartbeat timeout reads as a stall: the fleet
        replays (duplicate compute only) and revives the replica when the
        beat returns."""
        return time.monotonic() - self._last_beat

    def alive(self) -> bool:
        """True while the dispatch thread runs (started, not stopped, not
        crashed)."""
        t = self._thread
        return (t is not None and t.is_alive() and not self._stopped
                and self.fatal is None)

    def _stream_ctx(self):
        if self._stream is None:
            return contextlib.nullcontext()
        return torch.cuda.stream(self._stream)

    def warmup(self, buckets=None, models=None) -> dict:
        """Run every (model, method, bucket) once through the serving
        path on a zero batch, on this loop's stream: every kernel library
        a runner launches is built and loaded here. Returns
        ``{"n_programs", "n_compiles", "compile_seconds", "n_loads",
        "load_seconds"}`` (``nvcc`` builds and library loads, see
        :func:`~dask_ml_tpu_torch.parallel.shapes.compile_stats`); after a
        warmup that covers the traffic's buckets, steady traffic builds
        and loads nothing."""
        from dask_ml_tpu_torch.parallel.shapes import track_compiles

        if self._device is None:
            raise ServingError("start() the loop before warmup()")
        sizes = list(buckets) if buckets is not None else serving_buckets(
            self.policy, self.max_batch_rows, align=self._align)
        names = list(models) if models is not None else self.registry.names()
        n_programs = 0
        with track_compiles() as t:
            for name in names:
                n_programs += self.warmup_model(self.registry.get(name),
                                                buckets=sizes)
        return {"n_programs": n_programs,
                "n_compiles": t["n_compiles"],
                "compile_seconds": round(t["compile_seconds"], 3),
                "n_loads": t["n_loads"],
                "load_seconds": round(t["load_seconds"], 3)}

    def warmup_model(self, model: ServedModel, buckets=None) -> int:
        """Warm one ServedModel's device runners through the serving
        staging path; works on a model not yet installed
        (:meth:`ModelRegistry.build`), which is how a hot-swap warms the
        incoming version. Returns the runs made."""
        from dask_ml_tpu_torch.config import config_context

        if self._device is None:
            raise ServingError("start() the loop before warmup")
        sizes = list(buckets) if buckets is not None else serving_buckets(
            self.policy, self.max_batch_rows, align=self._align)
        d = model.n_features
        if d is None:
            return 0
        n_programs = 0
        with config_context(**self._config), self._stream_ctx():
            for runner in model.runners.values():
                if runner.kind != "device":
                    continue
                for b in sizes:
                    buf = self._buffer(int(b), d)
                    buf.zero_()
                    runner.run(self._stage(buf))
                    n_programs += 1
        return n_programs

    # -- client side -------------------------------------------------------

    def submit(self, model: str, X, method: str = "predict", *,
               priority: int = 0,
               deadline: Optional[float] = None) -> Future:
        """Queue one request; returns a Future of the method's host numpy
        result for exactly these rows.

        Over a mesh only the leader rank accepts requests.

        Validation runs here, on the host, so a malformed request fails
        its caller and never a batch it would have shared. Device families
        get ``check_array``'s checks (a float32 cast, finiteness); a host
        model gets the rows exactly as given (dtype kept, NaN passed),
        as a direct call would.

        ``deadline`` is the request's budget in seconds from now: the
        dispatcher takes the earliest deadline first (``priority`` breaks
        ties and orders the requests without a deadline), and a request
        whose deadline passes before dispatch is shed with
        :class:`DeadlineExceeded` — at once when the budget is already
        non-positive."""
        from dask_ml_tpu_torch.parallel import telemetry

        if self.role in ("follower", "idle"):
            raise ServingError(
                f"serving loop {self.name!r} is a {self.role} rank of its "
                f"mesh: submit on the leader, rank {self._leader}")
        model = str(model)
        entry = self.registry.get(model)  # KeyError for unknown names
        runner = entry.runners.get(method)
        if runner is None:
            raise ValueError(
                f"model {model!r} does not serve {method!r}; "
                f"available: {list(entry.methods)}")
        arr = np.asarray(X)
        if arr.ndim != 2:
            raise ValueError(
                f"Expected 2D array, got {arr.ndim}D array of shape "
                f"{arr.shape}")
        if arr.shape[0] < 1:
            raise ValueError("request has no rows")
        if arr.shape[0] > self.max_request_rows:
            raise ValueError(
                f"request has {arr.shape[0]} rows, above the per-request "
                f"cap {self.max_request_rows}; split it (ParallelPostFit's "
                "serving mode chunks automatically)")
        if entry.n_features is not None and arr.shape[1] != entry.n_features:
            raise ValueError(
                f"model {model!r} expects {entry.n_features} features, "
                f"request has {arr.shape[1]}")
        if runner.kind == "device":
            if np.dtype(arr.dtype).kind not in "fiub":
                raise ValueError(f"Unsupported dtype {arr.dtype}")
            if arr.dtype != np.float32:
                arr = arr.astype(np.float32)
            if not bool(np.isfinite(arr).all()):
                raise ValueError("Input contains NaN or infinity")
            key = (model, str(method))
        else:
            key = (model, str(method), str(arr.dtype))

        now = time.perf_counter()
        if deadline is not None and float(deadline) <= 0.0:
            self._count_shed(model)
            raise DeadlineExceeded(
                f"request deadline {float(deadline):.3f}s is already past "
                "at admission")
        fut: Future = Future()
        req = _Request(model=model, method=str(method), X=arr,
                       n=int(arr.shape[0]), future=fut,
                       t_enqueue=now, key=key, priority=int(priority),
                       deadline=(None if deadline is None
                                 else now + float(deadline)))
        with self._cond:
            if self._drain is not None and self._drain.requested:
                # SIGTERM landed: stop accepting now (the dispatch thread
                # flushes what is queued)
                self._closed = True
                self._cond.notify_all()
            if self._stopped or self.fatal is not None:
                raise ServingStopped(
                    f"serving loop {self.name!r} has stopped"
                    + (f" ({self.fatal!r})" if self.fatal is not None
                       else ""))
            if self._closed:
                raise ServingStopped(
                    f"serving loop {self.name!r} is draining and not "
                    "accepting requests")
            if len(self._queue) >= self.max_queue:
                raise ServingQueueFull(
                    f"serving queue at capacity ({self.max_queue})")
            req.seq = self._submit_seq
            self._submit_seq += 1
            self._queue.append(req)
            depth = len(self._queue)
            self.n_submitted += 1
            # arrival rate, for the adaptive coalesce window
            if self._last_arrival is not None:
                gap = max(now - self._last_arrival, 1e-06)
                self._ia_ewma = (gap if self._ia_ewma == 0.0
                                 else 0.8 * self._ia_ewma + 0.2 * gap)
            self._arrival_rows_ewma = (
                float(req.n) if self._arrival_rows_ewma == 0.0
                else 0.8 * self._arrival_rows_ewma + 0.2 * req.n)
            self._last_arrival = now
            self._cond.notify()
        if telemetry.enabled():
            telemetry.metrics().gauge("serving.queue_depth").set(depth)
        return fut

    def _count_shed(self, model: str, n: int = 1) -> None:
        from dask_ml_tpu_torch.parallel import telemetry

        self.n_shed += n
        if telemetry.enabled():
            telemetry.metrics().counter("serving.shed", model=model).inc(n)

    def call(self, model: str, X, method: str = "predict",
             timeout: Optional[float] = None) -> np.ndarray:
        """``submit`` and wait, inside a ``serving.request`` span."""
        from dask_ml_tpu_torch.parallel import telemetry

        with telemetry.span("serving.request", model=str(model),
                            method=str(method)):
            return self.submit(model, X, method=method).result(timeout)

    def stats(self) -> dict:
        """Operational snapshot (observability is ``telemetry_report()``)."""
        with self._cond:
            depth = len(self._queue)
        return {
            "models": self.registry.names(),
            "queue_depth": depth,
            "submitted": self.n_submitted,
            "completed": self.n_completed,
            "errors": self.n_errors,
            "batches": self.n_batches,
            "rows_served": self.rows_served,
            "shed": self.n_shed,
            "latency_ewma_s": round(self._latency_ewma, 6),
            "closed": self._closed,
        }

    # -- dispatch side -----------------------------------------------------

    def _buffer(self, rows: int, d: int) -> torch.Tensor:
        """An uninitialized host batch of ``rows`` × ``d`` in the wire
        dtype (float32 unless the precision policy narrows it), page-locked
        when the loop runs on a card so its copy is one asynchronous
        DMA."""
        return torch.empty((rows, d), dtype=self._wire or torch.float32,
                           pin_memory=self._stream is not None)

    def _stage(self, buf: torch.Tensor) -> torch.Tensor:
        """The one copy of the padded host batch to the device, on the
        current stream (the loop's). The fault injector's hook and the
        retry policy wrap exactly this copy."""
        seq = self._batch_seq

        def put():
            if self._fault_injector is not None:
                self._fault_injector.on_transfer(seq)
            return buf.to(self._device, non_blocking=buf.is_pinned())

        if self._retry_policy is not None:
            return self._retry_policy.run(
                put, kind="serving-transfer", detail=f"batch {seq}")
        return put()

    def _shed_expired_locked(self) -> list:
        """Under the lock: take out every queued request whose deadline
        has passed. The caller fails them outside the lock (future
        callbacks, the fleet router's among them, never run under it)."""
        now = time.perf_counter()
        if not any(r.deadline is not None and r.deadline < now
                   for r in self._queue):
            return []
        live: deque = deque()
        shed = []
        for r in self._queue:
            if r.deadline is not None and r.deadline < now:
                shed.append(r)
            else:
                live.append(r)
        self._queue = live
        return shed

    def _resolve_shed(self, shed: list) -> None:
        for r in shed:
            late = time.perf_counter() - r.deadline
            if _fail_future(r.future, DeadlineExceeded(
                    f"request for {r.model!r}.{r.method} shed: deadline "
                    f"passed {late * 1e3:.1f} ms before dispatch")):
                self._count_shed(r.model)

    def _pull_mates_locked(self, key, batch, rows) -> int:
        """Under the lock: move the queued requests sharing ``key`` into
        ``batch``, earliest deadline first, while the row budget holds (one
        sort and one rebuild of the queue)."""
        mates = [r for r in self._queue if r.key == key]
        if not mates:
            return rows
        mates.sort(key=_Request.edf_key)
        taken = set()
        for r in mates:
            if rows + r.n <= self.max_batch_rows:
                taken.add(id(r))
                batch.append(r)
                rows += r.n
        if taken:
            self._queue = deque(r for r in self._queue
                                if id(r) not in taken)
        return rows

    def _collect(self) -> list:
        """Wait for work, shed the expired requests, then take the
        earliest-deadline request and every queued request sharing its
        (model, method) key, up to the row budget. Returns [] when told
        to exit."""
        shed: list = []
        try:
            with self._cond:
                while True:
                    self._last_beat = time.monotonic()
                    shed.extend(self._shed_expired_locked())
                    if self._queue:
                        break
                    if self._closed or self._stopped \
                            or self._stopped_requested:
                        return []
                    if self._drain is not None and self._drain.requested:
                        self._closed = True
                        return []
                    self._cond.wait(timeout=0.05)
                first = min(self._queue, key=_Request.edf_key)
                self._queue.remove(first)
                batch = [first]
                rows = self._pull_mates_locked(first.key, batch, first.n)
        finally:
            self._resolve_shed(shed)
        if self.coalesce_window_s == "adaptive":
            now = time.perf_counter()
            window = self._adaptive_window(batch, rows, now)
            deadline = now + window
        else:
            window = self.coalesce_window_s
            deadline = first.t_enqueue + window
        self.last_window_s = window
        if window > 0:
            while time.perf_counter() < deadline \
                    and rows < self.max_batch_rows:
                with self._cond:
                    if not self._queue:
                        remaining = deadline - time.perf_counter()
                        if remaining > 0:
                            self._cond.wait(timeout=remaining)
                    before = len(batch)
                    rows = self._pull_mates_locked(first.key, batch, rows)
                    pulled = len(batch) > before
                    if self._closed or self._stopped:
                        break
                if not pulled and time.perf_counter() >= deadline:
                    break
        return batch

    #: arrivals older than max(this, 10 inter-arrival EWMAs) read as an
    #: idle trace: the adaptive window is zero
    IDLE_AFTER_S = 0.005

    def _adaptive_window(self, batch: list, rows: int,
                         now: float) -> float:
        """The window for one batch: the predicted time for ``rows`` to
        grow into their current pad bucket (rows the padded batch
        computes anyway) at the submit-side rows/s EWMA. Zero when idle,
        when the batch is full or at a bucket boundary, or when waiting
        buys nothing within ``coalesce_window_max_s``; else clamped to
        that budget and to the tightest deadline's slack less a compute
        margin."""
        ia = self._ia_ewma
        if ia <= 0.0 or rows >= self.max_batch_rows:
            return 0.0
        last = self._last_arrival
        if last is None \
                or now - last > max(10.0 * ia, self.IDLE_AFTER_S):
            return 0.0  # idle trace: dispatch now
        bucket = min(self.policy.bucket(rows, align=self._align),
                     self.max_batch_rows)
        if rows >= bucket:
            return 0.0  # at a boundary: one more row takes the next bucket
        rate = self._arrival_rows_ewma / ia  # rows per second
        if rate <= 0.0:
            return 0.0
        window = (bucket - rows) / rate
        if window > self.coalesce_window_max_s:
            # the bucket cannot fill within the budget: wait the budget
            # only if it still buys one more arrival
            if ia > self.coalesce_window_max_s:
                return 0.0
            window = self.coalesce_window_max_s
        slack = min((r.deadline - now for r in batch
                     if r.deadline is not None), default=None)
        if slack is not None:
            # leave room to compute the batch before the tightest deadline
            window = min(window, slack - 1.5 * self._latency_ewma)
        return max(window, 0.0)

    def _execute(self, batch: list) -> None:
        from dask_ml_tpu_torch.parallel import telemetry

        # claim every future first: one its caller cancelled in the queue
        # is dropped here, and a claimed one can no longer be cancelled,
        # so the resolutions below cannot race a cancel into an error
        # that would kill the dispatch thread
        batch = [r for r in batch
                 if r.future.set_running_or_notify_cancel()]
        if not batch:
            return
        model_name, method = batch[0].model, batch[0].method
        rows = sum(r.n for r in batch)
        tel = telemetry.enabled()
        t0 = time.perf_counter()
        self._batch_seq += 1
        try:
            model = self.registry.get(model_name)
            runner = model.runners[method]
            with telemetry.span("serving.batch", model=model_name,
                                method=method, n_requests=len(batch),
                                rows=rows) as sp:
                if runner.kind == "host":
                    hb = (batch[0].X if len(batch) == 1 else
                          np.concatenate([r.X for r in batch], axis=0))
                    out = np.asarray(runner.run(hb))
                    bucket = rows
                else:
                    bucket = self.policy.bucket(rows, align=self._align)
                    buf = self._buffer(bucket, model.n_features)
                    if buf.dtype == torch.float32:
                        host = buf.numpy()
                        off = 0
                        for r in batch:
                            host[off:off + r.n] = r.X
                            off += r.n
                        host[off:] = 0.0
                    else:  # a narrower wire dtype numpy has no name for
                        off = 0
                        for r in batch:
                            buf[off:off + r.n].copy_(torch.from_numpy(r.X))
                            off += r.n
                        buf[off:].zero_()
                    if self.role == "leader":
                        out = self._run_over_mesh(model, method,
                                                  self._stage(buf))
                    else:
                        out = np.asarray(runner.run(self._stage(buf)))
                sp.set(bucket=bucket)
        except Exception as e:  # noqa: BLE001 — delivered per request
            self.n_errors += len(batch)
            for r in batch:
                r.future.set_exception(e)
            if tel:
                telemetry.metrics().counter(
                    "serving.errors", model=model_name).inc(len(batch))
            return
        dt = time.perf_counter() - t0
        # the synthetic straggler penalty (FaultInjector.slow_replica):
        # added to every latency this replica reports, without sleeping
        penalty = (self._fault_injector.dispatch_penalty(self.name)
                   if self._fault_injector is not None else 0.0)
        dt += penalty
        now = time.perf_counter()
        off = 0
        for r in batch:
            r.future.set_result(out[off:off + r.n].copy())
            off += r.n
        self.n_completed += len(batch)
        self.n_batches += 1
        self.rows_served += rows
        self._latency_ewma = (dt if self._latency_ewma == 0.0
                              else 0.7 * self._latency_ewma + 0.3 * dt)
        if tel:
            reg = telemetry.metrics()
            reg.counter("serving.batches", model=model_name).inc()
            reg.counter("serving.requests", model=model_name).inc(len(batch))
            reg.counter("serving.rows", model=model_name).inc(rows)
            reg.gauge("serving.batch_occupancy").set(rows / max(bucket, 1))
            reg.gauge("serving.window_s").set(self.last_window_s)
            reg.histogram("serving.occupancy").observe(
                rows / max(bucket, 1))
            reg.histogram("serving.batch_rows").observe(rows)
            reg.histogram("serving.batch_seconds").observe(dt)
            lat = reg.histogram("serving.request_seconds", model=model_name)
            for r in batch:
                lat.observe(now - r.t_enqueue + penalty)

    def _run(self) -> None:
        from dask_ml_tpu_torch.config import config_context
        from dask_ml_tpu_torch.parallel import telemetry
        from dask_ml_tpu_torch.parallel.faults import SimulatedReplicaDeath

        pending: list = []
        try:
            with config_context(**self._config), self._stream_ctx():
                while True:
                    batch = self._collect()
                    if not batch:
                        with self._cond:
                            drain_hit = (self._drain is not None
                                         and self._drain.requested)
                            if drain_hit:
                                self._closed = True
                            if (self._closed or self._stopped_requested) \
                                    and not self._queue:
                                self._stopped = True
                                self._cond.notify_all()
                                return
                        continue
                    pending = batch
                    fi = self._fault_injector
                    if fi is not None:
                        if fi.should_kill_replica(self.name,
                                                  self.n_batches):
                            raise SimulatedReplicaDeath(
                                f"replica {self.name!r} killed by fault "
                                f"plan after {self.n_batches} batches")
                        fi.on_dispatch(self._batch_seq)
                        # the real straggler plan: stalls this dispatch
                        straggle = getattr(fi, "dispatch_sleep", None)
                        if straggle is not None:
                            straggle(self.name)
                    if telemetry.enabled():
                        with self._cond:
                            depth = len(self._queue)
                        telemetry.metrics().gauge(
                            "serving.queue_depth").set(depth)
                    self.busy = True
                    try:
                        self._execute(batch)
                    finally:
                        self.busy = False
                    pending = []
        except BaseException as e:  # noqa: BLE001 — record, then fail fast
            self.fatal = e
        finally:
            self._finalize(pending)
            if self.role == "leader":
                self._broadcast_header(_HDR_STOP, 0, 0, 0, 0)

    # -- over a mesh: the leader's side of a batch, and the followers -----

    def _broadcast_header(self, kind: int, model: int, method: int,
                          rows: int, d: int) -> list:
        import torch.distributed as dist

        hdr = torch.tensor([kind, model, method, rows, d],
                           dtype=torch.int64, device=self._device)
        dist.broadcast(hdr, src=self._leader, group=self._group)
        return hdr.tolist()

    def _block(self, model, method: str, batch: torch.Tensor):
        """This rank's share of a batch: the runner's host output on its
        data shard's rows, None off the mesh (a leader that only routes),
        or a :class:`_BlockFailed` when the model could not be built here
        or its runner raised."""
        from dask_ml_tpu_torch.parallel import mesh as mesh_lib

        import torch.distributed as dist

        me = dist.get_rank()
        shard = self._shard_of.get(me)
        if shard is None:
            return None
        try:
            if isinstance(model, BaseException):
                raise model
            rows = mesh_lib.ShardLayout((), shard, self._align).rows(
                int(batch.shape[0]))
            return np.asarray(model.runners[method].run(batch[rows]))
        except Exception as e:  # noqa: BLE001 — gathered, the batch fails
            return _BlockFailed(me, f"{type(e).__name__}: {e}")

    def _gather_blocks(self, mine) -> np.ndarray:
        """Every rank's block (``all_gather`` over the loop's group, in
        rank order) stitched in data-shard order; a model axis's ranks
        of one shard hold the same rows, the first is taken. Raises
        :class:`ServingError` when a rank's block failed."""
        import torch.distributed as dist

        outs = [None] * len(self._members)
        dist.all_gather_object(outs, mine, group=self._group)
        failed = [o for o in outs if isinstance(o, _BlockFailed)]
        if failed:
            raise ServingError("; ".join(
                f"rank {f.rank}: {f.error}" for f in failed))
        blocks = {}
        for r, out in zip(self._members, outs):
            shard = self._shard_of.get(r)
            if shard is not None and shard not in blocks:
                blocks[shard] = out
        return np.concatenate([blocks[i] for i in range(self._align)])

    def _send_model(self, model: ServedModel) -> None:
        """The leader hands a model version to the followers: a header,
        then the estimator, pickled from the host, as bytes."""
        import torch.distributed as dist

        from dask_ml_tpu_torch.model_selection._incremental import (
            _host_pickle)

        body = _host_pickle((model.name, model.estimator, model.methods))
        self._broadcast_header(_HDR_MODEL, model.version, 0, len(body), 0)
        wire = torch.frombuffer(bytearray(body), dtype=torch.uint8)
        dist.broadcast(wire.to(self._device), src=self._leader,
                       group=self._group)
        self._sent.add(model.version)

    def _take_model(self, version: int, n_bytes: int) -> None:
        """A follower's side of :meth:`_send_model`: the ServedModel built
        from the leader's bytes (or the error building it) under its
        version, in place of the older versions of its name."""
        import pickle

        import torch.distributed as dist

        wire = torch.empty(n_bytes, dtype=torch.uint8, device=self._device)
        dist.broadcast(wire, src=self._leader, group=self._group)
        try:
            name, est, methods = pickle.loads(wire.cpu().numpy().tobytes())
            model = self.registry.build(name, est, methods=methods)
            model.version = version
            self._mirror = {v: m for v, m in self._mirror.items()
                            if getattr(m, "name", None) != name}
        except Exception as e:  # noqa: BLE001 — every block of it fails
            model = e
        self._mirror[version] = model

    def _run_over_mesh(self, model: ServedModel, method: str,
                       batch: torch.Tensor) -> np.ndarray:
        """The leader's batch: the model version if the followers lack it,
        the header, then the padded batch, over the loop's group; its own
        block; every block gathered."""
        import torch.distributed as dist

        if model.version not in self._sent:
            self._send_model(model)
        self._broadcast_header(_HDR_RUN, model.version,
                               _SERVABLE_METHODS.index(method),
                               int(batch.shape[0]), int(batch.shape[1]))
        batch = batch.contiguous()
        dist.broadcast(batch, src=self._leader, group=self._group)
        return self._gather_blocks(self._block(model, method, batch))

    def _follow(self) -> None:
        """A follower's thread: take each model version and each batch the
        leader broadcasts, run this rank's block, hand it back, until the
        leader's stop."""
        import torch.distributed as dist

        from dask_ml_tpu_torch.config import config_context

        try:
            with config_context(**self._config), self._stream_ctx():
                while True:
                    self._last_beat = time.monotonic()
                    kind, version, method, rows, d = self._broadcast_header(
                        0, 0, 0, 0, 0)
                    if kind == _HDR_MODEL:
                        self._take_model(version, rows)
                        continue
                    if kind != _HDR_RUN:
                        break
                    batch = torch.empty((rows, d),
                                        dtype=self._wire or torch.float32,
                                        device=self._device)
                    dist.broadcast(batch, src=self._leader,
                                   group=self._group)
                    model = self._mirror.get(version) or KeyError(
                        f"model version {version} was never sent")
                    mine = self._block(model, _SERVABLE_METHODS[method],
                                       batch)
                    with contextlib.suppress(ServingError):
                        self._gather_blocks(mine)
                    self.n_batches += 1
                    if isinstance(mine, np.ndarray):
                        self.rows_served += len(mine)
        except BaseException as e:  # noqa: BLE001 — recorded for stats
            self.fatal = e
        finally:
            self._closed = True
            self._stopped = True

    def _finalize(self, pending: list) -> None:
        """The dispatch thread's exit, clean or not: close the loop and
        fail every request it can no longer serve (the collected batch it
        never ran and the whole queue) with the fatal error or
        :class:`ServingStopped`."""
        with self._cond:
            self._closed = True
            self._stopped = True
            leftovers = list(pending) + list(self._queue)
            self._queue = deque()
            self._cond.notify_all()
        if not leftovers and self.fatal is None:
            return
        exc = self.fatal if self.fatal is not None else ServingStopped(
            f"serving loop {self.name!r} stopped before this request "
            "could dispatch")
        for r in leftovers:
            _fail_future(r.future, exc)
        if self.fatal is not None:
            logging.getLogger(__name__).warning(
                "serving loop %r dispatch thread died: %r (%d request(s) "
                "failed over)", self.name, self.fatal, len(leftovers))

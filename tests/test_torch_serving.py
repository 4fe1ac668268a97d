"""The PyTorch port's serving loop (``parallel/serving.py``) on the CPU:
held against the JAX package where both compute the same thing, and one
test of the port for each scenario of ``tests/test_serving.py``.

Parity with the JAX package (models fitted there, carried across with
``convert.py``, both loops fed the same requests):

- the K2 families (KMeans, MiniBatchKMeans, the sketched KMeans, the
  landmark models): served labels equal, on integer-valued rows for the
  k-means family (every distance exact) and on the blobs the spectral
  parity tests use for the landmark models;
- GLM ``predict_proba`` and PCA ``transform``: rtol 1e-5 (f32 products in
  another order: MKL here, XLA there);
- ``PadPolicy.bucket``, ``serving_buckets``, the adaptive coalesce window
  and the admission order (earliest deadline first, with the dispatch
  thread held): equal.

Served against direct in the port: the K2 families bit for bit at every
ragged size; the GLM and PCA runners are plain products, and MKL picks
its GEMV / GEMM kernel by the row count (the last row of an odd row count
takes its tail kernel), so a served row may differ from the direct call's
in the last bits: rtol 1e-5 with atol 1e-6, and labels equal wherever the
margin exceeds 1e-5 (measured: at most 2.4e-7 absolute on the linear
model's predictions).

Every wait is bounded; a held dispatch thread orders events, never a
sleep.
"""

import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest
import scipy.sparse as sp
import torch

from dask_ml_tpu import cluster as jcluster
from dask_ml_tpu import decomposition as jdec
from dask_ml_tpu import linear_model as jlm
from dask_ml_tpu.interop import export_learned_attrs
from dask_ml_tpu.parallel import serving as jserving
from dask_ml_tpu.parallel import shapes as jshapes
from dask_ml_tpu_torch import config, config_context
from dask_ml_tpu_torch.cluster import (KernelKMeans, KMeans, MiniBatchKMeans,
                                       SpectralClustering)
from dask_ml_tpu_torch.convert import (glm_from_numpy, kernel_kmeans_from_numpy,
                                       kmeans_from_numpy, pca_from_numpy,
                                       spectral_from_numpy)
from dask_ml_tpu_torch.decomposition import PCA
from dask_ml_tpu_torch.linear_model import (LinearRegression,
                                            LogisticRegression,
                                            PoissonRegression)
from dask_ml_tpu_torch.parallel import telemetry
from dask_ml_tpu_torch.parallel.faults import (FaultInjector, GracefulDrain,
                                               InjectedTransferError,
                                               RetryPolicy)
from dask_ml_tpu_torch.parallel.serving import (DEFAULT_SERVING_POLICY,
                                                DeadlineExceeded,
                                                ModelRegistry, ServingClosed,
                                                ServingLoop,
                                                ServingQueueFull,
                                                ServingStopped, _Request,
                                                serving_buckets)
from dask_ml_tpu_torch.parallel.shapes import PadPolicy, track_compiles
from dask_ml_tpu_torch.wrappers import ParallelPostFit

#: request sizes on each side of the bucket boundaries (powers of two
#: from 32), n = 1 and n below the smallest bucket included
RAGGED_SIZES = (1, 3, 31, 32, 33, 63, 64, 65, 100, 127, 128, 200)
#: the families whose scores are one in-order fmaf chain a row (K2)
K2_FAMILIES = ("kmeans", "minibatch", "sketched", "spectral",
               "kernel_kmeans")
WAIT = 60  # seconds: the bound of every wait on a future


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


def _data(n=512, d=8, seed=0):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


def _xs(name, X):
    """The request rows a model takes: the sketched model is 24 wide."""
    return np.hstack([X, X, X]) if name == "sketched" else X


@pytest.fixture(scope="module")
def fitted():
    """One fitted port estimator per registry family."""
    X = _data(512, 8)
    rng = np.random.RandomState(1)
    y_bin = (rng.rand(512) > 0.5).astype(np.int32)
    y_multi = rng.randint(0, 3, 512).astype(np.int32)
    y_reg = X @ rng.randn(8).astype(np.float32)
    with config_context(device="cpu"):
        return {
            "X": X,
            "kmeans": KMeans(n_clusters=4, random_state=0,
                             max_iter=5).fit(X),
            "minibatch": MiniBatchKMeans(n_clusters=4,
                                         random_state=0).fit(X),
            "sketched": KMeans(n_clusters=8, algorithm="sketched",
                               random_state=0).fit(_xs("sketched", X)),
            "logistic": LogisticRegression(max_iter=20).fit(X, y_bin),
            "multinomial": LogisticRegression(
                max_iter=20, multiclass="multinomial").fit(X, y_multi),
            "ovr": LogisticRegression(max_iter=20).fit(X, y_multi),
            "linear": LinearRegression(max_iter=20).fit(X, y_reg),
            "poisson": PoissonRegression(max_iter=20).fit(
                X, rng.poisson(1.0, 512)),
            "pca": PCA(n_components=3, random_state=0).fit(X),
            "pca_whiten": PCA(n_components=3, whiten=True,
                              random_state=0).fit(X),
            "spectral": SpectralClustering(
                n_clusters=3, n_components=40, gamma=None,
                random_state=0).fit(_data(400, 8, seed=2)),
            "kernel_kmeans": KernelKMeans(
                n_clusters=3, n_components=40,
                random_state=0).fit(_data(400, 8, seed=2)),
        }


#: (registry name, served method)
FAMILIES = [("kmeans", "predict"), ("minibatch", "predict"),
            ("sketched", "predict"), ("spectral", "predict"),
            ("kernel_kmeans", "predict"), ("logistic", "predict"),
            ("logistic", "predict_proba"), ("multinomial", "predict"),
            ("multinomial", "predict_proba"), ("ovr", "predict"),
            ("ovr", "predict_proba"), ("linear", "predict"),
            ("poisson", "predict"), ("pca", "transform"),
            ("pca_whiten", "transform")]


@pytest.fixture()
def loop(fitted):
    reg = ModelRegistry()
    for name in {n for n, _ in FAMILIES}:
        reg.register(name, fitted[name])
    lp = ServingLoop(reg, max_batch_rows=256)
    lp.start()
    yield lp
    lp.stop()


def _proba_margin(p):
    """Each row's margin of its label: |p − ½| for a binary probability,
    the gap between the two largest probabilities otherwise."""
    if p.ndim == 1:
        return np.abs(p - 0.5)
    top = np.sort(p, axis=1)
    return top[:, -1] - top[:, -2]


def assert_served(name, method, est, X, got):
    """Served against direct: bit for bit for the K2 families; the GEMV /
    GEMM runners within rtol 1e-5, labels equal beyond a 1e-5 margin."""
    want = getattr(est, method)(X)
    assert got.dtype == np.asarray(want).dtype, (name, method)
    assert got.shape == np.asarray(want).shape, (name, method)
    if name in K2_FAMILIES:
        np.testing.assert_array_equal(got, want, err_msg=f"{name}.{method}")
    elif method == "predict" and hasattr(est, "predict_proba"):
        sure = _proba_margin(est.predict_proba(X)) > 1e-5
        np.testing.assert_array_equal(got[sure], want[sure])
    else:
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                   err_msg=f"{name}.{method}")


# ---------------------------------------------------------------------------
# served against direct, every family, ragged sizes
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("name,method", FAMILIES,
                         ids=[f"{n}-{m}" for n, m in FAMILIES])
def test_served_equals_direct_ragged(loop, fitted, name, method):
    est = fitted[name]
    X = _xs(name, fitted["X"])
    futs = [(n, loop.submit(name, X[:n], method=method))
            for n in RAGGED_SIZES]
    for n, fut in futs:
        assert_served(name, method, est, X[:n], fut.result(WAIT))


def test_served_k2_on_integer_rows_bit_for_bit(loop, fitted):
    """On integer-valued rows every distance is exact: the K2 families
    and the direct calls agree bit for bit, whichever batch a row rode."""
    Xi = np.random.RandomState(3).randint(-4, 5, (200, 8)).astype(
        np.float32)
    for name in ("kmeans", "minibatch", "sketched"):
        Xn = _xs(name, Xi)
        futs = [(n, loop.submit(name, Xn[:n])) for n in RAGGED_SIZES]
        for n, fut in futs:
            np.testing.assert_array_equal(fut.result(WAIT),
                                          fitted[name].predict(Xn[:n]))


def test_bf16_wire_served_like_direct(fitted):
    """Under precision="bf16" the loop pads its batches in bf16 (the wire
    dtype, read at start()) and the K2 runner gets bf16 rows, as the
    direct predict stages them: the labels are the same bits."""
    X = fitted["X"]
    reg = ModelRegistry()
    reg.register("km", fitted["kmeans"])
    with config_context(precision="bf16"):
        with ServingLoop(reg, max_batch_rows=256) as lp:
            assert lp._wire == torch.bfloat16
            seen = []
            real = lp._stage
            lp._stage = lambda buf: (seen.append(buf.dtype), real(buf))[1]
            futs = [(n, lp.submit("km", X[:n])) for n in RAGGED_SIZES]
            for n, f in futs:
                np.testing.assert_array_equal(
                    f.result(WAIT), fitted["kmeans"].predict(X[:n]))
    assert seen and set(seen) == {torch.bfloat16}


def test_concatenation_order(loop, fitted):
    """Requests coalesced into one batch get their own rows back."""
    X = fitted["X"]
    est = fitted["kmeans"]
    reqs = [X[i * 10:(i * 10) + 7] for i in range(8)]
    futs = [loop.submit("kmeans", r) for r in reqs]
    for r, fut in zip(reqs, futs):
        np.testing.assert_array_equal(fut.result(WAIT), est.predict(r))


# ---------------------------------------------------------------------------
# warmup: nothing built or loaded after it
# ---------------------------------------------------------------------------


def test_warmup_then_nothing_built_or_loaded(loop, fitted):
    """warmup() runs every (model, method, bucket) through the serving
    path; steady traffic afterwards adds no nvcc build and no library
    load (on the CPU both counts stay 0: the wrappers run their plain
    versions; tests/test_torch_gpu.py holds it on the card)."""
    X = fitted["X"]
    w = loop.warmup()
    n_device = sum(1 for n in loop.registry.names()
                   for r in loop.registry.get(n).runners.values()
                   if r.kind == "device")
    assert w["n_programs"] == n_device * len(
        serving_buckets(loop.policy, loop.max_batch_rows))
    assert set(w) == {"n_programs", "n_compiles", "compile_seconds",
                      "n_loads", "load_seconds"}
    with track_compiles() as t:
        futs = [loop.submit("kmeans", X[:n]) for n in RAGGED_SIZES]
        futs += [loop.submit("logistic", X[:n], method="predict_proba")
                 for n in RAGGED_SIZES]
        for f in futs:
            f.result(WAIT)
    assert t["n_compiles"] == 0 and t["n_loads"] == 0, t


@pytest.mark.parametrize("max_rows", [1, 31, 32, 33, 256, 2048])
def test_serving_buckets_cover_range(max_rows):
    pol = DEFAULT_SERVING_POLICY
    sizes = serving_buckets(pol, max_rows)
    assert sizes == sorted(set(sizes))
    assert sizes[-1] >= max_rows
    assert {pol.bucket(n) for n in range(1, max_rows + 1)} <= set(sizes)


def test_direct_and_served_share_kernels(fitted):
    """Direct calls at the serving buckets leave warmup nothing to build
    or load: both paths launch the same kernel wrappers."""
    est = fitted["kmeans"]
    X = _data(300, 8, seed=4)
    reg = ModelRegistry()
    reg.register("m", est)
    with ServingLoop(reg, max_batch_rows=256) as lp:
        for b in serving_buckets(lp.policy, 256):
            est.predict(X[:b])
        w = lp.warmup()
    assert w["n_compiles"] == 0 and w["n_loads"] == 0, w


def test_custom_policy_honored(fitted):
    pol = PadPolicy(waste_cap=1.0, min_rows=8)
    reg = ModelRegistry()
    reg.register("km", fitted["kmeans"])
    with ServingLoop(reg, policy=pol, max_batch_rows=64) as lp:
        assert lp.warmup()["n_programs"] == len(serving_buckets(pol, 64))
        seen = []
        real = lp._stage
        lp._stage = lambda buf: (seen.append(buf.shape[0]), real(buf))[1]
        np.testing.assert_array_equal(
            lp.submit("km", fitted["X"][:5]).result(WAIT),
            fitted["kmeans"].predict(fitted["X"][:5]))
    assert seen == [8]


# ---------------------------------------------------------------------------
# batching mechanics
# ---------------------------------------------------------------------------


class _BlockingModel:
    """A host model whose predict blocks until released: holds the
    dispatch thread while requests pile up behind it."""

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()

    def predict(self, X):
        self.entered.set()
        assert self.release.wait(30), "never released"
        return np.asarray(X).sum(axis=1)


def _held(fitted, **kw):
    """A started loop serving ``blocker`` and ``km``, with the blocker's
    first request dispatched and holding the thread."""
    blocker = _BlockingModel()
    reg = ModelRegistry()
    reg.register("blocker", blocker)
    reg.register("km", fitted["kmeans"])
    lp = ServingLoop(reg, **kw).start()
    head = lp.submit("blocker", fitted["X"][:4])
    assert blocker.entered.wait(30)
    return lp, blocker, head


def test_concurrent_requests_coalesce(fitted):
    lp, blocker, head = _held(fitted, max_batch_rows=512)
    try:
        X = fitted["X"]
        futs = [lp.submit("km", X[i:i + 5]) for i in range(10)]
        blocker.release.set()
        head.result(WAIT)
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(
                f.result(WAIT), fitted["kmeans"].predict(X[i:i + 5]))
        assert lp.n_batches == 2  # the blocker's and one coalesced batch
        assert lp.rows_served == 4 + 50
    finally:
        blocker.release.set()
        lp.stop()


def test_batch_row_budget_splits(fitted):
    lp, blocker, head = _held(fitted, max_batch_rows=64)
    try:
        futs = [lp.submit("km", fitted["X"][:40]) for _ in range(4)]
        blocker.release.set()
        head.result(WAIT)
        for f in futs:
            f.result(WAIT)
        assert lp.n_batches == 1 + 4  # 40 + 40 > 64: one request a batch
    finally:
        blocker.release.set()
        lp.stop()


def test_queue_full_backpressure(fitted):
    lp, blocker, head = _held(fitted, max_batch_rows=64, max_queue=2)
    try:
        lp.submit("km", fitted["X"][:4])
        lp.submit("km", fitted["X"][:4])
        with pytest.raises(ServingQueueFull):
            lp.submit("km", fitted["X"][:4])
        blocker.release.set()
        head.result(WAIT)
    finally:
        blocker.release.set()
        lp.stop()


# ---------------------------------------------------------------------------
# validation fails the caller, never a shared batch
# ---------------------------------------------------------------------------


def test_submit_validation(loop, fitted):
    X = fitted["X"]
    with pytest.raises(KeyError):
        loop.submit("nope", X[:4])
    with pytest.raises(ValueError, match="does not serve"):
        loop.submit("kmeans", X[:4], method="predict_proba")
    with pytest.raises(ValueError, match="2D"):
        loop.submit("kmeans", X[0])
    with pytest.raises(ValueError, match="no rows"):
        loop.submit("kmeans", X[:0])
    with pytest.raises(ValueError, match="features"):
        loop.submit("kmeans", X[:4, :5])
    with pytest.raises(ValueError, match="cap"):
        loop.submit("kmeans", np.zeros((loop.max_request_rows + 1, 8),
                                       np.float32))
    with pytest.raises(ValueError, match="Unsupported dtype"):
        loop.submit("kmeans", X[:4].astype(np.complex64))
    bad = X[:4].copy()
    bad[1, 2] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        loop.submit("kmeans", bad)


@pytest.mark.parametrize("dtype", [np.int32, np.float64, np.bool_])
def test_other_dtypes_staged_like_direct(loop, fitted, dtype):
    Xi = (fitted["X"][:40] * 10).astype(dtype)
    np.testing.assert_array_equal(loop.submit("kmeans", Xi).result(WAIT),
                                  fitted["kmeans"].predict(Xi))


# ---------------------------------------------------------------------------
# the registry
# ---------------------------------------------------------------------------


def test_registry_semantics(fitted):
    reg = ModelRegistry()
    m = reg.register("a", fitted["kmeans"])
    assert m.methods == ("predict",) and m.n_features == 8
    assert reg.ensure(fitted["kmeans"]) == "a"  # by identity
    with pytest.raises(ValueError, match="already registered"):
        reg.register("a", fitted["pca"])
    reg.register("a", fitted["kmeans"])  # the same estimator: fine
    name = reg.ensure(fitted["pca"])
    assert reg.get(name).estimator is fitted["pca"]
    reg.invalidate(fitted["kmeans"])
    with pytest.raises(KeyError):
        reg.get("a")
    assert reg.names() == [name]
    reg.unregister(name)
    assert reg.names() == []
    # the landmark models are as wide as their input, not their centers
    assert reg.build("s", fitted["spectral"]).n_features == 8
    assert reg.build("k", fitted["kernel_kmeans"]).n_features == 8


def test_register_restricted_methods(fitted):
    reg = ModelRegistry()
    m = reg.register("lg", fitted["logistic"], methods=["predict_proba"])
    assert m.methods == ("predict_proba",)
    with pytest.raises(ValueError, match="cannot serve"):
        reg.register("pc", fitted["pca"], methods=["predict"])

    class Nothing:
        pass

    with pytest.raises(ValueError, match="exposes none"):
        reg.register("x", Nothing())


def test_registry_publish_versions(fitted):
    X, y = fitted["X"], fitted["X"] @ np.arange(8, dtype=np.float32)
    a = LinearRegression(max_iter=5).fit(X, y)
    b = LinearRegression(max_iter=10).fit(X, y)
    reg = ModelRegistry()
    v1 = reg.register("m", a).version
    assert reg.version("m") == v1 >= 1
    with pytest.raises(ValueError):
        reg.register("m", b)  # an accidental replacement stays an error
    v2 = reg.publish("m", b).version
    assert v2 > v1 and reg.get("m").estimator is b
    old = reg.build("m", a)
    assert old.version == 0  # not installed
    reg.install(old)
    assert reg.version("m") > v2 and reg.get("m").estimator is a


class _Echo:
    """A foreign model: sums rows, NaN-aware, any float dtype."""

    def predict(self, X):
        assert X.dtype in (np.float32, np.float64), X.dtype
        return np.nansum(X, axis=1)


def test_host_fallback_foreign_estimator(fitted):
    """An estimator of no port family is served through the host batch
    path, equal to calling it."""
    echo = _Echo()
    reg = ModelRegistry()
    assert reg.register("echo", echo).runners["predict"].kind == "host"
    X = fitted["X"]
    with ServingLoop(reg, max_batch_rows=128) as lp:
        for n in (1, 7, 33):
            np.testing.assert_array_equal(
                lp.submit("echo", X[:n]).result(WAIT), echo.predict(X[:n]))


def test_host_fallback_preserves_dtype_and_nan(fitted):
    """A host model sees each request as given: float64 stays float64 and
    NaN passes; requests of two dtypes coalesce apart."""
    echo = _Echo()
    lp, blocker, head = _held(fitted)
    lp.registry.register("echo", echo)
    try:
        X64 = np.asarray(fitted["X"][:8], np.float64)
        X64[2, 1] = np.nan
        X32 = fitted["X"][8:13]
        f64 = lp.submit("echo", X64)
        f32 = lp.submit("echo", X32)
        blocker.release.set()
        head.result(WAIT)
        out64 = f64.result(WAIT)
        assert out64.dtype == np.float64
        np.testing.assert_array_equal(out64, echo.predict(X64))
        np.testing.assert_array_equal(f32.result(WAIT), echo.predict(X32))
    finally:
        blocker.release.set()
        lp.stop()


def test_callable_affinity_spectral_is_host_served(fitted):
    """A SpectralClustering with a callable kernel has no staged runner:
    the host path serves its predict, equal to the direct call."""
    from dask_ml_tpu_torch.ops.pairwise import rbf_kernel

    Xs = _data(300, 8, seed=2)
    sc = SpectralClustering(n_clusters=3, n_components=30,
                            affinity=lambda a, b, **kw: rbf_kernel(
                                a, b, gamma=0.1),
                            random_state=0).fit(Xs)
    reg = ModelRegistry()
    assert reg.register("sc", sc).runners["predict"].kind == "host"
    with ServingLoop(reg) as lp:
        np.testing.assert_array_equal(lp.submit("sc", Xs[:17]).result(WAIT),
                                      sc.predict(Xs[:17]))


# ---------------------------------------------------------------------------
# lifecycle: stop, drain, faults
# ---------------------------------------------------------------------------


def test_stop_rejects_new_submits(fitted):
    reg = ModelRegistry()
    reg.register("km", fitted["kmeans"])
    lp = ServingLoop(reg).start()
    lp.stop()
    with pytest.raises(ServingClosed):
        lp.submit("km", fitted["X"][:4])
    assert lp.stopped and not lp.alive()


def test_stop_without_drain_fails_queued(fitted):
    lp, blocker, head = _held(fitted)
    fut = lp.submit("km", fitted["X"][:4])
    stopper = threading.Thread(target=lp.stop, kwargs={"drain": False})
    stopper.start()
    # the queued request is failed before the held batch is released
    with pytest.raises(ServingStopped):
        fut.result(WAIT)
    blocker.release.set()
    stopper.join(WAIT)
    assert not stopper.is_alive()
    head.result(WAIT)


def test_graceful_drain_flushes_then_rejects(fitted):
    drain = GracefulDrain()
    lp, blocker, head = _held(fitted, drain=drain)
    try:
        X = fitted["X"]
        futs = [lp.submit("km", X[i:i + 3]) for i in range(6)]
        drain.request()
        with pytest.raises(ServingClosed):
            lp.submit("km", X[:4])
        blocker.release.set()
        head.result(WAIT)
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(
                f.result(WAIT), fitted["kmeans"].predict(X[i:i + 3]))
        lp._thread.join(30)
        assert not lp._thread.is_alive()
        assert lp.stats()["closed"]
    finally:
        blocker.release.set()
        lp.stop()


def test_transfer_fault_fails_batch_not_queue(fitted):
    inj = FaultInjector().fail_transfer(1, times=1)  # the first batch
    reg = ModelRegistry()
    reg.register("km", fitted["kmeans"])
    with ServingLoop(reg, fault_injector=inj) as lp:
        bad = lp.submit("km", fitted["X"][:8])
        with pytest.raises(InjectedTransferError):
            bad.result(WAIT)
        good = lp.submit("km", fitted["X"][:8])
        np.testing.assert_array_equal(
            good.result(WAIT), fitted["kmeans"].predict(fitted["X"][:8]))
        assert lp.n_errors == 1
        assert inj.injected["transfer"] == 1


def test_transfer_fault_retried_under_policy(fitted):
    inj = FaultInjector().fail_transfer(1, times=2)
    pol = RetryPolicy(max_retries=3, base_delay=0.01)
    reg = ModelRegistry()
    reg.register("km", fitted["kmeans"])
    with ServingLoop(reg, fault_injector=inj, retry_policy=pol) as lp:
        np.testing.assert_array_equal(
            lp.submit("km", fitted["X"][:8]).result(WAIT),
            fitted["kmeans"].predict(fitted["X"][:8]))
    assert pol.retries == 2
    assert inj.injected["transfer"] == 2


class _Broken:
    def predict(self, X):
        raise RuntimeError("kaboom")


def test_runner_exception_delivered_per_request(fitted, monkeypatch):
    """A runner that raises fails its batch's requests with that error,
    and the loop serves on. A device runner whose kernel fails is the
    same case: the error reaches the futures and never the host path."""
    from dask_ml_tpu_torch.models import kmeans as km_core

    reg = ModelRegistry()
    reg.register("broken", _Broken())
    reg.register("km", fitted["kmeans"])
    with ServingLoop(reg) as lp:
        with pytest.raises(RuntimeError, match="kaboom"):
            lp.submit("broken", fitted["X"][:4]).result(WAIT)

        def launch_failed(*a, **k):
            raise RuntimeError("fused_argmin_min: CUDA error 700 at launch")

        monkeypatch.setattr(km_core, "predict_labels", launch_failed)
        with pytest.raises(RuntimeError, match="CUDA error"):
            lp.submit("km", fitted["X"][:4]).result(WAIT)
        monkeypatch.undo()
        np.testing.assert_array_equal(
            lp.submit("km", fitted["X"][:4]).result(WAIT),
            fitted["kmeans"].predict(fitted["X"][:4]))
        assert lp.n_errors == 2 and lp.alive()


def test_cancel_before_dispatch_does_not_kill_loop(fitted):
    lp, blocker, head = _held(fitted)
    try:
        X = fitted["X"]
        doomed = lp.submit("km", X[:5])
        kept = lp.submit("km", X[5:12])
        assert doomed.cancel()
        blocker.release.set()
        head.result(WAIT)
        np.testing.assert_array_equal(kept.result(WAIT),
                                      fitted["kmeans"].predict(X[5:12]))
        np.testing.assert_array_equal(lp.submit("km", X[:3]).result(WAIT),
                                      fitted["kmeans"].predict(X[:3]))
        assert doomed.cancelled()
    finally:
        blocker.release.set()
        lp.stop()


def test_stop_submit_race_barrier(fitted):
    """Submitters race stop(drain=True) across a barrier: every future
    they got resolves, with the labels or ServingStopped, and no submit
    hangs."""
    X = fitted["X"]
    km = fitted["kmeans"]
    expected = km.predict(X[:3])
    for _trial in range(4):
        reg = ModelRegistry()
        reg.register("kmeans", km)
        lp = ServingLoop(reg, max_batch_rows=64).start()
        barrier = threading.Barrier(5)
        futures: list = []
        flock = threading.Lock()

        def worker():
            with config_context(device="cpu"):
                barrier.wait(WAIT)
                for _ in range(40):
                    try:
                        f = lp.submit("kmeans", X[:3])
                    except ServingClosed:  # ServingStopped included
                        return
                    with flock:
                        futures.append(f)

        threads = [threading.Thread(target=worker) for _ in range(4)]
        for t in threads:
            t.start()
        barrier.wait(WAIT)
        lp.stop(drain=True)
        for t in threads:
            t.join(WAIT)
            assert not t.is_alive()
        for f in futures:
            try:
                np.testing.assert_array_equal(f.result(WAIT), expected)
            except ServingStopped:
                pass  # refused by the drain: allowed; pending is not


def test_dispatch_thread_death_fails_everything(fitted):
    """If the dispatch thread dies (a BaseException out of a runner),
    every queued future fails with the fatal error, nothing is left
    pending, and later submits raise ServingStopped naming it."""

    class Bomb:
        def __init__(self):
            self.armed = threading.Event()
            self.entered = threading.Event()

        def predict(self, X):
            self.entered.set()
            self.armed.wait(30)
            raise KeyboardInterrupt("simulated thread death")

    bomb = Bomb()
    reg = ModelRegistry()
    reg.register("bomb", bomb)
    lp = ServingLoop(reg, max_batch_rows=4).start()
    X = np.zeros((3, 2), np.float32)
    first = lp.submit("bomb", X)
    assert bomb.entered.wait(30)
    queued = lp.submit("bomb", X)  # a second batch, still queued
    bomb.armed.set()
    with pytest.raises(KeyboardInterrupt):
        first.result(WAIT)
    with pytest.raises(KeyboardInterrupt):
        queued.result(WAIT)
    lp._thread.join(WAIT)
    assert isinstance(lp.fatal, KeyboardInterrupt)
    with pytest.raises(ServingStopped, match="KeyboardInterrupt"):
        lp.submit("bomb", X)
    lp.stop()


# ---------------------------------------------------------------------------
# telemetry
# ---------------------------------------------------------------------------


def test_serving_telemetry_surface(fitted):
    telemetry.reset_telemetry()
    reg = ModelRegistry()
    reg.register("km", fitted["kmeans"])
    try:
        with config_context(telemetry=True):
            with ServingLoop(reg, max_batch_rows=128) as lp:
                for f in [lp.submit("km", fitted["X"][:n])
                          for n in (1, 5, 17, 40)]:
                    f.result(WAIT)
            rep = telemetry.telemetry_report()
        counters = rep["metrics"]["counters"]
        assert counters["serving.requests{model=km}"] == 4
        assert counters["serving.rows{model=km}"] == 63
        assert counters["serving.batches{model=km}"] == lp.n_batches
        gauges = rep["metrics"]["gauges"]
        assert 0.0 < gauges["serving.batch_occupancy"]["last"] <= 1.0
        qd = gauges["serving.queue_depth"]
        assert qd["n_samples"] >= 4 and qd["min"] >= 0
        hist = rep["metrics"]["histograms"]
        lat = hist["serving.request_seconds{model=km}"]
        assert lat["count"] == 4
        assert lat["p99"] is not None and lat["p99"] >= lat["p50"] > 0
        assert hist["serving.batch_seconds"]["count"] == lp.n_batches
        assert hist["serving.batch_rows"]["count"] == lp.n_batches
        batches = [s for s in telemetry.spans()
                   if s["name"] == "serving.batch"]
        assert len(batches) == lp.n_batches
        assert all(s["attrs"]["bucket"] in (32, 64) for s in batches)
        # the knob off (the default): nothing recorded
        telemetry.reset_telemetry()
        reg2 = ModelRegistry()
        reg2.register("km", fitted["kmeans"])
        with ServingLoop(reg2) as lp2:
            lp2.submit("km", fitted["X"][:4]).result(WAIT)
        off = telemetry.telemetry_report()
        assert off["metrics"]["counters"] == {} and off["spans"][
            "n_recorded"] == 0
    finally:
        telemetry.reset_telemetry()


def test_call_records_request_span(fitted):
    telemetry.reset_telemetry()
    reg = ModelRegistry()
    reg.register("km", fitted["kmeans"])
    try:
        with config_context(telemetry=True):
            with ServingLoop(reg) as lp:
                out = lp.call("km", fitted["X"][:9], timeout=WAIT)
        np.testing.assert_array_equal(
            out, fitted["kmeans"].predict(fitted["X"][:9]))
        names = [s["name"] for s in telemetry.spans()]
        assert "serving.request" in names and "serving.batch" in names
    finally:
        telemetry.reset_telemetry()


def test_set_config_enables_telemetry_mid_flight(fitted):
    telemetry.reset_telemetry()
    reg = ModelRegistry()
    reg.register("km", fitted["kmeans"])
    try:
        with ServingLoop(reg) as lp:
            lp.submit("km", fitted["X"][:4]).result(WAIT)  # knob off
            config.set_config(telemetry=True)
            try:
                lp.submit("km", fitted["X"][:4]).result(WAIT)
                counters = telemetry.metrics().snapshot()["counters"]
            finally:
                config.set_config(telemetry=False)
        assert counters.get("serving.requests{model=km}") == 1
    finally:
        telemetry.reset_telemetry()


def test_adaptive_serving_equal_and_gauged(fitted):
    telemetry.reset_telemetry()
    reg = ModelRegistry()
    reg.register("kmeans", fitted["kmeans"])
    try:
        with config_context(telemetry=True):
            with ServingLoop(reg, max_batch_rows=256) as lp:
                Xs = [_data(n, 8, seed=n) for n in (5, 33, 64, 1)]
                outs = [f.result(WAIT) for f in
                        [lp.submit("kmeans", X) for X in Xs]]
            for X, out in zip(Xs, outs):
                np.testing.assert_array_equal(
                    out, fitted["kmeans"].predict(X))
            snap = telemetry.metrics().snapshot()
        assert "serving.window_s" in snap["gauges"]
        occ = snap["histograms"]["serving.occupancy"]
        assert occ["count"] >= 1 and 0.0 < occ["max"] <= 1.0
    finally:
        telemetry.reset_telemetry()


# ---------------------------------------------------------------------------
# ParallelPostFit as a client of the loop
# ---------------------------------------------------------------------------


def test_parallel_post_fit_serving_mode(fitted):
    reg = ModelRegistry()
    with ServingLoop(reg, max_batch_rows=128) as lp:
        clf = ParallelPostFit(estimator=fitted["kmeans"], serving=lp)
        X = fitted["X"]
        for n in (1, 31, 100):
            np.testing.assert_array_equal(clf.predict(X[:n]),
                                          fitted["kmeans"].predict(X[:n]))
        assert len(reg.names()) == 1  # registered once, by identity
        big = _data(300, 8, seed=3)  # above the cap: 3 chunks, in order
        np.testing.assert_array_equal(clf.predict(big),
                                      fitted["kmeans"].predict(big))
        assert lp.n_completed == 3 + 3
        lr = ParallelPostFit(estimator=fitted["logistic"], serving=lp)
        assert_served("logistic", "predict_proba", fitted["logistic"],
                      big, lr.predict_proba(big))


def test_parallel_post_fit_request_span(fitted):
    telemetry.reset_telemetry()
    try:
        with config_context(telemetry=True):
            with ServingLoop(ModelRegistry(), max_batch_rows=64) as lp:
                ParallelPostFit(estimator=fitted["kmeans"],
                                serving=lp).predict(fitted["X"][:150])
        reqs = [s for s in telemetry.spans()
                if s["name"] == "serving.request"]
        assert len(reqs) == 1 and reqs[0]["attrs"]["rows"] == 150
    finally:
        telemetry.reset_telemetry()


def test_parallel_post_fit_serving_fallback_methods(fitted):
    """A method the loop does not serve (KMeans.transform) takes the
    direct path; a method the estimator lacks raises AttributeError."""
    with ServingLoop(ModelRegistry()) as lp:
        clf = ParallelPostFit(estimator=fitted["kmeans"], serving=lp)
        X = fitted["X"][:20]
        np.testing.assert_array_equal(clf.transform(X),
                                      fitted["kmeans"].transform(X))
        with pytest.raises(AttributeError):
            ParallelPostFit(estimator=fitted["pca"], serving=lp).predict(X)


def test_parallel_post_fit_refit_invalidates(fitted):
    rng = np.random.RandomState(5)
    X = rng.randn(256, 4).astype(np.float32)
    est = KMeans(n_clusters=3, random_state=0, max_iter=5)
    with ServingLoop(ModelRegistry()) as lp:
        clf = ParallelPostFit(estimator=est, serving=lp)
        clf.fit(X)
        out1 = clf.predict(X[:50])
        np.testing.assert_array_equal(out1, est.predict(X[:50]))
        clf.fit(X * -3.0 + 5.0)  # drops the registration
        out2 = clf.predict(X[:50])
        np.testing.assert_array_equal(out2, est.predict(X[:50]))
        assert not np.array_equal(out1, out2)


def test_mid_fit_reregistration_dropped(fitted):
    """A predict racing a refit may register the old state mid-fit; the
    wrapper drops it again after the fit, so the next request stages the
    final state."""
    hook = {"fn": None}

    class HookedKMeans(KMeans):
        def fit(self, X, y=None, **kw):
            if hook["fn"] is not None:
                hook["fn"]()  # the racing predict, before the state moves
            return super().fit(X, y, **kw)

    rng = np.random.RandomState(11)
    X = rng.randn(256, 4).astype(np.float32)
    est = HookedKMeans(n_clusters=3, random_state=0, max_iter=5)
    with ServingLoop(ModelRegistry()) as lp:
        clf = ParallelPostFit(estimator=est, serving=lp)
        clf.fit(X)
        clf.predict(X[:10])
        hook["fn"] = lambda: clf.predict(X[:10])
        clf.fit(X * -2.0 + 3.0)
        hook["fn"] = None
        np.testing.assert_array_equal(clf.predict(X[:50]),
                                      est.predict(X[:50]))


def test_parallel_post_fit_sparse_falls_back(fitted, monkeypatch):
    """A sparse request goes to the direct predict (K6 on the card: the
    SpMV); the loop never sees it."""
    from dask_ml_tpu_torch import _kernels
    from dask_ml_tpu_torch.ops import sparse as sparse_ops

    rng = np.random.RandomState(7)
    Xd = ((rng.rand(120, 8) > 0.6) * rng.randint(1, 4, (120, 8))).astype(
        np.float32)
    y = (Xd.sum(1) > Xd.sum(1).mean()).astype(np.int32)
    est = LogisticRegression(solver="lbfgs", max_iter=10).fit(Xd, y)
    calls = []
    real = sparse_ops.matvec
    monkeypatch.setattr(sparse_ops, "matvec",
                        lambda *a, **k: (calls.append(1), real(*a, **k))[1])
    reg = ModelRegistry()
    with ServingLoop(reg) as lp:
        clf = ParallelPostFit(estimator=est, serving=lp)
        Xs = sp.csr_matrix(Xd)
        np.testing.assert_array_equal(clf.predict(Xs), est.predict(Xd))
        assert calls  # the container's SpMV ran
        assert reg.names() == [] and lp.n_submitted == 0
    del _kernels


def test_named_registration_conflict_raises(fitted):
    reg = ModelRegistry()
    reg.register("taken", fitted["kmeans"])
    with ServingLoop(reg) as lp:
        clf = ParallelPostFit(estimator=fitted["logistic"], serving=lp,
                              serving_model="taken")
        with pytest.raises(ValueError, match="already registered"):
            clf.predict(fitted["X"][:4])


# ---------------------------------------------------------------------------
# admission: earliest deadline first, priorities, shedding
# ---------------------------------------------------------------------------


class _GateModel:
    """A host model whose every dispatch waits for ``release``; records
    each batch's rows (distinct per request: the call log is the dispatch
    order) and signals each entry."""

    def __init__(self):
        self.release = threading.Event()
        self.entered = threading.Event()
        self.calls = []

    def predict(self, X):
        self.entered.set()
        self.release.wait(30)
        self.calls.append(int(len(X)))
        return np.zeros(len(X), np.float32)


#: (rows, submit kwargs) after the head request: no two coalesce at 8 rows
EDF_TRACE = [(7, {"deadline": 20.0}), (6, {}), (5, {"deadline": 5.0}),
             (8, {"priority": 5})]
EDF_ORDER = [4, 5, 7, 8, 6]


def _edf_order(loop_cls, registry_cls):
    reg = registry_cls()
    gate = _GateModel()
    reg.register("gate", gate)
    lp = loop_cls(reg, max_batch_rows=8).start()
    try:
        X = np.zeros((8, 3), np.float32)
        futs = [lp.submit("gate", X[:4])]
        assert gate.entered.wait(30)  # the head holds the dispatch thread
        futs += [lp.submit("gate", X[:n], **kw) for n, kw in EDF_TRACE]
        gate.release.set()
        for f in futs:
            f.result(WAIT)
        return gate.calls
    finally:
        gate.release.set()
        lp.stop()


def test_edf_admission_order():
    assert _edf_order(ServingLoop, ModelRegistry) == EDF_ORDER


def test_edf_admission_order_equals_jax():
    """With the dispatch thread held, both packages dispatch the same
    submit trace in the same order."""
    assert _edf_order(ServingLoop, ModelRegistry) == _edf_order(
        jserving.ServingLoop, jserving.ModelRegistry)


def test_deadline_shed_at_admission():
    reg = ModelRegistry()
    reg.register("gate", _GateModel())
    with ServingLoop(reg) as lp:
        with pytest.raises(DeadlineExceeded):
            lp.submit("gate", np.zeros((2, 3), np.float32), deadline=-0.5)
        with pytest.raises(DeadlineExceeded):
            lp.submit("gate", np.zeros((2, 3), np.float32), deadline=0.0)
        assert lp.n_shed == 2


def test_deadline_shed_while_queued():
    telemetry.reset_telemetry()
    try:
        with config_context(telemetry=True):
            reg = ModelRegistry()
            gate = _GateModel()
            reg.register("gate", gate)
            lp = ServingLoop(reg, max_batch_rows=8).start()
            try:
                X = np.zeros((4, 3), np.float32)
                blocker = lp.submit("gate", X[:4])
                assert gate.entered.wait(30)
                budget = 0.05
                t_sub = time.perf_counter()
                doomed = lp.submit("gate", X[:3], deadline=budget)
                survivor = lp.submit("gate", X[:2], deadline=30.0)
                # let the doomed request's budget run out (a wait on the
                # clock, not on another thread)
                threading.Event().wait(
                    max(0.0, t_sub + budget - time.perf_counter()) + 0.02)
                gate.release.set()
                with pytest.raises(DeadlineExceeded):
                    doomed.result(WAIT)
                survivor.result(WAIT)
                blocker.result(WAIT)
                assert lp.n_shed == 1
            finally:
                gate.release.set()
                lp.stop()
            counters = telemetry.telemetry_report()["metrics"]["counters"]
        assert counters["serving.shed{model=gate}"] == 1
    finally:
        telemetry.reset_telemetry()


# ---------------------------------------------------------------------------
# the adaptive coalesce window, held against the JAX package's
# ---------------------------------------------------------------------------


def _req(cls, n=8, deadline=None):
    return cls(model="m", method="predict",
               X=np.zeros((n, 2), np.float32), n=n, future=Future(),
               t_enqueue=0.0, deadline=deadline)


def _both(**kw):
    """An unstarted port loop and JAX loop with the same settings."""
    kw.setdefault("max_batch_rows", 256)
    return (ServingLoop(ModelRegistry(), **kw),
            jserving.ServingLoop(jserving.ModelRegistry(), **kw))


#: controller states and batches of tests/test_serving.py:999-1060:
#: (loop kwargs, ia_ewma, arrival_rows_ewma, last_arrival offset or None,
#:  latency_ewma, [(rows, deadline offset or None)], batch rows)
WINDOW_CASES = [
    ({}, 0.0, 0.0, None, 0.0, [(8, None)], 8),
    ({}, 1e-3, 32.0, -1.0, 0.0, [(8, None)], 8),
    ({}, 1e-3, 32.0, 0.0, 0.0, [(32, None)], 32),
    ({}, 1e-3, 32.0, 0.0, 0.0, [(8, None)], 256),
    ({}, 1e-3, 32.0, 0.0, 0.0, [(33, None)], 33),
    ({"coalesce_window_max_s": 0.005}, 4e-3, 1.0, 0.0, 0.0,
     [(33, None)], 33),
    ({"coalesce_window_max_s": 0.005}, 6e-3, 1.0, 0.0, 0.0,
     [(33, None)], 33),
    ({}, 1e-2, 1.0, 0.0, 0.001, [(33, None)], 33),
    ({}, 1e-2, 1.0, 0.0, 0.001, [(33, 0.004)], 33),
    ({}, 1e-2, 1.0, 0.0, 0.001, [(33, 0.001)], 33),
]


@pytest.mark.parametrize("case", range(len(WINDOW_CASES)))
def test_adaptive_window_equals_jax(case):
    kw, ia, rows_ewma, last, lat, reqs, rows = WINDOW_CASES[case]
    now = time.perf_counter()
    got = []
    for lp, cls in zip(_both(**kw), (_Request, jserving._Request)):
        lp._ia_ewma = ia
        lp._arrival_rows_ewma = rows_ewma
        lp._last_arrival = None if last is None else now + last
        lp._latency_ewma = lat
        batch = [_req(cls, n, None if dl is None else now + dl)
                 for n, dl in reqs]
        got.append(lp._adaptive_window(batch, rows, now))
    assert got[0] == got[1]


def test_adaptive_window_rules():
    """The port's controller on its own: idle and boundaries give 0, the
    bucket's fill time otherwise, the budget and the deadline clamp it."""
    lp, _ = _both()
    now = time.perf_counter()
    assert lp._adaptive_window([_req(_Request)], 8, now) == 0.0
    lp._ia_ewma, lp._arrival_rows_ewma, lp._last_arrival = 1e-3, 32.0, now
    w = lp._adaptive_window([_req(_Request, 33)], 33, now)
    assert w == pytest.approx(31.0 / 32000.0)
    lp._ia_ewma, lp._arrival_rows_ewma, lp._latency_ewma = 1e-2, 1.0, 0.001
    assert lp._adaptive_window([_req(_Request, 33)], 33,
                               now) == lp.coalesce_window_max_s
    tight = lp._adaptive_window([_req(_Request, 33, now + 0.004)], 33, now)
    assert tight == pytest.approx(0.004 - 1.5 * 0.001, abs=1e-4)


def test_coalesce_window_validation():
    with pytest.raises(ValueError, match="adaptive"):
        ServingLoop(ModelRegistry(), coalesce_window_s="bogus")
    assert ServingLoop(ModelRegistry()).coalesce_window_s == "adaptive"
    lp = ServingLoop(ModelRegistry(), coalesce_window_s=0.002)
    assert lp.coalesce_window_s == 0.002


def test_fixed_window_coalesces(fitted):
    """A fixed window waits for mates after the first request: requests
    submitted inside it share one batch."""
    reg = ModelRegistry()
    reg.register("km", fitted["kmeans"])
    with ServingLoop(reg, coalesce_window_s=5.0, max_batch_rows=64) as lp:
        X = fitted["X"]
        futs = [lp.submit("km", X[i * 8:(i + 1) * 8]) for i in range(8)]
        for i, f in enumerate(futs):
            np.testing.assert_array_equal(
                f.result(WAIT), fitted["kmeans"].predict(X[i * 8:i * 8 + 8]))
        assert lp.n_batches == 1  # 64 rows: the budget ends the window


# ---------------------------------------------------------------------------
# shapes held against the JAX package
# ---------------------------------------------------------------------------


def test_pad_policy_and_buckets_equal_jax():
    for waste in (0.05, 0.125, 0.5, 1.0):
        for min_rows in (1, 8, 32, 64):
            t = PadPolicy(waste_cap=waste, min_rows=min_rows)
            j = jshapes.PadPolicy(waste_cap=waste, min_rows=min_rows)
            for n in list(range(0, 300)) + [1000, 2047, 2048, 2049, 65537]:
                for align in (1, 3):
                    assert t.bucket(n, align) == j.bucket(n, align)
            for max_rows in (1, 33, 256, 2048):
                assert serving_buckets(t, max_rows) == \
                    jserving.serving_buckets(j, max_rows)
            assert t.signature() == j.signature()
    assert DEFAULT_SERVING_POLICY.signature() == \
        jserving.DEFAULT_SERVING_POLICY.signature()
    with pytest.raises(ValueError):
        PadPolicy(waste_cap=0.0)
    with pytest.raises(ValueError):
        PadPolicy(min_rows=0)


# ---------------------------------------------------------------------------
# served results held against the JAX package's
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def jax_pair():
    """JAX models fitted on the CPU mesh, and the same models carried into
    the port."""
    X = _data(512, 8)
    rng = np.random.RandomState(1)
    y = (rng.rand(512) > 0.5).astype(np.int32)
    Xs = _data(400, 8, seed=2)
    j = {
        "kmeans": jcluster.KMeans(n_clusters=4, random_state=0,
                                  max_iter=5).fit(X),
        "minibatch": jcluster.MiniBatchKMeans(n_clusters=4,
                                              random_state=0).fit(X),
        "sketched": jcluster.KMeans(n_clusters=8, algorithm="sketched",
                                    sketch_cols=6, random_state=0,
                                    max_iter=20).fit(_xs("sketched", X)),
        "spectral": jcluster.SpectralClustering(
            n_clusters=3, n_components=40, gamma=None,
            random_state=0).fit(Xs),
        "kernel_kmeans": jcluster.KernelKMeans(
            n_clusters=3, n_components=40, random_state=0).fit(Xs),
        "logistic": jlm.LogisticRegression(solver="lbfgs",
                                           max_iter=20).fit(X, y),
        "pca": jdec.PCA(n_components=3, svd_solver="full").fit(X),
    }
    with config_context(device="cpu"):
        t = {"kmeans": kmeans_from_numpy(export_learned_attrs(j["kmeans"])),
             "sketched": kmeans_from_numpy(
                 export_learned_attrs(j["sketched"])),
             "logistic": glm_from_numpy(
                 export_learned_attrs(j["logistic"]), "logistic"),
             "pca": pca_from_numpy(export_learned_attrs(j["pca"]))}
        mb = MiniBatchKMeans(n_clusters=4)
        mb.cluster_centers_ = np.asarray(j["minibatch"].cluster_centers_,
                                         np.float32)
        t["minibatch"] = mb
        for name, carry, kw in (
                ("spectral", spectral_from_numpy, {"gamma": None}),
                ("kernel_kmeans", kernel_kmeans_from_numpy, {})):
            je = j[name]
            centers = (je.assign_labels_.cluster_centers_
                       if name == "spectral" else je.cluster_centers_)
            t[name] = carry({"_landmarks_": je._landmarks_,
                             "_extension_": je._extension_,
                             "_n_fit_rows_": je._n_fit_rows_,
                             "cluster_centers_": centers,
                             "labels_": je.labels_}, **kw)
    return j, t


def _serve_both(jax_pair, name, method, X, sizes):
    j, t = jax_pair
    jreg = jserving.ModelRegistry()
    jreg.register(name, j[name])
    treg = ModelRegistry()
    treg.register(name, t[name])
    with jserving.ServingLoop(jreg, max_batch_rows=256) as jl, \
            ServingLoop(treg, max_batch_rows=256) as tl:
        jf = [jl.submit(name, X[:n], method=method) for n in sizes]
        tf = [tl.submit(name, X[:n], method=method) for n in sizes]
        return ([np.asarray(f.result(WAIT)) for f in jf],
                [f.result(WAIT) for f in tf])


@pytest.mark.parametrize("name", K2_FAMILIES)
def test_served_labels_equal_jax(jax_pair, name):
    if name in ("spectral", "kernel_kmeans"):
        X = _data(400, 8, seed=2)
    else:
        X = _xs(name, np.random.RandomState(5).randint(
            -4, 5, (200, 8)).astype(np.float32))
    got_j, got_t = _serve_both(jax_pair, name, "predict", X, RAGGED_SIZES)
    for n, a, b in zip(RAGGED_SIZES, got_j, got_t):
        np.testing.assert_array_equal(b, a.astype(b.dtype),
                                      err_msg=f"{name} n={n}")


@pytest.mark.parametrize("name,method", [("logistic", "predict_proba"),
                                         ("pca", "transform")])
def test_served_gemm_families_close_to_jax(jax_pair, name, method):
    X = _data(200, 8, seed=6)
    got_j, got_t = _serve_both(jax_pair, name, method, X, RAGGED_SIZES)
    for a, b in zip(got_j, got_t):
        scale = 1.0 if method == "predict_proba" else float(
            np.abs(a).max())
        np.testing.assert_allclose(b, a, rtol=1e-5, atol=1e-5 * scale)

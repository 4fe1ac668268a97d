"""The port's wire (``parallel/fleet.py``: ``FleetServer``,
``FleetClient``, ``RetryBudget``) on the CPU: the wire cases of
``tests/test_fleet.py`` run against the port (results equal to direct
over both transports, validation and hostile bytes fail one frame or one
connection only, out-of-order responses, typed deadlines, one reconnect,
retries under a budget), then parity with the JAX package: a JAX package
client and a port client, over TCP and over the shared-memory ring, get
the same answers from one port server fronting a port ``ServingLoop``.

Every wait is bounded; gates and the server's own state order the steps.
"""

import socket
import threading
import time

import numpy as np
import pytest

from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.decomposition import PCA
from dask_ml_tpu_torch.linear_model import LogisticRegression
from dask_ml_tpu_torch.parallel import framing, telemetry
from dask_ml_tpu_torch.parallel import shm as shm_lib
from dask_ml_tpu_torch.parallel.fleet import (FleetClient, FleetServer,
                                              FleetTimeoutError,
                                              RetryBudget, ServingFleet)
from dask_ml_tpu_torch.parallel.serving import (DeadlineExceeded,
                                                ModelRegistry, ServingLoop)

WAIT = 60
#: the GEMM runners against their direct calls (ROADMAP caveat "Served
#: GEMM runners"): within this share of the request's largest value
GEMM_RTOL = 1e-5


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


def _data(n=512, d=8, seed=0):
    return np.random.RandomState(seed).randn(n, d).astype(np.float32)


@pytest.fixture(scope="module")
def fitted():
    X = _data(512, 8)
    rng = np.random.RandomState(1)
    y = (rng.rand(512) > 0.5).astype(np.int32)
    Xi = rng.randint(-8, 8, size=(512, 8)).astype(np.float32)
    with config_context(device="cpu"):
        return {
            "X": X,
            "Xi": Xi,
            "kmeans": KMeans(n_clusters=4, random_state=0,
                             max_iter=5).fit(X),
            "kmeans_int": KMeans(n_clusters=5, random_state=0,
                                 max_iter=10).fit(Xi),
            "logistic": LogisticRegression(max_iter=20).fit(X, y),
            "pca": PCA(n_components=3, random_state=0).fit(X),
        }


def _registry(fitted):
    reg = ModelRegistry()
    for name in ("kmeans", "kmeans_int", "logistic", "pca"):
        reg.register(name, fitted[name])
    return reg


@pytest.fixture()
def served(fitted):
    """A port FleetServer fronting a port ServingLoop on the CPU."""
    loop = ServingLoop(_registry(fitted), max_batch_rows=256).start()
    server = FleetServer(loop).start()
    yield loop, server
    server.stop()
    loop.stop()


class _GateModel:
    """A host model whose dispatches wait for ``release``."""

    n_features_in_ = 3

    def __init__(self):
        self.release = threading.Event()

    def predict(self, X):
        self.release.wait(WAIT)
        return np.zeros(len(X), np.float32)


def _gemm_close(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    assert got.shape == want.shape and got.dtype == want.dtype
    assert float(np.abs(got.astype(np.float64) - want).max()) \
        <= GEMM_RTOL * scale


def _wire_response(sock):
    payload = framing.read_frame(sock, magic=framing.WIRE_MAGIC,
                                 checksum=framing.WIRE_CHECKSUM)
    assert payload is not None
    return framing.decode_payload(payload)


def _server_still_serves(server, fitted):
    with FleetClient(server.address) as cli:
        out = cli.call("kmeans", fitted["X"][:8], timeout=WAIT)
    assert np.array_equal(out, fitted["kmeans"].predict(fitted["X"][:8]))


# ---------------------------------------------------------------------------
# round trips over both transports
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shm", [True, False], ids=["shm", "tcp"])
def test_wire_round_trip_equal_to_direct(served, fitted, shm):
    _loop, server = served
    X = fitted["X"]
    with FleetClient(server.address, shm=shm) as cli:
        assert (cli._shm is not None) == shm
        assert cli.ping()
        for n in (1, 17, 64, 200):
            out = cli.call("kmeans", X[:n], timeout=WAIT)
            assert np.array_equal(out, fitted["kmeans"].predict(X[:n]))
            _gemm_close(cli.call("logistic", X[:n], method="predict_proba",
                                 timeout=WAIT),
                        fitted["logistic"].predict_proba(X[:n]))
            _gemm_close(cli.call("pca", X[:n], method="transform",
                                 timeout=WAIT),
                        fitted["pca"].transform(X[:n]))


def test_wire_server_fronts_a_fleet_with_request_ids(fitted):
    """A FleetServer fronting a ServingFleet hands the client's request id
    to the fleet (a client retry is the same request)."""
    fleet = ServingFleet(n_replicas=2, max_batch_rows=256).start()
    fleet.register("kmeans", fitted["kmeans"])
    seen = []
    submit = fleet.submit

    def spy(*args, **kw):
        seen.append(kw.get("request_id"))
        return submit(*args, **kw)

    fleet.submit = spy
    server = FleetServer(fleet).start()
    try:
        with FleetClient(server.address) as cli:
            out = cli.call("kmeans", fitted["X"][:9], timeout=WAIT)
        assert np.array_equal(out, fitted["kmeans"].predict(fitted["X"][:9]))
        assert len(seen) == 1 and seen[0].startswith(cli._rid_prefix)
    finally:
        server.stop()
        fleet.stop()


def test_wire_stats_carry_the_extra_stats(fitted):
    loop = ServingLoop(_registry(fitted), max_batch_rows=256).start()
    server = FleetServer(loop, extra_stats=lambda: {"replica": "x",
                                                    "launches": {}}).start()
    try:
        with FleetClient(server.address) as cli:
            cli.call("kmeans", fitted["X"][:4], timeout=WAIT)
            st = cli.stats()
        assert st["replica"] == "x" and st["n_requests"] == 1
        assert st["queue_depth"] == 0 and st["batches"] >= 1
        assert st["pid"] > 0
    finally:
        server.stop()
        loop.stop()


def test_wire_bytes_and_hash_seconds_mirrors(fitted):
    """``wire.bytes{transport=}`` counts the payload bytes each transport
    carried; ``wire.hash_seconds{algo=crc32c}`` observes every digest."""
    telemetry.reset_telemetry()
    try:
        with config_context(telemetry=True):
            loop = ServingLoop(_registry(fitted), max_batch_rows=256).start()
            server = FleetServer(loop).start()
            try:
                for shm in (True, False):
                    with FleetClient(server.address, shm=shm) as cli:
                        cli.call("kmeans", fitted["X"][:32], timeout=WAIT)
            finally:
                server.stop()
                loop.stop()
            snap = telemetry.metrics().snapshot()
        counters = snap["counters"]
        # the client's own sends (the scope is this thread's): the ring
        # hello on TCP, then the 32 x 8 f32 request on each transport
        assert counters["wire.bytes{transport=shm}"] > 32 * 8 * 4
        assert counters["wire.bytes{transport=tcp}"] > 32 * 8 * 4
        assert snap["histograms"]["wire.hash_seconds{algo=crc32c}"][
            "count"] >= 3
    finally:
        telemetry.reset_telemetry()


def test_wire_out_of_order_responses(fitted):
    """Responses return as futures resolve, tagged by id: one slow
    request never convoys the connection."""
    gate = _GateModel()
    fleet = ServingFleet(n_replicas=2, max_batch_rows=64).start()
    fleet.register("kmeans", fitted["kmeans"])
    fleet.registry.register("gate", gate)
    server = FleetServer(fleet).start()
    try:
        with FleetClient(server.address) as cli:
            slow = cli.submit("gate", np.zeros((4, 3), np.float32))
            deadline = time.monotonic() + 10.0
            while not any(r.loop.busy for r in fleet._replicas) \
                    and time.monotonic() < deadline:
                time.sleep(0.01)
            fast = cli.submit("kmeans", fitted["X"][:8])
            out = fast.result(WAIT)
            assert not slow.done()
            assert np.array_equal(out,
                                  fitted["kmeans"].predict(fitted["X"][:8]))
            gate.release.set()
            assert np.array_equal(slow.result(WAIT), np.zeros(4, np.float32))
    finally:
        gate.release.set()
        server.stop()
        fleet.stop()


# ---------------------------------------------------------------------------
# a bad request fails its frame; hostile bytes fail one connection
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shm", [True, False], ids=["shm", "tcp"])
def test_wire_validation_fails_caller_not_connection(served, fitted, shm):
    _loop, server = served
    X = fitted["X"]
    with FleetClient(server.address, shm=shm) as cli:
        with pytest.raises(ValueError):
            cli.call("kmeans", X[:4, :5], timeout=WAIT)  # bad width
        with pytest.raises(KeyError):
            cli.call("nosuch", X[:4], timeout=WAIT)
        with pytest.raises(DeadlineExceeded):
            cli.call("kmeans", X[:4], deadline=-1.0, timeout=WAIT)
        out = cli.call("kmeans", X[:8], timeout=WAIT)
        assert np.array_equal(out, fitted["kmeans"].predict(X[:8]))


def test_wire_huge_control_length_fails_frame_not_connection(served):
    import struct

    _loop, server = served
    sock = socket.create_connection(server.address, timeout=10)
    try:
        hostile = struct.pack(">I", (1 << 32) - 1) + b"junk"
        framing.write_frame(sock, hostile, magic=framing.WIRE_MAGIC,
                            checksum=framing.WIRE_CHECKSUM)
        msg, _ = _wire_response(sock)
        assert msg["ok"] is False
        framing.write_frame(
            sock, framing.encode_payload({"op": "ping", "id": "p1"}),
            magic=framing.WIRE_MAGIC, checksum=framing.WIRE_CHECKSUM)
        msg, _ = _wire_response(sock)
        assert msg["ok"] is True and msg["pid"] > 0
    finally:
        sock.close()


def test_wire_corrupt_frame_fails_caller_and_closes(served):
    _loop, server = served
    sock = socket.create_connection(server.address, timeout=10)
    try:
        good = framing.encode_frame(
            framing.encode_payload({"op": "ping", "id": "x"}),
            magic=framing.WIRE_MAGIC, checksum=framing.WIRE_CHECKSUM)
        bad = bytearray(good)
        bad[-1] ^= 0xFF
        sock.sendall(bytes(bad))
        msg, _ = _wire_response(sock)
        assert msg["ok"] is False and "Corrupt" in msg["error"]
        assert framing.read_frame(
            sock, magic=framing.WIRE_MAGIC,
            checksum=framing.WIRE_CHECKSUM) is None
    finally:
        sock.close()
    assert server.n_frame_errors == 1


def test_wire_fuzz_garbage_and_truncated_frames(served, fitted):
    """Garbage (a wrong magic) and a frame cut at every header offset
    tear that connection only; the accept loop keeps serving."""
    _loop, server = served
    for blob in (b"\x00" * 64, b"GET / HTTP/1.1\r\n\r\n",
                 b"DMLTWIRE1\n" + b"\x00" * 48):
        sock = socket.create_connection(server.address, timeout=10)
        try:
            sock.sendall(blob)
            sock.settimeout(10)
            try:
                msg, _ = _wire_response(sock)
                assert msg["ok"] is False
            except (ConnectionError, framing.FrameError):
                pass  # reset mid-response: the connection died
        finally:
            sock.close()
    frame = framing.encode_frame(
        framing.encode_payload({"op": "ping", "id": "t"}),
        magic=framing.WIRE_MAGIC, checksum=framing.WIRE_CHECKSUM)
    head = framing.header_length(framing.WIRE_MAGIC,
                                 checksum=framing.WIRE_CHECKSUM)
    for cut in list(range(1, head + 1)) + [head + 3, len(frame) - 1]:
        sock = socket.create_connection(server.address, timeout=10)
        try:
            sock.sendall(frame[:cut])
            sock.shutdown(socket.SHUT_WR)
            sock.settimeout(10)
            try:
                framing.read_frame(sock, magic=framing.WIRE_MAGIC,
                                   checksum=framing.WIRE_CHECKSUM)
            except (ConnectionError, framing.FrameError):
                pass
        finally:
            sock.close()
    _server_still_serves(server, fitted)


def test_wire_oversized_payload_rejected(fitted):
    loop = ServingLoop(_registry(fitted), max_batch_rows=256).start()
    server = FleetServer(loop, max_payload=1024).start()
    try:
        sock = socket.create_connection(server.address, timeout=10)
        try:
            sock.sendall(framing.encode_frame(
                b"x" * 4096, magic=framing.WIRE_MAGIC,
                checksum=framing.WIRE_CHECKSUM))
            msg, _ = _wire_response(sock)
            assert msg["ok"] is False and "Corrupt" in msg["error"]
        finally:
            sock.close()
        _server_still_serves(server, fitted)
    finally:
        server.stop()
        loop.stop()


def test_wire_fuzz_malformed_control_envelopes(served, fitted):
    import json

    _loop, server = served
    hostile = [
        b"",
        b"\x00\x00\x00\x05" + b"{}",
        framing.encode_payload({"op": "submit", "id": "a"}),  # no array
        b"\x00\x00\x00\x02" + b"[]",
        b"\x00\x00\x00\x04" + b"nope",
        framing.encode_payload({"op": "frobnicate", "id": "u"}),
        framing.encode_payload({"op": "submit", "id": 7, "model": "kmeans"},
                               [np.zeros((1, 8), np.float32)]),
    ]
    for dtype, shape, tail in (("object", [1], 8), ("float32", [1024, 1024],
                                                    16)):
        ctrl = json.dumps({"op": "submit", "id": "z", "model": "kmeans",
                           "arrays": [{"dtype": dtype, "shape": shape}]},
                          separators=(",", ":")).encode()
        hostile.append(len(ctrl).to_bytes(4, "big") + ctrl + b"\x00" * tail)
    sock = socket.create_connection(server.address, timeout=10)
    try:
        for payload in hostile:
            framing.write_frame(sock, payload, magic=framing.WIRE_MAGIC,
                                checksum=framing.WIRE_CHECKSUM)
            msg, _ = _wire_response(sock)
            assert msg["ok"] is False, payload[:40]
        framing.write_frame(
            sock, framing.encode_payload(
                {"op": "submit", "id": "ok", "model": "kmeans",
                 "method": "predict"}, arrays=(fitted["X"][:4],)),
            magic=framing.WIRE_MAGIC, checksum=framing.WIRE_CHECKSUM)
        msg, arrays = _wire_response(sock)
        assert msg["ok"] is True and msg["id"] == "ok"
        assert np.array_equal(arrays[0],
                              fitted["kmeans"].predict(fitted["X"][:4]))
    finally:
        sock.close()
    _server_still_serves(server, fitted)


class _StringModel:
    n_features_in_ = 8

    def predict(self, X):
        return np.array(["yes"] * len(X))


def test_wire_unencodable_response_fails_caller_not_writer(fitted):
    reg = _registry(fitted)
    reg.register("strings", _StringModel())
    loop = ServingLoop(reg, max_batch_rows=256).start()
    server = FleetServer(loop).start()
    try:
        with FleetClient(server.address) as cli:
            with pytest.raises(framing.PayloadError):
                cli.call("strings", fitted["X"][:4], timeout=WAIT)
            out = cli.call("kmeans", fitted["X"][:8], timeout=WAIT)
            assert np.array_equal(out,
                                  fitted["kmeans"].predict(fitted["X"][:8]))
    finally:
        server.stop()
        loop.stop()


def test_fleet_wire_is_pickle_free():
    import dask_ml_tpu_torch.parallel.fleet as fleet_mod

    assert "pickle" not in open(fleet_mod.__file__).read()


# ---------------------------------------------------------------------------
# client deadlines, reconnect, retries under a budget
# ---------------------------------------------------------------------------


def test_client_ping_and_call_timeout_typed(fitted):
    gate = _GateModel()
    reg = _registry(fitted)
    reg.register("gate", gate)
    with ServingLoop(reg, max_batch_rows=64) as lp:
        server = FleetServer(lp).start()
        try:
            with FleetClient(server.address) as cli:
                assert cli.ping(timeout=10.0)
                slow = cli.submit("gate", np.zeros((2, 3), np.float32))
                deadline = time.monotonic() + 10.0
                while not lp.busy and time.monotonic() < deadline:
                    time.sleep(0.01)
                with pytest.raises(FleetTimeoutError):
                    cli.call("kmeans", fitted["X"][:4], timeout=0.3)
                deadline = time.monotonic() + 5.0
                while cli.n_timeouts < 1 and time.monotonic() < deadline:
                    time.sleep(0.01)
                assert cli.n_timeouts == 1
                gate.release.set()
                slow.result(WAIT)
        finally:
            gate.release.set()
            server.stop()


def test_client_request_future_deadline(fitted):
    gate = _GateModel()
    reg = ModelRegistry()
    reg.register("gate", gate)
    with ServingLoop(reg, max_batch_rows=64) as lp:
        server = FleetServer(lp).start()
        try:
            with FleetClient(server.address) as cli:
                fut = cli.submit("gate", np.zeros((2, 3), np.float32),
                                 timeout=0.3)
                with pytest.raises(FleetTimeoutError):
                    fut.result(30)
        finally:
            gate.release.set()
            server.stop()


def test_client_reconnects_once_after_clean_close(served, fitted):
    _loop, server = served
    cli = FleetClient(server.address)
    try:
        assert cli.ping()
        for conn in list(server._conns):
            try:
                conn.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass
            conn.close()
        deadline = time.monotonic() + 10.0
        while not cli._clean_eof and time.monotonic() < deadline:
            time.sleep(0.01)
        out = cli.call("kmeans", fitted["X"][:8], timeout=WAIT)
        assert np.array_equal(out, fitted["kmeans"].predict(fitted["X"][:8]))
        assert cli.n_reconnects == 1
    finally:
        cli.close()


def test_retry_budget_token_accounting():
    rb = RetryBudget(ratio=0.5, initial=2.0, cap=3.0)
    assert rb.try_spend() and rb.try_spend()
    assert not rb.try_spend()
    assert rb.n_spent == 2 and rb.n_denied == 1
    for _ in range(20):
        rb.on_success()
    assert rb.tokens() == 3.0
    assert rb.try_spend()
    with pytest.raises(ValueError):
        RetryBudget(ratio=-0.1)


def test_client_default_budget_only_with_retries(served):
    _loop, server = served
    with FleetClient(server.address) as cli:
        assert cli.retry_budget is None
    with FleetClient(server.address, retries=2) as cli:
        assert isinstance(cli.retry_budget, RetryBudget)


def test_client_retry_recovers_after_timeout():
    gate = _GateModel()
    fleet = ServingFleet(n_replicas=1, max_batch_rows=8,
                         heartbeat_timeout_s=60.0).start()
    fleet.registry.register("gate", gate)
    server = FleetServer(fleet).start()
    budget = RetryBudget(ratio=0.5, initial=2.0)
    opener = threading.Timer(1.5, gate.release.set)
    try:
        with FleetClient(server.address, retries=2,
                         retry_budget=budget) as cli:
            opener.start()
            out = cli.call("gate", np.zeros((4, 3), np.float32), timeout=1.0)
            assert out.shape == (4,)
            assert cli.n_retries == 1
            assert budget.n_spent == 1
            assert budget.tokens() == pytest.approx(1.5)
    finally:
        opener.cancel()
        gate.release.set()
        server.stop()
        fleet.stop()


def test_retry_budget_exhausted_stops_the_storm():
    gate = _GateModel()
    fleet = ServingFleet(n_replicas=1, max_batch_rows=8,
                         heartbeat_timeout_s=60.0).start()
    fleet.registry.register("gate", gate)
    server = FleetServer(fleet).start()
    telemetry.reset_telemetry()
    try:
        with config_context(telemetry=True):
            budget = RetryBudget(ratio=0.0, initial=1.0)
            with FleetClient(server.address, retries=5,
                             retry_budget=budget) as cli:
                t0 = time.perf_counter()
                with pytest.raises(FleetTimeoutError):
                    cli.call("gate", np.zeros((4, 3), np.float32),
                             timeout=0.3)
                assert time.perf_counter() - t0 < 3.0
                assert cli.n_retries == 1
                assert cli.n_budget_exhausted == 1
                assert budget.n_denied == 1
            counters = telemetry.metrics().snapshot()["counters"]
        assert counters["fleet.retries"] == 1
        assert counters["fleet.retry_budget_exhausted"] == 1
    finally:
        gate.release.set()
        server.stop()
        fleet.stop()
        telemetry.reset_telemetry()


# ---------------------------------------------------------------------------
# parity: a JAX package client and a port client against one port server
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("shm", [True, False], ids=["shm", "tcp"])
def test_jax_and_port_clients_get_equal_answers(served, fitted, shm):
    """Both packages' clients, over the ring and over TCP, against one
    port server fronting a port ServingLoop on the CPU: the same arrays,
    the KMeans labels on integer-valued rows bit for bit (and equal to
    the direct predict), the GEMM runners' outputs within their bound."""
    from dask_ml_tpu.parallel.fleet import FleetClient as JaxFleetClient

    _loop, server = served
    Xi = fitted["Xi"]
    km = fitted["kmeans_int"]
    with JaxFleetClient(server.address, shm=shm) as jc, \
            FleetClient(server.address, shm=shm) as pc:
        assert (jc._shm is not None) == shm
        assert (pc._shm is not None) == shm
        for n in (1, 7, 64, 255, 256):
            j = jc.call("kmeans_int", Xi[:n], timeout=WAIT)
            p = pc.call("kmeans_int", Xi[:n], timeout=WAIT)
            assert j.dtype == p.dtype and np.array_equal(j, p)
            assert np.array_equal(p, km.predict(Xi[:n]))
            for name, method in (("logistic", "predict_proba"),
                                 ("pca", "transform"),
                                 ("kmeans", "predict")):
                jo = jc.call(name, fitted["X"][:n], method=method,
                             timeout=WAIT)
                po = pc.call(name, fitted["X"][:n], method=method,
                             timeout=WAIT)
                assert jo.dtype == po.dtype and jo.shape == po.shape
                _gemm_close(jo, po)
        assert jc.ping() and pc.ping()
        assert jc.stats()["pid"] == pc.stats()["pid"]


def test_jax_client_shm_segment_is_released(served):
    """A JAX package client's segment (its own prefix) is attached by the
    port server and unlinked when the client closes."""
    from dask_ml_tpu.parallel import shm as jax_shm
    from dask_ml_tpu.parallel.fleet import FleetClient as JaxFleetClient

    _loop, server = served
    before = server.n_shm_conns
    with JaxFleetClient(server.address) as jc:
        assert jc._shm is not None
        name = jc._shm.segment.lstrip("/")
        assert name.startswith(jax_shm.SEGMENT_PREFIX)
        assert jc.ping()
    assert server.n_shm_conns == before + 1
    assert name not in jax_shm.list_segments()
    assert name not in shm_lib.list_segments()

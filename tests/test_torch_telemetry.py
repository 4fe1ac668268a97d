"""The PyTorch port's telemetry (``parallel/telemetry.py``), its compile
counts (``parallel/shapes.py``) and ``utils/_log.py`` on the CPU: the
JAX package's telemetry scenarios, plus parity with the JAX package —
``Histogram.percentiles`` equal on the same samples (the window cap,
empty and single cases included) and ``telemetry_report()`` of the same
key structure for the same sequence of spans and metrics. The mirrors of
the streaming and elastic tiers (the JAX ``tests/test_telemetry.py``
cases): ``stream.*`` and the per-host ``stream.bytes{host=}`` equal the
source's own counters through a discard rollback, and the
``elastic.*`` counters equal the ``ElasticRun`` counters, silent with the
knob off.
"""

import json
import logging
import threading

import numpy as np
import pytest
import torch

from dask_ml_tpu import config as jconfig
from dask_ml_tpu.parallel import telemetry as jtelemetry
from dask_ml_tpu_torch import config
from dask_ml_tpu_torch._kernels import build
from dask_ml_tpu_torch.parallel import shapes, telemetry
from dask_ml_tpu_torch.utils import format_bytes, log_array, profile_phase


@pytest.fixture(autouse=True)
def _clean_telemetry():
    telemetry.reset_telemetry()
    jtelemetry.reset_telemetry()
    yield
    telemetry.reset_telemetry()
    jtelemetry.reset_telemetry()


# ---------------------------------------------------------------------------
# spans
# ---------------------------------------------------------------------------


def test_span_nesting_records_parent_child():
    with config.config_context(telemetry=True):
        with telemetry.span("outer", phase="fit") as so:
            with telemetry.span("inner", block=3) as si:
                assert si.parent_id == so.sid
    recs = telemetry.spans()
    assert [r["name"] for r in recs] == ["inner", "outer"]  # finish order
    inner, outer = recs
    assert inner["parent"] == outer["id"]
    assert inner["depth"] == 1 and outer["depth"] == 0
    assert outer["attrs"] == {"phase": "fit"}
    assert inner["attrs"] == {"block": 3}
    assert inner["dur"] <= outer["dur"]


def test_span_set_and_sync_attrs():
    with config.config_context(telemetry=True):
        with telemetry.span("phase") as sp:
            sp.set(n=128)
            tree = {"a": torch.ones(8) * 2, "b": [torch.zeros(2)]}
            assert sp.sync(tree) is tree
    [rec] = telemetry.spans()
    assert rec["attrs"]["n"] == 128
    assert rec["sync_seconds"] >= 0.0


def test_span_is_a_profiler_range():
    """A recorded span is also a torch.profiler range, named with its
    attributes."""
    with config.config_context(telemetry=True):
        with torch.profiler.profile() as prof:
            with telemetry.span("ranged", k=2):
                torch.ones(4).sum()
    names = {e.name for e in prof.events()}
    assert "ranged[k=2]" in names
    assert [r["name"] for r in telemetry.spans()] == ["ranged"]


def test_span_thread_isolation():
    barrier = threading.Barrier(2)
    config.set_config(telemetry=True)
    try:
        def work(tag):
            barrier.wait(30)
            with telemetry.span(f"outer-{tag}"):
                with telemetry.span(f"inner-{tag}"):
                    pass

        threads = [threading.Thread(target=work, args=(t,), name=f"w{t}")
                   for t in ("a", "b")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30)
    finally:
        config.set_config(telemetry=False)
    recs = {r["name"]: r for r in telemetry.spans()}
    assert set(recs) == {"outer-a", "inner-a", "outer-b", "inner-b"}
    for tag in ("a", "b"):
        assert recs[f"outer-{tag}"]["parent"] is None
        assert recs[f"inner-{tag}"]["parent"] == recs[f"outer-{tag}"]["id"]
        assert recs[f"inner-{tag}"]["tid"] == recs[f"outer-{tag}"]["tid"]
        assert recs[f"inner-{tag}"]["thread"] == f"w{tag}"
    assert recs["inner-a"]["tid"] != recs["inner-b"]["tid"]


def test_ring_buffer_bounded_and_drop_counted():
    telemetry.reset_telemetry(ring_capacity=4)
    with config.config_context(telemetry=True):
        for i in range(10):
            with telemetry.span("s", i=i):
                pass
        rep = telemetry.telemetry_report()
    assert rep["spans"]["n_recorded"] == 4
    assert rep["spans"]["n_dropped"] == 6
    assert rep["spans"]["ring_capacity"] == 4
    assert [r["attrs"]["i"] for r in telemetry.spans()] == [6, 7, 8, 9]
    with pytest.raises(ValueError, match="ring_capacity"):
        telemetry.reset_telemetry(ring_capacity=0)


def test_span_summary_aggregates():
    with config.config_context(telemetry=True):
        for _ in range(3):
            with telemetry.span("a"):
                pass
        with telemetry.span("b"):
            pass
    s = telemetry.span_summary()
    assert s["a"]["count"] == 3 and s["b"]["count"] == 1
    assert s["a"]["max_seconds"] <= s["a"]["total_seconds"]


# ---------------------------------------------------------------------------
# the disabled knob
# ---------------------------------------------------------------------------


def test_disabled_knob_leaves_no_telemetry_growth():
    assert config.get_config()["telemetry"] is False
    with telemetry.span("phase", a=1) as sp:
        sp.set(b=2)
        sp.sync(torch.zeros(3))
    telemetry.counter("c").inc(5)
    telemetry.gauge("g").set(1)
    telemetry.histogram("h").observe(2)
    assert telemetry.spans() == []
    assert telemetry.metrics().snapshot() == {
        "counters": {}, "gauges": {}, "histograms": {}}
    assert telemetry.counters() == {}


def test_disabled_span_and_metrics_are_shared_nulls():
    with telemetry.span("a") as s1:
        pass
    with telemetry.span("b", k=1) as s2:
        pass
    assert s1 is s2
    assert telemetry.counter("x") is telemetry.counter("y", l="z")
    assert telemetry.counter("x") is telemetry.gauge("x")
    assert telemetry.counter("x") is telemetry.histogram("x")


def test_counter_api_of_the_earlier_port():
    """counter(name) / counters() / reset_counters() / render_counters()
    keep working for the modules that called them before."""
    assert telemetry.render_counters() == \
        "telemetry counters: none recorded"
    with config.config_context(telemetry=True):
        telemetry.counter("search.cell_timeouts").inc()
        telemetry.counter("search.cell_timeouts").inc(2)
        telemetry.counter("serving.rows", model="m").inc(7)
        telemetry.gauge("g").set(3)
    assert telemetry.counters() == {"search.cell_timeouts": 3,
                                    "serving.rows{model=m}": 7}
    text = telemetry.render_counters()
    assert "search.cell_timeouts" in text and "3" in text
    telemetry.reset_counters()
    assert telemetry.counters() == {}
    assert telemetry.metrics().snapshot()["gauges"]["g"]["last"] == 3.0


# ---------------------------------------------------------------------------
# report and export
# ---------------------------------------------------------------------------


def _sequence(tel, cfg):
    """One sequence of spans and metrics through a telemetry module."""
    with cfg.config_context(telemetry=True):
        with tel.span("outer", phase="fit"):
            with tel.span("inner", block=1) as sp:
                sp.set(rows=8)
        tel.counter("demo.count").inc(2)
        tel.counter("serving.rows", model="m").inc(5)
        tel.gauge("serving.queue_depth").set(3)
        h = tel.histogram("serving.request_seconds", model="m")
        for v in (0.001, 0.002, 0.004):
            h.observe(v)
        return tel.telemetry_report()


def _keys(tree):
    """The nested key structure of a dict (leaves dropped)."""
    if isinstance(tree, dict):
        return {k: _keys(v) for k, v in tree.items()}
    return None


def test_report_key_structure_equals_jax():
    t = _sequence(telemetry, config)
    j = _sequence(jtelemetry, jconfig)
    for section in ("spans", "metrics"):
        assert _keys(t[section]) == _keys(j[section]), section
    assert set(t) == set(j)
    # the same values where both count the same thing
    assert t["metrics"]["counters"] == j["metrics"]["counters"]
    assert t["metrics"]["gauges"] == j["metrics"]["gauges"]
    for name, h in t["metrics"]["histograms"].items():
        jh = j["metrics"]["histograms"][name]
        for k in ("count", "min", "max", "buckets", "p50", "p90", "p99"):
            assert h[k] == jh[k], (name, k)
    assert {k: v["count"] for k, v in t["spans"]["by_name"].items()} == \
        {k: v["count"] for k, v in j["spans"]["by_name"].items()}
    # the compile section is the port's own: nvcc builds and loads
    assert set(t["compile"]) == {"n_compiles", "compile_seconds",
                                 "n_loads", "load_seconds"}


def test_report_round_trips_through_json():
    rep = _sequence(telemetry, config)
    assert json.loads(json.dumps(rep)) == rep
    assert rep["enabled"] is True  # read inside the enabled scope
    assert rep["spans"]["n_recorded"] == 2


def test_render_report_text():
    _sequence(telemetry, config)
    text = telemetry.render_report()
    assert "outer" in text and "demo.count" in text
    assert "p50=" in text and "p99=" in text
    assert "compile:" in text and "nvcc builds" in text


def test_export_chrome_trace_loads_in_perfetto_format(tmp_path):
    _sequence(telemetry, config)
    out = tmp_path / "trace.json"
    assert telemetry.export_chrome_trace(out) == str(out)
    events = json.load(open(out))["traceEvents"]
    xs = [e for e in events if e.get("ph") == "X"]
    assert len(xs) == 2
    for e in xs:
        assert {"name", "pid", "tid", "ts", "dur", "args"} <= set(e)
        assert e["dur"] >= 0
    ids = {e["args"]["span_id"] for e in xs}
    parents = {e["args"]["parent_span_id"] for e in xs
               if "parent_span_id" in e["args"]}
    assert parents and parents <= ids
    assert any(e.get("name") == "process_name" for e in events)
    assert any(e.get("name") == "thread_name" for e in events)


# ---------------------------------------------------------------------------
# histograms, held against the JAX package
# ---------------------------------------------------------------------------


def _percentiles(tel, cfg, samples, q):
    with cfg.config_context(telemetry=True):
        h = tel.metrics().histogram("pin")
        for v in samples:
            h.observe(float(v))
        return h.percentiles(q), h


def test_histogram_percentiles_pin_numpy_and_jax():
    samples = np.random.RandomState(0).lognormal(-5.0, 1.2, 1000)
    got, h = _percentiles(telemetry, config, samples, (50, 90, 99))
    want, _ = _percentiles(jtelemetry, jconfig, samples, (50, 90, 99))
    assert got == want
    for q in (50, 90, 99):
        np.testing.assert_allclose(got[f"p{q}"], np.percentile(samples, q),
                                   rtol=1e-12)
    rep = telemetry.telemetry_report()["metrics"]["histograms"]["pin"]
    assert rep["n_samples_retained"] == len(samples) == h.count


def test_histogram_percentiles_window_slides_at_cap():
    cap = telemetry.HISTOGRAM_SAMPLE_CAP
    assert cap == jtelemetry.HISTOGRAM_SAMPLE_CAP
    samples = np.arange(cap + 100, dtype=float)
    got, h = _percentiles(telemetry, config, samples, (0, 50, 100))
    want, _ = _percentiles(jtelemetry, jconfig, samples, (0, 50, 100))
    assert got == want
    assert h.count == cap + 100 and len(h.samples) == cap
    assert got["p0"] == 100.0 and got["p100"] == float(cap + 99)


@pytest.mark.parametrize("samples", [[], [3.25], [0.0, -1.0, 2.0]])
def test_histogram_percentiles_empty_single_and_buckets(samples):
    got, h = _percentiles(telemetry, config, samples, (50, 99))
    want, jh = _percentiles(jtelemetry, jconfig, samples, (50, 99))
    assert got == want
    assert h.buckets == jh.buckets
    if not samples:
        assert got == {"p50": None, "p99": None}


# ---------------------------------------------------------------------------
# the streaming and elastic mirrors
# ---------------------------------------------------------------------------


def _streamed_blocks(n=512, d=4, n_blocks=4, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    return X, np.ones(n, np.float32), n_blocks


def _consume(source):
    from dask_ml_tpu_torch.parallel.stream import prefetched_scan

    return prefetched_scan(
        lambda carry, b, blk: (carry + float(blk[0].sum()), None), 0.0,
        source)


def test_discard_inflight_rolls_mirrors_back():
    from dask_ml_tpu_torch.parallel.stream import HostBlockSource

    with config.config_context(device="cpu", telemetry=True):
        X, w, nb = _streamed_blocks()
        src = HostBlockSource((X, w), nb)
        src.start(0)
        src.start(1)
        src.take(0)
        src.discard_inflight()  # block 1 was issued, never consumed
        c = telemetry.metrics().snapshot()["counters"]
    assert c["stream.bytes_streamed"] == src.bytes_streamed
    assert c["stream.logical_bytes_streamed"] == src.logical_bytes_streamed
    assert c["stream.blocks_started"] == src.blocks_started == 1


def test_per_host_stream_bytes_mirror_and_rollback():
    """A source with ``host_rank`` adds its bytes to
    ``stream.bytes{host=}`` at the unlabelled counter's site, the discard
    rollback included."""
    from dask_ml_tpu_torch.parallel.stream import HostBlockSource

    with config.config_context(device="cpu", telemetry=True):
        X, w, nb = _streamed_blocks()
        src = HostBlockSource((X, w), nb, host_rank=3)
        _consume(src)
        c = telemetry.metrics().snapshot()["counters"]
        assert c["stream.bytes{host=3}"] == src.bytes_streamed
        src.start(0)
        src.discard_inflight()
        c = telemetry.metrics().snapshot()["counters"]
    assert c["stream.bytes{host=3}"] == src.bytes_streamed
    assert c["stream.bytes{host=3}"] == c["stream.bytes_streamed"]


def test_elastic_host_lost_and_rebalance_mirrors(tmp_path):
    import time

    from dask_ml_tpu_torch.parallel.elastic import BlockPlan, ElasticRun

    with config.config_context(device="cpu", telemetry=True):
        run = ElasticRun(tmp_path, rank=0, world=2, heartbeat_timeout=0.05,
                         poll_interval=0.01)
        plan = BlockPlan(4, seed=0)
        order = plan.epoch_order(0)
        owner = {b: r for r in (0, 1)
                 for b in BlockPlan.shard(order, r, [0, 1])}

        def compute_publish(blocks):
            for b in blocks:
                run.publish(0, b, np.arange(float(b), float(b) + 3))

        compute_publish([b for b in order if owner[b] == 0])
        time.sleep(0.1)  # host 1 never beat: its silence crosses the line
        results = run.collect_epoch(plan, 0, order, owner, compute_publish)
        c = telemetry.metrics().snapshot()["counters"]
        spans = {r["name"] for r in telemetry.spans()}
    assert set(results) == set(order)
    assert run.hosts_lost == 1 and run.blocks_rebalanced == 2
    assert c["elastic.host_lost"] == run.hosts_lost
    assert c["elastic.blocks_rebalanced"] == run.blocks_rebalanced
    assert "elastic.rebalance" in spans


def test_elastic_mirrors_silent_when_disabled(tmp_path):
    import time

    from dask_ml_tpu_torch.parallel.elastic import ElasticRun

    run = ElasticRun(tmp_path, rank=0, world=2, heartbeat_timeout=0.01,
                     poll_interval=0.01)
    time.sleep(0.05)
    assert run.lost_hosts() == {1}
    assert run.hosts_lost == 1
    assert telemetry.metrics().snapshot()["counters"] == {}


# ---------------------------------------------------------------------------
# compile counts: nvcc builds and library loads
# ---------------------------------------------------------------------------


def test_compile_stats_count_builds_and_loads(monkeypatch):
    """compile_stats / reset_compile_stats / track_compiles read
    ``_kernels.build.builds``: the nvcc builds and the library loads (a
    card's run moves them; here they are moved by hand)."""
    monkeypatch.setattr(build, "builds", dict(build.builds))
    shapes.reset_compile_stats()
    assert shapes.compile_stats() == {"n_compiles": 0,
                                      "compile_seconds": 0.0,
                                      "n_loads": 0, "load_seconds": 0.0}
    with shapes.track_compiles() as t:
        build.builds["nvcc"] += 2
        build.builds["nvcc_seconds"] += 3.5
        build.builds["loads"] += 1
        build.builds["load_seconds"] += 0.25
    assert t == {"n_compiles": 2, "compile_seconds": 3.5, "n_loads": 1,
                 "load_seconds": 0.25}
    assert shapes.compile_stats()["n_compiles"] == 2
    before = shapes.reset_compile_stats()
    assert before["n_loads"] == 1
    assert shapes.compile_stats()["n_loads"] == 0
    assert telemetry.telemetry_report()["compile"]["n_compiles"] == 0
    shapes.reset_compile_stats()


# ---------------------------------------------------------------------------
# utils/_log.py
# ---------------------------------------------------------------------------


def test_profile_phase_is_span_alias(caplog):
    logger = logging.getLogger("test_torch_pp_alias")
    with config.config_context(telemetry=True):
        with caplog.at_level(logging.DEBUG, logger="test_torch_pp_alias"):
            with profile_phase(logger, "alias-phase"):
                pass
    assert any("alias-phase" in r.getMessage() for r in caplog.records)
    assert [r["name"] for r in telemetry.spans()] == ["alias-phase"]


def test_profile_phase_captures_a_trace(tmp_path, monkeypatch, caplog):
    """With DASK_ML_TPU_PROFILE_DIR set, the outermost logged phase
    writes a torch.profiler Chrome trace there."""
    monkeypatch.setenv(telemetry.PROFILE_DIR_ENV, str(tmp_path))
    logger = logging.getLogger("test_torch_pp_trace")
    with caplog.at_level(logging.INFO, logger="test_torch_pp_trace"):
        with profile_phase(logger, "traced"):
            with profile_phase(logger, "nested"):
                torch.ones(3).sum()
    files = list(tmp_path.iterdir())
    assert len(files) == 1 and files[0].name.startswith("traced-")
    json.load(open(files[0]))
    assert any("trace ->" in r.getMessage() for r in caplog.records)


@pytest.mark.parametrize("dtype,want", [(torch.bfloat16, "32 B"),
                                        (torch.float32, "64 B"),
                                        (np.float64, "128 B")])
def test_log_array_itemsize(caplog, dtype, want):
    class FakeArr:
        shape = (4, 4)

    FakeArr.dtype = dtype
    logger = logging.getLogger("test_torch_log_bf16")
    with caplog.at_level(logging.INFO, logger="test_torch_log_bf16"):
        log_array(logger, "Xbf16", FakeArr())
    [rec] = caplog.records
    assert want in rec.getMessage() and "on host" in rec.getMessage()


def test_log_array_placement_and_sparse(caplog):
    import scipy.sparse as sp

    logger = logging.getLogger("test_torch_log_place")
    with caplog.at_level(logging.INFO, logger="test_torch_log_place"):
        log_array(logger, "t", torch.zeros(4, 4, dtype=torch.bfloat16))
        log_array(logger, "csr", sp.random(1000, 1000, density=0.001,
                                           format="csr", dtype=np.float32))
    a, b = [r.getMessage() for r in caplog.records]
    assert "32 B on cpu" in a
    assert "kB" in b and "MB" not in b  # nnz bytes, not the dense size
    assert format_bytes(1234) == "1.23 kB"
    assert format_bytes(5) == "5 B"
    assert format_bytes(2.5e9) == "2.50 GB"

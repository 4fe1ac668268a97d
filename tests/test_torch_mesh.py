"""The port's multi-device substrate (``parallel/mesh.py``,
``hierarchy.py``, ``runtime.py``, ``decisions.py``, the mesh staging of
``sharding.py`` and the ``mesh`` config knob) held against the JAX
package, on the CPU.

Layouts are compared in this process: a port mesh over ranks ``0..7``
without a process group describes the layout of the JAX mesh over the 8
virtual devices. The collectives run in one spawned gloo world of 4
processes (``file://`` store in ``tmp_path``, its own timeout), whose
ranks write their outputs to one ``.npz`` each; values are held against
numpy sums and the staged blocks against the shards of JAX ``prepare_data``
on the same mesh shape. The JAX package's model-axis collective test and
its two-process runtime test are red in its own suite (ROADMAP, reference
caveats), so neither is a reference here.
"""

import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import jax

from dask_ml_tpu import config as jconfig
from dask_ml_tpu.parallel import decisions as jdecisions
from dask_ml_tpu.parallel import hierarchy as jhier
from dask_ml_tpu.parallel import mesh as jmesh
from dask_ml_tpu.parallel import runtime as jruntime
from dask_ml_tpu.parallel.sharding import prepare_data as jprepare
from dask_ml_tpu_torch import config_context, set_config
from dask_ml_tpu_torch.parallel import decisions
from dask_ml_tpu_torch.parallel import hierarchy as hier
from dask_ml_tpu_torch.parallel import mesh as mesh_lib
from dask_ml_tpu_torch.parallel import runtime, telemetry
from dask_ml_tpu_torch.parallel.sharding import prepare_data

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EIGHT = range(8)
WORLD = 4
SPAWN_TIMEOUT = 180
#: staged in the world and by JAX: rows not a multiple of 4, 5 features
SN, SD = 1027, 5


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


# ---------------------------------------------------------------------------
# mesh construction, auto-factoring, errors (tests/test_hierarchy.py:57-92)
# ---------------------------------------------------------------------------

SHAPE_CASES = {
    "hier-2x4": (lambda h, m, d: h.make_hierarchical_mesh(2, 4, devices=d)),
    "hier-2": (lambda h, m, d: h.make_hierarchical_mesh(2, devices=d)),
    "hier-1": (lambda h, m, d: h.make_hierarchical_mesh(1, devices=d)),
    "hier-2x2x2": (lambda h, m, d: h.make_hierarchical_mesh(
        2, 2, devices=d, model_parallel=2)),
    "pod-chip-auto": (lambda h, m, d: m.make_mesh(
        devices=d, shape=(None, 2), axis_names=("pod", "chip"))),
    "flat": (lambda h, m, d: m.make_mesh(devices=d)),
    "flat-3": (lambda h, m, d: m.make_mesh(devices=d, n_devices=3)),
    "2d": (lambda h, m, d: m.make_2d_mesh(4, 2, devices=d)),
}


@pytest.mark.parametrize("case", sorted(SHAPE_CASES))
def test_mesh_shapes_and_helpers_match_jax(case):
    make = SHAPE_CASES[case]
    jm = make(jhier, jmesh, jax.devices())
    m = make(hier, mesh_lib, EIGHT)
    assert m.axis_names == jm.axis_names
    assert dict(m.shape) == dict(jm.shape)
    assert mesh_lib.is_hierarchical(m) == jmesh.is_hierarchical(jm)
    assert mesh_lib.data_axes(m) == jmesh.data_axes(jm)
    assert mesh_lib.n_data_shards(m) == jmesh.n_data_shards(jm)
    assert mesh_lib.n_model_shards(m) == jmesh.n_model_shards(jm)
    assert mesh_lib.has_model_axis(m) == jmesh.has_model_axis(jm)
    for ndim in (1, 2, 3):
        assert mesh_lib.data_pspec(m, ndim) == tuple(
            jmesh.data_pspec(jm, ndim))
        assert mesh_lib.feature_pspec(m, ndim) == tuple(
            jmesh.feature_pspec(jm, ndim))
    # ranks fill the grid as the JAX device list does (pod-major)
    ids = np.vectorize(lambda dev: dev.id)(jm.devices)
    assert np.array_equal(m.devices, ids)


ERROR_CASES = [
    (dict(axis_names=("pod", "chip")), r"needs a shape"),
    (dict(shape=(3, None), axis_names=("pod", "chip")), "auto-factor"),
    (dict(shape=(None, None), axis_names=("pod", "chip")), "more than one"),
    (dict(shape=(3, 2), axis_names=("pod", "chip")), "devices"),
    (dict(shape=(2, 2, 2), axis_names=("pod", "chip")), "entries"),
]


@pytest.mark.parametrize("kwargs,match", ERROR_CASES,
                         ids=[m for _, m in ERROR_CASES])
def test_make_mesh_errors_match_jax(kwargs, match):
    with pytest.raises(ValueError, match=match) as want:
        jmesh.make_mesh(devices=jax.devices(), **kwargs)
    with pytest.raises(ValueError, match=match) as got:
        mesh_lib.make_mesh(devices=EIGHT, **kwargs)
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["flat", "hier-2x4", "2d", "hier-2x2x2"])
def test_shard_layouts_match_jax_shardings(case):
    """Each rank's ShardLayout is the slice JAX's NamedSharding gives its
    device."""
    make = SHAPE_CASES[case]
    jm = make(jhier, jmesh, jax.devices())
    m = make(hier, mesh_lib, EIGHT)
    shape = (64, 16)
    for r in EIGHT:
        mr = mesh_lib.Mesh(m.devices, m.axis_names, rank=r)
        dev = jax.devices()[r]
        for got, want in (
                (mesh_lib.data_sharding(mr), jmesh.data_sharding(jm)),
                (mesh_lib.feature_sharding(mr) if mesh_lib.has_model_axis(m)
                 else None, jmesh.feature_sharding(jm)
                 if jmesh.has_model_axis(jm) else None)):
            if got is None:
                continue
            rows, cols = want.devices_indices_map(shape)[dev]
            assert got.rows(shape[0]) == slice(rows.start or 0,
                                               rows.stop or shape[0])
            assert got.cols(shape[1]) == slice(cols.start or 0,
                                               cols.stop or shape[1])
    assert mesh_lib.replicated_sharding(m).rows(8) == slice(0, 8)


def test_collective_bytes_match_jax():
    cases = {
        "flat": (jmesh.make_mesh(), mesh_lib.make_mesh(devices=EIGHT)),
        "2x4": (jhier.make_hierarchical_mesh(2, 4),
                hier.make_hierarchical_mesh(2, 4, devices=EIGHT)),
        "4x2": (jhier.make_hierarchical_mesh(4, 2),
                hier.make_hierarchical_mesh(4, 2, devices=EIGHT)),
        "1x8": (jhier.make_hierarchical_mesh(1, 8),
                hier.make_hierarchical_mesh(1, 8, devices=EIGHT)),
        "model": (jmesh.make_2d_mesh(4, 2),
                  mesh_lib.make_2d_mesh(4, 2, devices=EIGHT)),
        "2x2x2": (jhier.make_hierarchical_mesh(2, 2, model_parallel=2),
                  hier.make_hierarchical_mesh(2, 2, devices=EIGHT,
                                              model_parallel=2)),
    }
    for name, (jm, m) in cases.items():
        for b in (0, 4, 100, 4096):
            assert hier.collective_bytes(m, b) == \
                jhier.collective_bytes(jm, b), name
    assert hier.collective_bytes(cases["1x8"][1], 100) == {"chip": 700,
                                                           "pod": 0}


def test_record_helpers_match_jax_ledger():
    jm = jhier.make_hierarchical_mesh(2, 2, model_parallel=2)
    m = hier.make_hierarchical_mesh(2, 2, devices=EIGHT, model_parallel=2)
    jhier.reset_ledger()
    hier.reset_ledger()
    for mod, mm in ((jhier, jm), (hier, m)):
        mod.record_collective("a", mm, (3, 5), np.float32)
        for axis in ("chip", "pod", "model"):
            mod.record_axis_collective("b", mm, axis, 48)
        with mod.model_metered(mm):
            mod.record_model_collective("c", (7, 2), np.float32)
        mod.record_model_collective("d", (7, 2), np.float32)  # no scope
    assert hier.ledger_snapshot() == jhier.ledger_snapshot()
    jhier.reset_ledger()
    hier.reset_ledger()


def test_telemetry_mirror_equals_the_ledger():
    m = hier.make_hierarchical_mesh(2, 4, devices=EIGHT)
    hier.reset_ledger()
    telemetry.reset_telemetry()
    with config_context(telemetry=True):
        for _ in range(3):
            hier.record_collective("kmeans.mstep", m, (4, 5), torch.float32)
        hier.record_collective("fused.argmin_weight", m, (9,), torch.float32)
    snap = hier.ledger_snapshot()
    counters = telemetry.metrics().snapshot()["counters"]
    for axis, b in snap["bytes"].items():
        assert counters[f"collective.bytes{{axis={axis}}}"] == b
    for key, c in snap["calls"].items():
        axis, op = key.split("/", 1)
        assert counters[f"collective.calls{{axis={axis},op={op}}}"] == c
    assert snap["calls"]["chip/kmeans.mstep"] == 3
    telemetry.reset_telemetry()
    hier.reset_ledger()


def test_world_of_one_collectives_are_identities_with_zero_bytes():
    import torch.distributed as dist

    assert not dist.is_initialized()
    m = mesh_lib.default_mesh()
    assert m.size == 1 and not m.distributed and m.device is None
    x = torch.arange(6.0).reshape(3, 2)
    hier.reset_ledger()
    assert hier.hpsum(x, m, op="t") is x
    assert torch.equal(hier.hpmean(x, m, op="t"), x)
    assert torch.equal(hier.hpsum_scatter(x, m, op="t"), x)
    for fn in (hier.mpsum, hier.mpgather, hier.mpsum_scatter):
        assert fn(x, m) is x
    assert hier.gather_blocks(x, m, op="t") is x
    # no process group: nothing runs, and the ledger stays empty
    assert hier.ledger_snapshot() == {"bytes": {}, "calls": {}, "ops": {}}
    assert mesh_lib.collective_mesh() is None
    assert mesh_lib.collective_mesh(mesh_lib.make_mesh(devices=range(2)))\
        .size == 2
    hier.reset_ledger()
    # a layout of more ranks has no groups: its collectives refuse
    with pytest.raises(RuntimeError, match="process group"):
        hier.hpsum(x, mesh_lib.make_mesh(devices=range(2)))


def test_staging_outside_a_mesh_pads_nothing():
    X = np.arange(21.0, dtype=np.float32).reshape(7, 3)
    d = prepare_data(X)
    assert d.n == d.n_padded == 7 and d.row_offset == 0
    assert d.mesh is None
    assert torch.equal(d.X, torch.as_tensor(X))
    m = mesh_lib.default_mesh()
    d = prepare_data(X, mesh=m)
    assert d.mesh is m and d.n_padded == 7
    assert torch.equal(d.X, torch.as_tensor(X))


# ---------------------------------------------------------------------------
# runtime
# ---------------------------------------------------------------------------


def test_initialize_refuses_nccl_without_a_card(tmp_path):
    store = f"file://{tmp_path / 'store'}"
    with pytest.raises(ValueError, match="nccl.*CUDA"):
        runtime.initialize(backend="nccl", init_method=store,
                           num_processes=1, process_id=0)
    with config_context(device="cuda"):
        with pytest.raises(RuntimeError, match="nccl needs a CUDA card"):
            runtime.initialize(backend="nccl", init_method=store,
                               num_processes=1, process_id=0)
    for bad in (None, "mpi"):
        with pytest.raises(ValueError, match="backend='nccl' or 'gloo'"):
            runtime.initialize(backend=bad, init_method=store,
                               num_processes=1, process_id=0)
    with pytest.raises(ValueError, match="process_id"):
        runtime.initialize(backend="gloo", init_method=store)
    assert not runtime.is_initialized()


def test_process_info_resolution_order_matches_jax(monkeypatch):
    for mod in (runtime, jruntime):
        mod.set_process_info(None, None)
    monkeypatch.delenv("DASK_ML_TPU_PROCESS_ID", raising=False)
    monkeypatch.delenv("DASK_ML_TPU_NUM_PROCESSES", raising=False)
    steps = [("default", None), ("env", ("2", "5")),
             ("explicit", (1, 3)), ("cleared", None)]
    try:
        for name, arg in steps:
            if name == "env":
                monkeypatch.setenv("DASK_ML_TPU_PROCESS_ID", arg[0])
                monkeypatch.setenv("DASK_ML_TPU_NUM_PROCESSES", arg[1])
            for mod in (runtime, jruntime):
                if name == "explicit":
                    mod.set_process_info(*arg)
                if name == "cleared":
                    mod.set_process_info(None, None)
            assert (runtime.process_rank(), runtime.process_count()) == \
                (jruntime.process_rank(), jruntime.process_count()), name
        with pytest.raises(ValueError, match="out of range"):
            runtime.set_process_info(3, 3)
    finally:
        for mod in (runtime, jruntime):
            mod.set_process_info(None, None)


def test_process_rows_outside_a_world():
    assert runtime.process_rows(103) == jruntime.process_rows(103) == \
        (0, 103)


# ---------------------------------------------------------------------------
# decisions
# ---------------------------------------------------------------------------


@pytest.fixture
def both_caches(tmp_path, monkeypatch):
    path = tmp_path / "decisions.json"
    monkeypatch.setenv("DASK_ML_TPU_DECISIONS", str(path))
    decisions.reset_cache()
    jdecisions.reset_cache()
    yield path
    decisions.reset_cache()
    jdecisions.reset_cache()


def test_decisions_matches_and_committed_entries_match_jax():
    specs = [([4, 8], 4), ([4, 8], 6.5), ([4, 8], 9), ([4, 8, 12], 6),
             ("float32", "float32"), ("float32", "bfloat16"), (16, 16.0),
             (16, 17), ([4, 8], "x")]
    for spec, value in specs:
        assert decisions._matches(spec, value) == \
            jdecisions._matches(spec, value)
    decisions.reset_cache()
    jdecisions.reset_cache()
    assert decisions.entries() == jdecisions.entries()
    assert os.path.basename(decisions.cache_path()) == "_decisions.json"
    for e in jdecisions.entries():
        params = {k: (v[0] + v[1]) / 2 if isinstance(v, list) else v
                  for k, v in e["match"].items()}
        for fb in (True, False):
            # the JAX backend here is the CPU: the port's key is "cpu"
            assert decisions.lookup(e["rule"], params, fb,
                                    backend="cpu") == \
                jdecisions.lookup(e["rule"], params, fb)
            assert decisions.lookup(e["rule"], params, fb,
                                    backend="cuda") == fb


def test_decisions_record_save_reload_like_jax(both_caches):
    e = decisions.record("bench.rule", {"n": [512, 2048]}, True,
                         measured={"ms": 1.0})
    assert e["backend"] == "cpu"  # the configured device's type
    with config_context(device="cuda"):
        assert decisions.record("r2", {"k": 3}, False)["backend"] == "cuda"
    assert decisions.lookup("bench.rule", {"n": 1024}, False) is True
    assert decisions.save() == str(both_caches)
    jdecisions.reset_cache()
    assert jdecisions.entries() == decisions.entries()
    assert jdecisions.lookup("bench.rule", {"n": 1024}, False) is True
    both_caches.write_text("{not json")
    decisions.reset_cache()
    assert decisions.entries() == []


# ---------------------------------------------------------------------------
# the mesh config knob
# ---------------------------------------------------------------------------


def test_mesh_knob_scopes_and_refusals():
    m = mesh_lib.make_mesh(devices=range(1))
    with config_context(mesh=m):
        assert mesh_lib.default_mesh() is m
        with pytest.raises(ValueError, match="cannot clear"):
            with config_context(mesh=None):
                pass
    assert mesh_lib.default_mesh() is not m
    with config_context(mesh=None):  # no mesh set: a restatement
        pass
    with pytest.raises(ValueError, match="Mesh"):
        set_config(mesh="data")
    try:
        set_config(mesh=m)
        assert mesh_lib.default_mesh() is m
        with pytest.raises(ValueError, match="cannot clear"):
            with config_context(mesh=None):
                pass
    finally:
        set_config(mesh=None)
    with pytest.raises(ValueError, match="cannot clear"):
        with jconfig.config_context(mesh=None):
            pass


# ---------------------------------------------------------------------------
# a spawned world of 4: the collectives' values, the staging, the ledger
# ---------------------------------------------------------------------------

#: fits in a world of 4: the scaler and MiniBatchKMeans have no mesh path
#: (ROADMAP Queue A item 10b), so every rank stages the whole data and fits
#: the single-device model; the GLM and PCA fit over the default mesh
WHOLE_DATA_FITS = textwrap.dedent("""
    def whole_data_fits(X):
        import numpy as np
        from dask_ml_tpu_torch.cluster import MiniBatchKMeans
        from dask_ml_tpu_torch.decomposition import PCA
        from dask_ml_tpu_torch.linear_model import LogisticRegression
        from dask_ml_tpu_torch.preprocessing import StandardScaler

        y = (X[:, 0] + X[:, 1] > 0).astype(np.int64)
        glm = LogisticRegression(solver="lbfgs", max_iter=20).fit(X, y)
        mbk = MiniBatchKMeans(n_clusters=3, random_state=0, max_iter=5)
        pca = PCA(n_components=2, svd_solver="full").fit(X)
        return {
            "glm": np.asarray(glm.coef_),
            "pca": np.asarray(pca.transform(X)),
            "pca-variance": np.asarray(pca.explained_variance_),
            "scaler": np.asarray(StandardScaler().fit(X).transform(X)),
            "minibatch": np.asarray(mbk.fit(X).cluster_centers_)}
""")

WORKER = WHOLE_DATA_FITS + textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch

    torch.set_num_threads(1)
    rank, store, out = int(sys.argv[1]), sys.argv[2], sys.argv[3]
    from dask_ml_tpu_torch.config import set_config
    set_config(device="cpu")
    from dask_ml_tpu_torch.parallel import runtime
    runtime.initialize(backend="gloo", init_method="file://" + store,
                       num_processes=4, process_id=rank)
    runtime.initialize(backend="gloo")  # joined: a no-op
    from dask_ml_tpu_torch.parallel import hierarchy as hier
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    res, led = {}, {}
    res["process_rows"] = np.array(runtime.process_rows(10))
    res["rank_count"] = np.array([runtime.process_rank(),
                                  runtime.process_count()])
    dm = mesh_lib.default_mesh()
    res["default_shape"] = np.array(list(dm.shape.values()))
    meshes = {"flat": mesh_lib.make_mesh(),
              "hier": hier.make_hierarchical_mesh(2),
              "model": mesh_lib.make_2d_mesh(2, 2),
              "hier-model": hier.make_hierarchical_mesh(
                  1, 2, model_parallel=2)}
    # each rank's operand: (r + 1) * arange, so the sums are known
    x = (rank + 1) * torch.arange(8.0).reshape(4, 2)
    X = np.load(os.path.join(out, "X.npy"))
    w = np.load(os.path.join(out, "w.npy"))
    for name, m in meshes.items():
        hier.reset_ledger()
        res[name + "-coords"] = np.array([m.coord(a) for a in m.axis_names])
        res[name + "-hpsum"] = hier.hpsum(x, m, op="t.hpsum").numpy()
        res[name + "-hpmean"] = hier.hpmean(x, m, op="t.hpmean").numpy()
        res[name + "-scatter"] = hier.hpsum_scatter(
            x, m, op="t.scatter").numpy()
        res[name + "-mpsum"] = hier.mpsum(x, m, op="t.mpsum").numpy()
        res[name + "-mpgather"] = hier.mpgather(x, m, op="t.mpgather",
                                                axis=1).numpy()
        res[name + "-mpscatter"] = hier.mpsum_scatter(
            x, m, op="t.mpscatter").numpy()
        res[name + "-gather"] = hier.gather_blocks(
            torch.tensor([[rank, -0.0]]), m, op="t.gather").numpy()
        led[name] = hier.ledger_snapshot()
        d = prepare_data(X, sample_weight=w, mesh=m)
        res[name + "-X"] = d.X.numpy()
        res[name + "-w"] = d.weights.numpy()
        res[name + "-meta"] = np.array([d.n, d.n_padded, d.row_offset,
                                        d.col_offset])
        df = prepare_data(X, mesh=m, shard_features=True)
        res[name + "-Xf"] = df.X.numpy()
        res[name + "-fmeta"] = np.array([df.n_features, df.col_offset])
    hier.reset_ledger()
    for est, v in whole_data_fits(X).items():
        res["whole-" + est] = v
    led["whole"] = hier.ledger_snapshot()
    with mesh_lib.use_mesh(meshes["hier"]):
        res["whole-pca-hier"] = whole_data_fits(X)["pca"]
    np.savez(os.path.join(out, "rank%d.npz" % rank), **res)
    with open(os.path.join(out, "ledger%d.json" % rank), "w") as f:
        json.dump(led, f)
    runtime.shutdown()
    assert not runtime.is_initialized()
""")


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    out = tmp_path_factory.mktemp("world4")
    rng = np.random.RandomState(0)
    X = rng.randn(SN, SD).astype(np.float32)
    w = rng.rand(SN).astype(np.float32)
    np.save(out / "X.npy", X)
    np.save(out / "w.npy", w)
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(r), str(out / "store"), str(out)],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True) for r in range(WORLD)]
    errors = []
    for r, p in enumerate(procs):
        try:
            _, err = p.communicate(timeout=SPAWN_TIMEOUT)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail(f"the world of {WORLD} timed out (rank {r})")
        if p.returncode:
            errors.append(f"rank {r}: {err[-3000:]}")
    assert not errors, "\n".join(errors)
    ranks = [(dict(np.load(out / f"rank{r}.npz")),
              json.loads((out / f"ledger{r}.json").read_text()))
             for r in range(WORLD)]
    return X, w, ranks


MESHES = {"flat": lambda d: mesh_lib.make_mesh(devices=d),
          "hier": lambda d: hier.make_hierarchical_mesh(2, devices=d),
          "model": lambda d: mesh_lib.make_2d_mesh(2, 2, devices=d),
          "hier-model": lambda d: hier.make_hierarchical_mesh(
              1, 2, devices=d, model_parallel=2)}
JMESHES = {"flat": lambda d: jmesh.make_mesh(devices=d),
           "hier": lambda d: jhier.make_hierarchical_mesh(2, devices=d),
           "model": lambda d: jmesh.make_2d_mesh(2, 2, devices=d),
           "hier-model": lambda d: jhier.make_hierarchical_mesh(
               1, 2, devices=d, model_parallel=2)}


def _x(r):
    return (r + 1) * np.arange(8.0, dtype=np.float32).reshape(4, 2)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_collective_values_against_numpy(world4, name):
    _, _, ranks = world4
    m = MESHES[name](range(WORLD))
    data_groups, model_groups = {}, {}
    for r in range(WORLD):
        mr = mesh_lib.Mesh(m.devices, m.axis_names, rank=r)
        data_groups.setdefault(mesh_lib.model_index(mr), []).append(r)
        model_groups.setdefault(mesh_lib.data_index(mr), []).append(r)
    for r, (arrays, _) in enumerate(ranks):
        mr = mesh_lib.Mesh(m.devices, m.axis_names, rank=r)
        assert list(arrays[name + "-coords"]) == [mr.coords[a]
                                                  for a in m.axis_names]
        di, mi = mesh_lib.data_index(mr), mesh_lib.model_index(mr)
        total = sum(_x(q) for q in data_groups[mi])
        assert np.array_equal(arrays[name + "-hpsum"], total)
        assert np.array_equal(arrays[name + "-hpmean"],
                              total / mesh_lib.n_data_shards(m))
        split = (m.shape["chip"] if mesh_lib.is_hierarchical(m)
                 else m.shape["data"])
        step = 4 // split
        idx = mr.coords["chip" if mesh_lib.is_hierarchical(m) else "data"]
        assert np.array_equal(arrays[name + "-scatter"],
                              total[idx * step:(idx + 1) * step])
        mtotal = sum(_x(q) for q in model_groups[di])
        nm = mesh_lib.n_model_shards(m)
        if nm == 1:
            assert np.array_equal(arrays[name + "-mpsum"], _x(r))
            assert np.array_equal(arrays[name + "-mpgather"], _x(r))
            assert np.array_equal(arrays[name + "-mpscatter"], _x(r))
        else:
            assert np.array_equal(arrays[name + "-mpsum"], mtotal)
            assert np.array_equal(
                arrays[name + "-mpgather"],
                np.concatenate([_x(q) for q in model_groups[di]], axis=1))
            assert np.array_equal(arrays[name + "-mpscatter"],
                                  mtotal[mi * 2:(mi + 1) * 2])
        g = arrays[name + "-gather"]
        assert np.array_equal(g[:, 0], data_groups[mi])
        assert np.signbit(g[:, 1]).all()  # -0.0 comes through the sum


@pytest.mark.parametrize("name", sorted(MESHES))
def test_ledger_per_executed_call(world4, name):
    _, _, ranks = world4
    m = MESHES[name](range(WORLD))
    B = 4 * 2 * 4
    want_bytes = {}
    for op in ("t.hpsum", "t.hpmean", "t.scatter"):
        for ax, b in hier.collective_bytes(m, B).items():
            want_bytes[ax] = want_bytes.get(ax, 0) + b
    # the gather forwards s - 1 blocks of 2 f32 a group
    nd, nm = mesh_lib.n_data_shards(m), mesh_lib.n_model_shards(m)
    if mesh_lib.is_hierarchical(m):
        pods, cpp = m.shape["pod"], m.shape["chip"]
        want_bytes["chip"] += nm * pods * (cpp - 1) * 8
        want_bytes["pod"] += nm * (pods - 1) * cpp * 8
    else:
        want_bytes["data"] += nm * (nd - 1) * 8
    if nm > 1:
        want_bytes["model"] = 3 * (nm - 1) * B * nd
    for _, led in ranks:
        snap = led[name]
        assert snap["bytes"] == want_bytes
        for ax in hier.collective_bytes(m, B):
            assert snap["calls"][f"{ax}/t.hpsum"] == 1
        assert ("model/t.mpsum" in snap["calls"]) == (nm > 1)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_staged_blocks_match_jax_shards(world4, name):
    X, w, ranks = world4
    jm = JMESHES[name](jax.devices()[:WORLD])
    jd = jprepare(X, sample_weight=w, mesh=jm)
    jf = jprepare(X, mesh=jm, shard_features=True)
    for r, (arrays, _) in enumerate(ranks):
        dev = jax.devices()[r]
        jx = next(s for s in jd.X.addressable_shards if s.device == dev)
        jw = next(s for s in jd.weights.addressable_shards
                  if s.device == dev)
        jxf = next(s for s in jf.X.addressable_shards if s.device == dev)
        assert np.array_equal(arrays[name + "-X"], np.asarray(jx.data))
        assert np.array_equal(arrays[name + "-w"], np.asarray(jw.data))
        assert np.array_equal(arrays[name + "-Xf"], np.asarray(jxf.data))
        n, n_pad, off, c0 = arrays[name + "-meta"]
        assert (n, n_pad) == (SN, jd.n_padded)
        assert off == jx.index[0].start
        assert c0 == 0
        nf, fc0 = arrays[name + "-fmeta"]
        assert nf == SD and fc0 == (jxf.index[1].start or 0)


def test_the_world_itself(world4):
    _, _, ranks = world4
    for r, (arrays, _) in enumerate(ranks):
        base, rem = divmod(10, WORLD)
        start = r * base + min(r, rem)
        assert list(arrays["process_rows"]) == [
            start, start + base + (1 if r < rem else 0)]
        assert list(arrays["rank_count"]) == [r, WORLD]
        assert list(arrays["default_shape"]) == [WORLD]


def _pca_float64(X, k=2):
    """The 2-component PCA projection in float64 under the port's sign
    convention (the largest |v| entry of each component positive)."""
    Xc = X.astype(np.float64) - X.astype(np.float64).mean(0)
    Vt = np.linalg.svd(Xc, full_matrices=False)[2][:k]
    Vt *= np.sign(Vt[np.arange(k), np.argmax(np.abs(Vt), 1)])[:, None]
    return Xc @ Vt.T


#: the ledger ops of each estimator's fit in the world: the GLM and PCA
#: reduce over the default mesh, the scaler and MiniBatchKMeans nothing
WHOLE_DATA_OPS = {"glm": {"glm.sw", "glm.value", "glm.grad"},
                  "pca": {"pca.mean", "tsqr.gram", "tsqr.guard"},
                  "scaler": set(), "minibatch": set()}


@pytest.mark.parametrize("est", ["glm", "pca", "scaler", "minibatch"])
def test_estimators_without_a_mesh_path_fit_the_whole_data(world4, est):
    """A scaler and MiniBatchKMeans stage the whole data in a world of 4
    and give the single-device result on every rank. A GLM and PCA fit
    over the default mesh (under a configured hierarchical one too for
    PCA): each rank stages its block, the ledger shows their sums over
    the ranks, and every rank holds the single-device result."""
    X, _, ranks = world4
    ns = {}
    exec(WHOLE_DATA_FITS, ns)
    with config_context(device="cpu"):
        fits = ns["whole_data_fits"](X)
    want = fits[est]
    first = ranks[0][0]["whole-" + est]
    assert first.shape == want.shape
    if est == "pca":
        # the data's leading singular values lie within 1 % of each other,
        # so f32 rounding in another summation order turns the components
        # by ~1e-4 (one device and the mesh alike, against float64): the
        # mesh fit is held to the one-device fit's accuracy, and its
        # variances to the one-device ones
        np.testing.assert_allclose(ranks[0][0]["whole-pca-variance"],
                                   fits["pca-variance"], rtol=1e-5)
        ref = _pca_float64(X)
        assert np.abs(first - ref).max() <= \
            1.25 * np.abs(want - ref).max() + 1e-6
    else:
        np.testing.assert_allclose(first, want, rtol=1e-5, atol=1e-6)
    ops = set(ranks[0][1]["whole"]["ops"])
    assert WHOLE_DATA_OPS[est] <= ops
    for arrays, _ in ranks:
        assert np.array_equal(arrays["whole-" + est], first)
        if est == "pca":
            hier_fit = ranks[0][0]["whole-pca-hier"]
            assert np.array_equal(arrays["whole-pca-hier"], hier_fit)
            assert np.abs(hier_fit - ref).max() <= \
                1.25 * np.abs(want - ref).max() + 1e-6

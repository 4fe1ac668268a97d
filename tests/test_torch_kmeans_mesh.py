"""KMeans over a mesh of ranks (the port's ``torch.distributed`` worlds)
held against the JAX package's meshes, on the CPU.

Each world is spawned once for the module: ``N`` processes join one gloo
world through a ``file://`` store in ``tmp_path``, each runs every case of
:data:`WORKER` on its block of the same data, and writes one ``.npz`` a
rank. The JAX side runs here, on the matching slice of the 8 virtual
devices: ``make_mesh(n_devices=N)``, ``make_hierarchical_mesh(p, c,
devices=jax.devices()[:N])`` and a 2 × 2 ``make_2d_mesh``.

Data: blobs of 6,007 rows × 5 features, 4 centers, integer-valued (rounded)
and float, made with numpy from a seed. Staging runs with
``pad_policy=None`` so that the shards (2,003 rows at world 3, 1,502 at
world 4) are a multiple of no tile and no ``row_need`` group. Tolerances
and their reasons:

- integer-valued data: every cross-shard sum of the loops adds integers
  below 2**24, exactly, and IEEE division is correctly rounded, so the
  loops' centers and ``n_iter`` equal the JAX package's bit for bit, and a
  world-N fit equals the port's own world-1 fit bit for bit in centers,
  labels, ``n_iter`` and inertia (``compute_inertia`` sums the per-row
  costs in one order on every world). The loops' inertia is an f32 sum of
  6,007 non-integer costs in two orders (about sqrt(n)·eps apart): rtol
  1e-5;
- float data: rtol 1e-5 for centers and inertia, equal labels and
  ``n_iter``;
- the model-axis layout sums its scores over column slices: rtol 1e-5 and
  equal ``n_iter``;
- k-means|| draws from ``torch.Generator``, not ``jax.random``: a port fit
  is held to the JAX fit by the partition (ARI 1.0) and inertia within
  1e-4, as ``test_torch_kmeans.py`` holds it.

Reference paths that are red in the JAX package's own suite (ROADMAP,
reference caveats) are not used: ``argmin_min2`` is held against
``kernel="xla"``, and the port's hierarchical ``fused_argmin_weight``
against the JAX flat-mesh path.
"""

import json
import os
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dask_ml_tpu import config as jconfig
from dask_ml_tpu.cluster import KMeans as JKMeans
from dask_ml_tpu.models import kmeans as jcore
from dask_ml_tpu.ops.fused_distance import fused_argmin_weight as jfaw
from dask_ml_tpu.parallel import hierarchy as jhier
from dask_ml_tpu.parallel import mesh as jmesh
from dask_ml_tpu.parallel.sharding import prepare_data as jprepare
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.parallel import hierarchy as hier
from dask_ml_tpu_torch.parallel import mesh as mesh_lib

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N, D, K = 6007, 5, 4
MAX_ITER = 30
SPAWN_TIMEOUT = 180

#: (world, layout) pairs the worlds run; "model" is (data 2, model 2)
LAYOUTS = [(1, "flat"), (3, "flat"), (3, "hier"), (4, "flat"), (4, "hier"),
           (4, "model")]
ROW_LAYOUTS = [(w, lay) for w, lay in LAYOUTS if lay != "model"]

WORKER = textwrap.dedent("""
    import json, os, sys
    import numpy as np
    import torch

    torch.set_num_threads(1)
    world, rank, store, out = (int(sys.argv[1]), int(sys.argv[2]),
                               sys.argv[3], sys.argv[4])
    from dask_ml_tpu_torch.config import set_config
    set_config(device="cpu", pad_policy=None)
    from dask_ml_tpu_torch.parallel import runtime
    runtime.initialize(backend="gloo", init_method="file://" + store,
                       num_processes=world, process_id=rank)
    from dask_ml_tpu_torch.cluster import KMeans, MiniBatchKMeans
    from dask_ml_tpu_torch.models import kmeans as core
    from dask_ml_tpu_torch.ops.fused_distance import fused_argmin_weight
    from dask_ml_tpu_torch.parallel import hierarchy as hier
    from dask_ml_tpu_torch.parallel import mesh as mesh_lib
    from dask_ml_tpu_torch.parallel.sharding import prepare_data
    from dask_ml_tpu_torch.utils.validation import check_random_state

    data = np.load(os.path.join(out, "data.npz"))
    res, ledgers = {}, {}
    meshes = {"flat": mesh_lib.make_mesh()}
    if world > 1:
        meshes["hier"] = hier.make_hierarchical_mesh(
            2 if world % 2 == 0 else 1)
    if world == 4:
        meshes["model"] = mesh_lib.make_2d_mesh(2, 2)
    k = int(data["k"])
    for lay, m in meshes.items():
        for kind in ("int", "float"):
            X, c0, tol = data["X_" + kind], data["c0_" + kind], \\
                float(data["tol_" + kind])
            pre = f"{lay}-{kind}-"
            d = prepare_data(X, mesh=m)
            res[pre + "offset"] = np.array(d.row_offset)
            res[pre + "n_loc"] = np.array(d.X.shape[0])
            c0t = torch.as_tensor(c0)
            if lay == "model":
                df = prepare_data(X, mesh=m, shard_features=True)
                pad = df.X.shape[1] * 2 - X.shape[1]
                c0p = torch.cat([c0t, c0t.new_zeros((k, pad))], dim=1)
                c, inert, it, _ = core.lloyd_loop_fused(
                    df.X, df.weights, c0p, tol, max_iter=@MAX_ITER@,
                    mesh=m, shard_features=True)
                res[pre + "model_c"] = c.numpy()
                res[pre + "model_n"] = np.array(it)
                res[pre + "model_i"] = inert.numpy()
                try:
                    core.lloyd_loop_fused(df.X, df.weights, c0p, tol,
                                          max_iter=2, mesh=m,
                                          shard_features=True,
                                          kernel="cuda")
                except ValueError as e:
                    res["model_cuda_refused"] = np.array(
                        "compose" in str(e))
            hier.reset_ledger()
            c, inert, it, _ = core.lloyd_loop_fused(
                d.X, d.weights, c0t, tol, max_iter=@MAX_ITER@, mesh=m)
            ledgers[pre + "loopf"] = hier.ledger_snapshot()
            res[pre + "loopf_c"] = c.numpy()
            res[pre + "loopf_n"] = np.array(it)
            res[pre + "loopf_i"] = inert.numpy()
            hier.reset_ledger()
            c, inert, it, _, lab, st = core.lloyd_loop_bounded(
                d.X, d.weights, c0t, tol, max_iter=@MAX_ITER@, mesh=m)
            ledgers[pre + "loopb"] = hier.ledger_snapshot()
            res[pre + "loopb_c"] = c.numpy()
            res[pre + "loopb_n"] = np.array(it)
            res[pre + "loopb_i"] = inert.numpy()
            res[pre + "loopb_l"] = lab.numpy()
            res[pre + "loopb_skip"] = st["rows_skipped"].numpy()
            res[pre + "init"] = core.init_scalable(
                d.X, d.weights, d.n, k, check_random_state(0),
                mesh=m).numpy()
            for algo in ("full", "bounded", "auto"):
                hier.reset_ledger()
                with mesh_lib.use_mesh(m):
                    km = KMeans(n_clusters=k, random_state=0,
                                algorithm=algo).fit(X)
                    ledgers[pre + "fit-" + algo] = hier.ledger_snapshot()
                    res[pre + algo + "_p"] = km.predict(X)
                    res[pre + algo + "_s"] = np.array(km.score(X))
                res[pre + algo + "_c"] = km.cluster_centers_
                res[pre + algo + "_l"] = km.labels_
                res[pre + algo + "_n"] = np.array(km.n_iter_)
                res[pre + algo + "_i"] = np.array(km.inertia_)
        if lay != "model":
            Xf, w = data["X_float"], data["w"]
            d = prepare_data(Xf, sample_weight=w, mesh=m)
            hier.reset_ledger()
            idx, cw = fused_argmin_weight(d.X, d.weights,
                                          torch.as_tensor(data["Y"]),
                                          mesh=m)
            ledgers[lay + "-argmin_weight"] = hier.ledger_snapshot()
            res[lay + "-aw_idx"] = idx.numpy()
            res[lay + "-aw_cw"] = cw.numpy()
            d = prepare_data(data["X_int"], mesh=m)
            rep = core.measure_init_phases(d.X, d.weights, k,
                                           check_random_state(0), mesh=m,
                                           n_valid=d.n)
            ledgers[lay + "-phases"] = {
                "by_axis": rep.get("bytes_moved_by_axis"),
                "n_rounds": rep["n_rounds"]}
        refused = []
        with mesh_lib.use_mesh(m):
            res[lay + "-minibatch_c"] = MiniBatchKMeans(
                n_clusters=k, random_state=0).fit(
                    data["X_int"]).cluster_centers_
            for name, call in (
                    ("sketched", lambda: KMeans(
                        n_clusters=k, algorithm="sketched").fit(X)),
                    ("batched", lambda: core.batched_lloyd_cells(
                        prepare_data(X, mesh=m), [(k, 1e-4)], [],
                        max_iter=2))):
                try:
                    call()
                except NotImplementedError as e:
                    if "10b" in str(e):
                        refused.append(name)
        ledgers[lay + "-refused"] = refused
    np.savez(os.path.join(out, "rank%d.npz" % rank), **res)
    with open(os.path.join(out, "ledger%d.json" % rank), "w") as f:
        json.dump(ledgers, f)
    runtime.shutdown()
""").replace("@MAX_ITER@", str(MAX_ITER))


def _blobs(seed):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-10, 10, (K, D))
    y = rng.randint(0, K, N)
    return (centers[y] + 0.8 * rng.randn(N, D)).astype(np.float32), y


@pytest.fixture(scope="module")
def inputs():
    Xf, y = _blobs(3)
    Xi = np.rint(Xf).astype(np.float32)
    out = {"X_float": Xf, "X_int": Xi, "y": y, "k": np.array(K)}
    for kind, X in (("float", Xf), ("int", Xi)):
        # the init: K rows, one from each blob, the same for both packages
        rows = [int(np.flatnonzero(y == j)[0]) for j in range(K)]
        out["c0_" + kind] = X[rows]
        tol = jcore.scaled_tolerance(jnp.asarray(X), jnp.ones(N), 1e-4)
        out["tol_" + kind] = np.array(float(tol), np.float32)
    rng = np.random.RandomState(4)
    out["w"] = np.abs(rng.randn(N)).astype(np.float32)
    out["Y"] = Xf[rng.choice(N, 6, replace=False)]
    return out


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    """Every world spawned at once, each rank's outputs loaded: {world:
    [(arrays, ledgers) per rank]}."""
    procs = {}
    for world in sorted({w for w, _ in LAYOUTS}):
        out = tmp_path_factory.mktemp(f"world{world}")
        np.savez(out / "data.npz", **inputs)
        store = out / "store"
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
        procs[world] = (out, [
            subprocess.Popen(
                [sys.executable, "-c", WORKER, str(world), str(r),
                 str(store), str(out)],
                cwd=ROOT, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True)
            for r in range(world)])
    deadline = time.monotonic() + SPAWN_TIMEOUT
    results, errors = {}, []
    for world, (out, ps) in procs.items():
        for r, p in enumerate(ps):
            try:
                _, err = p.communicate(
                    timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                p.kill()
                _, err = p.communicate()
                errors.append(f"world {world} rank {r} timed out: {err}")
                continue
            if p.returncode:
                errors.append(f"world {world} rank {r}: {err[-3000:]}")
        if not errors:
            results[world] = [
                (dict(np.load(out / f"rank{r}.npz")),
                 json.loads((out / f"ledger{r}.json").read_text()))
                for r in range(len(ps))]
    assert not errors, "\n".join(errors)
    return results


def _jax_mesh(world, layout):
    devs = jax.devices()[:world]
    if layout == "flat":
        return jmesh.make_mesh(devices=devs)
    if layout == "hier":
        return jhier.make_hierarchical_mesh(2 if world % 2 == 0 else 1,
                                            devices=devs)
    return jmesh.make_2d_mesh(2, 2, devices=devs)


@pytest.fixture(scope="module")
def jax_loops(inputs):
    """The JAX package's loops on each matching mesh, kernel 'xla'."""
    out = {}
    with jconfig.config_context(pad_policy=None):
        for world, lay in LAYOUTS:
            jm = _jax_mesh(world, lay)
            for kind in ("int", "float"):
                X = inputs["X_" + kind]
                c0 = jnp.asarray(inputs["c0_" + kind])
                tol = jnp.asarray(inputs["tol_" + kind])
                if lay == "model":
                    data = jprepare(X, mesh=jm, shard_features=True)
                    c0p = jnp.pad(c0, ((0, 0), (0, data.X.shape[1] - D)))
                    out[(world, lay, kind, "model")] = jcore.lloyd_loop_fused(
                        data.X, data.weights, c0p, tol, mesh=jm,
                        max_iter=MAX_ITER, kernel="xla", shard_features=True)
                data = jprepare(X, mesh=jm)
                out[(world, lay, kind, "fused")] = jcore.lloyd_loop_fused(
                    data.X, data.weights, c0, tol, mesh=jm,
                    max_iter=MAX_ITER, kernel="xla")
                if lay != "model":
                    out[(world, lay, kind, "bounded")] = \
                        jcore.lloyd_loop_bounded(
                            data.X, data.weights, c0, tol, mesh=jm,
                            max_iter=MAX_ITER, kernel="xla")
    return out


@pytest.fixture(scope="module")
def single(inputs):
    """The port's own fits with no mesh, in this process."""
    out = {}
    with config_context(device="cpu"):
        for kind in ("int", "float"):
            for algo in ("full", "bounded", "auto"):
                km = KMeans(n_clusters=K, random_state=0,
                            algorithm=algo).fit(inputs["X_" + kind])
                out[(kind, algo)] = km
    return out


def _gathered(ranks, key, layout):
    """A per-row output gathered from the data shards' blocks in shard
    order (on the model layout the ranks of model shard 0)."""
    step = 2 if layout == "model" else 1
    parts = [ranks[r][0][key] for r in range(0, len(ranks), step)]
    return np.concatenate(parts)[:N]


# ---------------------------------------------------------------------------
# the loops against the JAX package's on the matching mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,layout", LAYOUTS,
                         ids=[f"w{w}-{lay}" for w, lay in LAYOUTS])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_lloyd_loop_fused_matches_jax(worlds, jax_loops, world, layout, kind):
    jc, ji, jn, _ = jax_loops[(world, layout, kind, "fused")]
    for arrays, _ in worlds[world]:
        pre = f"{layout}-{kind}-loopf_"
        assert int(arrays[pre + "n"]) == int(jn)
        if kind == "int":
            assert np.array_equal(arrays[pre + "c"], np.asarray(jc))
            np.testing.assert_allclose(arrays[pre + "i"], float(ji),
                                       rtol=1e-5)
        else:
            np.testing.assert_allclose(arrays[pre + "c"], np.asarray(jc),
                                       rtol=1e-5, atol=1e-5)
            np.testing.assert_allclose(arrays[pre + "i"], float(ji),
                                       rtol=1e-5)


@pytest.mark.parametrize("world,layout", ROW_LAYOUTS,
                         ids=[f"w{w}-{lay}" for w, lay in ROW_LAYOUTS])
@pytest.mark.parametrize("kind", ["int", "float"])
def test_lloyd_loop_bounded_matches_jax(worlds, jax_loops, world, layout,
                                        kind):
    jc, ji, jn, _, jl, jst = jax_loops[(world, layout, kind, "bounded")]
    ranks = worlds[world]
    pre = f"{layout}-{kind}-loopb_"
    labels = _gathered(ranks, pre + "l", layout)
    assert np.array_equal(labels, np.asarray(jl)[:N])
    skip = np.asarray(jst["rows_skipped"])
    for arrays, _ in ranks:
        assert int(arrays[pre + "n"]) == int(jn)
        assert np.array_equal(arrays[pre + "skip"], skip)
        if kind == "int":
            assert np.array_equal(arrays[pre + "c"], np.asarray(jc))
            np.testing.assert_allclose(arrays[pre + "i"], float(ji),
                                       rtol=1e-5)
        else:
            np.testing.assert_allclose(arrays[pre + "c"], np.asarray(jc),
                                       rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kind", ["int", "float"])
def test_model_axis_loop_matches_jax(worlds, jax_loops, kind):
    jc, ji, jn, _ = jax_loops[(4, "model", kind, "model")]
    for arrays, _ in worlds[4]:
        pre = f"model-{kind}-model_"
        assert int(arrays[pre + "n"]) == int(jn)
        np.testing.assert_allclose(arrays[pre + "c"], np.asarray(jc),
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(arrays[pre + "i"], float(ji), rtol=1e-5)
        assert not arrays[pre + "c"][:, D:].any()  # the padding column
    assert bool(worlds[4][0][0]["model_cuda_refused"])


# ---------------------------------------------------------------------------
# fits: world N against world 1, and against the JAX fit
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("world,layout", LAYOUTS,
                         ids=[f"w{w}-{lay}" for w, lay in LAYOUTS])
@pytest.mark.parametrize("algo", ["full", "bounded", "auto"])
def test_fit_equals_the_single_device_fit_on_integers(worlds, single, world,
                                                      layout, algo):
    ref = single[("int", algo)]
    for arrays, _ in worlds[world]:
        pre = f"{layout}-int-{algo}_"
        assert np.array_equal(arrays[pre + "c"], ref.cluster_centers_)
        assert np.array_equal(arrays[pre + "l"], ref.labels_)
        assert np.array_equal(arrays[pre + "p"], ref.labels_)
        assert int(arrays[pre + "n"]) == ref.n_iter_
        assert float(arrays[pre + "i"]) == ref.inertia_
        assert float(arrays[pre + "s"]) == -ref.inertia_


@pytest.mark.parametrize("world,layout", LAYOUTS,
                         ids=[f"w{w}-{lay}" for w, lay in LAYOUTS])
@pytest.mark.parametrize("algo", ["full", "bounded"])
def test_fit_on_floats_close_to_single_device(worlds, single, world, layout,
                                              algo):
    ref = single[("float", algo)]
    for arrays, _ in worlds[world]:
        pre = f"{layout}-float-{algo}_"
        assert np.array_equal(arrays[pre + "l"], ref.labels_)
        assert int(arrays[pre + "n"]) == ref.n_iter_
        np.testing.assert_allclose(arrays[pre + "c"], ref.cluster_centers_,
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(float(arrays[pre + "i"]), ref.inertia_,
                                   rtol=1e-5)


@pytest.mark.parametrize("world", [3, 4])
def test_fit_against_the_jax_fit(worlds, inputs, world):
    from sklearn.metrics import adjusted_rand_score

    ref = JKMeans(n_clusters=K, random_state=0).fit(inputs["X_float"])
    arrays = worlds[world][0][0]
    assert adjusted_rand_score(inputs["y"], arrays["flat-float-full_l"]) \
        == 1.0
    assert adjusted_rand_score(ref.labels_, arrays["flat-float-full_l"]) \
        == 1.0
    np.testing.assert_allclose(float(arrays["flat-float-full_i"]),
                               ref.inertia_, rtol=1e-4)


@pytest.mark.parametrize("world,layout", LAYOUTS,
                         ids=[f"w{w}-{lay}" for w, lay in LAYOUTS])
def test_init_scalable_does_not_depend_on_the_world(worlds, world, layout):
    want = worlds[1][0][0]["flat-int-init"]
    for arrays, _ in worlds[world]:
        assert np.array_equal(arrays[f"{layout}-int-init"], want)
        assert arrays[f"{layout}-float-init"].shape == (K, D)


def test_world_of_one_runs_like_no_mesh_with_zero_bytes(worlds):
    (arrays, ledgers), = worlds[1]
    for key, snap in ledgers.items():
        if isinstance(snap, dict) and "bytes" in snap:
            assert set(snap["bytes"].values()) <= {0}, key
    assert ledgers["flat-int-fit-full"]["calls"]["data/kmeans.mstep"] == \
        3 * int(arrays["flat-int-full_n"])


def test_every_rank_holds_the_same_fit(worlds):
    for world, ranks in worlds.items():
        for key, v in ranks[0][0].items():
            if key.endswith(("_c", "_n", "_i", "_p", "_s", "init")) \
                    and "offset" not in key:
                for arrays, _ in ranks[1:]:
                    assert np.array_equal(arrays[key], v), (world, key)


def test_blocks_are_the_padded_shards(worlds):
    for world, ranks in worlds.items():
        n_pad = -(-N // world) * world  # pad_policy=None: exact multiple
        for r, (arrays, _) in enumerate(ranks):
            assert int(arrays["flat-int-n_loc"]) == n_pad // world
            assert int(arrays["flat-int-offset"]) == r * (n_pad // world)
    assert int(worlds[3][0][0]["flat-int-n_loc"]) == 2003
    assert int(worlds[4][0][0]["flat-int-n_loc"]) == 1502


# ---------------------------------------------------------------------------
# the traffic ledger
# ---------------------------------------------------------------------------


def _layout_mesh(world, layout):
    devs = range(world)
    if layout == "flat":
        return mesh_lib.make_mesh(devices=devs)
    if layout == "hier":
        return hier.make_hierarchical_mesh(2 if world % 2 == 0 else 1,
                                           devices=devs)
    return mesh_lib.make_2d_mesh(2, 2, devices=devs)


@pytest.mark.parametrize("world,layout", LAYOUTS,
                         ids=[f"w{w}-{lay}" for w, lay in LAYOUTS])
def test_ledger_mstep_is_the_jax_pin_times_the_iterations(worlds, world,
                                                          layout):
    m = _layout_mesh(world, layout)
    for arrays, ledgers in worlds[world]:
        for name, key, operands, n_calls in (
                ("loopf", "loopf", K * D + K + 1, 3),
                ("fit-full", "full", K * D + K + 1, 3),
                ("loopb", "loopb", K * D + K, 2),
                ("fit-bounded", "bounded", K * D + K, 2)):
            snap = ledgers[f"{layout}-int-{name}"]
            n_iter = int(arrays[f"{layout}-int-{key}_n"])
            want = {ax: b * n_iter for ax, b in
                    hier.collective_bytes(m, operands * 4).items()}
            assert snap["ops"]["kmeans.mstep"] == want, name
            for ax in want:
                assert snap["calls"][f"{ax}/kmeans.mstep"] == \
                    n_calls * n_iter
    if layout == "hier" and world == 3:  # the degenerate 1 x 3 pod stage
        assert worlds[3][0][1]["hier-int-loopf"]["ops"]["kmeans.mstep"][
            "pod"] == 0


def test_ledger_collective_bytes_match_jax():
    for world, layout in LAYOUTS:
        jm, m = _jax_mesh(world, layout), _layout_mesh(world, layout)
        for nbytes in (4, 100, (K * D + K + 1) * 4):
            assert hier.collective_bytes(m, nbytes) == \
                jhier.collective_bytes(jm, nbytes)


def test_argmin_weight_hierarchical_against_the_jax_flat_path(worlds,
                                                              inputs):
    jm = jmesh.make_mesh(n_devices=4)
    with jconfig.config_context(pad_policy=None), jmesh.use_mesh(jm):
        dj = jprepare(inputs["X_float"], sample_weight=inputs["w"])
        i_f, cw_f = jfaw(dj.X, dj.weights, jnp.asarray(inputs["Y"]),
                         kernel="xla", mesh=jm)
    ranks = worlds[4]
    idx = _gathered(ranks, "hier-aw_idx", "hier")
    assert np.array_equal(idx, np.asarray(i_f)[:N])
    m = _layout_mesh(4, "hier")
    for arrays, ledgers in ranks:
        np.testing.assert_allclose(arrays["hier-aw_cw"], np.asarray(cw_f),
                                   rtol=2e-5, atol=1e-5)
        assert ledgers["hier-argmin_weight"]["ops"][
            "fused.argmin_weight"] == hier.collective_bytes(m, 6 * 4)


def test_measure_init_phases_by_axis_against_jax(worlds):
    from dask_ml_tpu.models.kmeans import _init_phase_collective_traffic

    cfg = jcore._init_scalable_config(N, K, 2.0, None)
    for world in (3, 4):
        ledgers = worlds[world][0][1]
        rep = ledgers["hier-phases"]
        jm = _jax_mesh(world, "hier")
        want = _init_phase_collective_traffic(
            jm, D, n_rounds=rep["n_rounds"], cap=cfg["cap"],
            max_cand=cfg["max_cand"])
        assert rep["by_axis"] == want
        assert ledgers["flat-phases"]["by_axis"] is None


def test_refusals_name_item_10b(worlds):
    """Nothing refuses any more: the sketched fit and the batched groups,
    which raised naming Queue A item 10b over more than one rank, run over
    the mesh."""
    for world in (1, 3, 4):
        for layout in ("flat", "hier") if world > 1 else ("flat",):
            assert worlds[world][0][1][f"{layout}-refused"] == []


@pytest.mark.parametrize("world,layout", ROW_LAYOUTS)
def test_minibatch_fits_the_whole_data_on_every_rank(worlds, world, layout):
    """MiniBatchKMeans runs over the mesh (each rank its block, one sum a
    step); on integer-valued data every rank fits the world-1 model bit
    for bit, as it did when it staged the whole data on every rank."""
    want = worlds[1][0][0]["flat-minibatch_c"]
    for arrays, _ in worlds[world]:
        assert np.array_equal(arrays[layout + "-minibatch_c"], want)

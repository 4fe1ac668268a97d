"""The search over a mesh of ranks: the batched KMeans and GLM groups,
the block-wise splits and the planned buckets, on the CPU.

Worlds of 1, 3 and 4 gloo ranks (flat, and two pods of two at world 4)
run, on each layout: ``ShuffleSplit`` with ``n_blocks=None``;
``models.kmeans.batched_lloyd_cells`` on blobs staged over the mesh, from
the JAX package's init draw (``idx0``), on integer-valued and on float
data; and ``GridSearchCV`` over ``KMeans(init="random")`` on integer data
and over L-BFGS ``LogisticRegression`` / ``LinearRegression`` C grids, whose
groups now stage each rank's block and sum over the ranks. The JAX package
runs the same on the matching virtual mesh (``pad_policy=None`` in both).
Tolerances and their reasons:

- splits and buckets are host integer work: ``n_blocks=None`` is the
  mesh's data-shard count in both packages, index for index, and
  ``shape_buckets_`` the same sizes;
- ``batched_lloyd_cells`` on integer data: every cross-rank sum of the
  trajectories' centers adds integers below 2**24 and each eval set's
  costs are gathered and summed in the one order of a single device, so
  a world of ranks gives the world-1 ``n_iter`` and eval inertias bit for
  bit; the train inertia is an f32 sum of non-integer costs in another
  order (the loops' inertia of ``test_torch_kmeans_mesh.py``): rtol 1e-5;
  on floats the same ``n_iter`` and rtol 1e-5; against the JAX
  package (other summation orders) the same ``n_iter`` and rtol 1e-5, as
  ``test_torch_search.py`` holds one device; the ledger's
  ``kmeans.batched`` is one ``hpsum`` a step of every trajectory's
  operands: the formula times ``max_iter``;
- the KMeans grid on integer data: every member's scores equal the
  world-1 search's bit for bit, the same ``best_params_``, every cell
  batched;
- the GLM grids: scores within rtol 1e-4 of the JAX search's on the
  matching mesh (L-BFGS in two frameworks, as in
  ``test_torch_search.py``) and of the world-1 search's, the same ranks
  and ``best_params_``, every cell batched.
"""

import numpy as np
import pytest

import torch_worlds

N, D, K = 601, 6, 4
MEMBERS = [(2, 1e-6), (3, 1e-3), (5, 1e-6), (5, 1e-1)]
MAX_ITER = 8
KM_GRID = {"n_clusters": [2, 3, 4], "tol": [1e-4, 1e-1]}
C_GRID = {"C": [0.05, 1.0, 20.0]}

BODY = """
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.linear_model import LinearRegression, LogisticRegression
from dask_ml_tpu_torch.model_selection import GridSearchCV, KFold, ShuffleSplit
from dask_ml_tpu_torch.models import kmeans as core
from dask_ml_tpu_torch.parallel.sharding import prepare_data

MEMBERS = @MEMBERS@
for lay, m in layouts(world).items():
    with mesh_lib.use_mesh(m):
        sp = list(ShuffleSplit(n_splits=2, test_size=0.25,
                               random_state=0).split(data["Xf"]))
        res[lay + "-split-train"] = np.concatenate([tr for tr, _ in sp])
        res[lay + "-split-test"] = np.concatenate([te for _, te in sp])
    for kind in ("int", "float"):
        X = data["X" + kind[0]]
        hier.reset_ledger()
        n_it, train, evals = core.batched_lloyd_cells(
            prepare_data(X[:400], mesh=m), MEMBERS,
            [prepare_data(X[400:], mesh=m)], max_iter=@MAX_ITER@,
            idx0=data["idx0"])
        info[f"{lay}-{kind}-ledger"] = hier.ledger_snapshot()
        res[f"{lay}-{kind}-n"] = n_it.numpy()
        res[f"{lay}-{kind}-train"] = train.numpy()
        res[f"{lay}-{kind}-eval"] = evals[0].numpy()
    with mesh_lib.use_mesh(m):
        gs = GridSearchCV(KMeans(init="random", max_iter=10,
                                 random_state=0), @KM_GRID@,
                          cv=KFold(3), n_jobs=2).fit(data["Xi"])
        res[lay + "-km-scores"] = gs.cv_results_["mean_test_score"]
        res[lay + "-km-split0"] = gs.cv_results_["split0_test_score"]
        info[lay + "-km-best"] = gs.best_params_
        info[lay + "-km-batched"] = gs.n_batched_cells_
        info[lay + "-buckets"] = [int(b) for b in gs.shape_buckets_]
        for name, est, y in (
                ("lr", LogisticRegression(solver="lbfgs", max_iter=50),
                 data["yc"]),
                ("lin", LinearRegression(solver="lbfgs", max_iter=50),
                 data["yr"])):
            gs = GridSearchCV(est, @C_GRID@, cv=3, n_jobs=2).fit(
                data["Xc"], y)
            res[f"{lay}-{name}-scores"] = gs.cv_results_["mean_test_score"]
            res[f"{lay}-{name}-rank"] = gs.cv_results_["rank_test_score"]
            info[f"{lay}-{name}-best"] = gs.best_params_
            info[f"{lay}-{name}-batched"] = gs.n_batched_cells_
""".replace("@MEMBERS@", repr(MEMBERS)).replace(
    "@MAX_ITER@", str(MAX_ITER)).replace("@KM_GRID@", repr(KM_GRID)).replace(
    "@C_GRID@", repr(C_GRID))

CASES = torch_worlds.cases()


def _blobs(n, d, k, seed):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-8, 8, (k, d))
    return (centers[rng.randint(0, k, n)]
            + 0.5 * rng.randn(n, d)).astype(np.float32)


@pytest.fixture(scope="module")
def inputs():
    import jax

    Xf = _blobs(N, D, K, 3)
    rng = np.random.RandomState(12)
    Xc = rng.randn(301, 8).astype(np.float32)
    yc = (Xc[:, :3].sum(1) + 0.7 * rng.randn(301) > 0).astype(np.int64)
    yr = (Xc @ rng.randn(8) + 0.3 * rng.randn(301)).astype(np.float32)
    key = jax.random.PRNGKey(4)
    idx0 = np.asarray(jax.random.permutation(key, 400))[
        :max(k for k, _ in MEMBERS)]
    return {"Xf": Xf, "Xi": np.rint(Xf), "Xc": Xc, "yc": yc, "yr": yr,
            "idx0": idx0.astype(np.int64)}


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    return torch_worlds.spawn_worlds(BODY, inputs, tmp_path_factory)


@pytest.fixture(scope="module")
def jax_runs(inputs):
    import jax

    from dask_ml_tpu import config as jconfig
    from dask_ml_tpu.linear_model import LinearRegression as JLin
    from dask_ml_tpu.linear_model import LogisticRegression as JLog
    from dask_ml_tpu.model_selection import GridSearchCV as JGrid
    from dask_ml_tpu.model_selection import ShuffleSplit as JShuffle
    from dask_ml_tpu.models import kmeans as jkm
    from dask_ml_tpu.parallel import mesh as jmesh
    from dask_ml_tpu.parallel.sharding import prepare_data as jprepare

    out = {}
    with jconfig.config_context(pad_policy=None):
        for world, layout in CASES:
            jm = torch_worlds.jax_mesh(world, layout)
            got = {}
            with jmesh.use_mesh(jm):
                sp = list(JShuffle(n_splits=2, test_size=0.25,
                                   random_state=0).split(inputs["Xf"]))
                got["split-train"] = np.concatenate([tr for tr, _ in sp])
                got["split-test"] = np.concatenate([te for _, te in sp])
                for kind in ("int", "float"):
                    X = inputs["X" + kind[0]]
                    n_it, train, evals = jkm.batched_lloyd_cells(
                        jprepare(X[:400], mesh=jm), MEMBERS,
                        [jprepare(X[400:], mesh=jm)], max_iter=MAX_ITER,
                        key=jax.random.PRNGKey(4))
                    got[f"{kind}-n"] = np.asarray(n_it)
                    got[f"{kind}-train"] = np.asarray(train)
                    got[f"{kind}-eval"] = np.asarray(evals[0])
                for name, est, y in (
                        ("lr", JLog(solver="lbfgs", max_iter=50),
                         inputs["yc"]),
                        ("lin", JLin(solver="lbfgs", max_iter=50),
                         inputs["yr"])):
                    gs = JGrid(est, C_GRID, cv=3, n_jobs=1).fit(
                        inputs["Xc"], y)
                    got[f"{name}-scores"] = gs.cv_results_["mean_test_score"]
                    got[f"{name}-rank"] = gs.cv_results_["rank_test_score"]
                    got[f"{name}-best"] = gs.best_params_
                    got[f"{name}-batched"] = gs.n_batched_cells_
                    got["buckets"] = [int(b) for b in gs.shape_buckets_]
            out[(world, layout)] = got
    return out


def _ids(cases):
    return [f"w{w}-{lay}" for w, lay in cases]


@pytest.mark.parametrize("world,layout", CASES, ids=_ids(CASES))
def test_splits_default_to_the_data_shards_as_jax(worlds, jax_runs, world,
                                                  layout):
    want = jax_runs[(world, layout)]
    for arrays, _ in worlds[world]:
        for key in ("split-train", "split-test"):
            assert np.array_equal(arrays[f"{layout}-{key}"], want[key])


@pytest.mark.parametrize("world,layout", CASES, ids=_ids(CASES))
@pytest.mark.parametrize("kind", ["int", "float"])
def test_batched_lloyd_cells_over_the_ranks(worlds, jax_runs, world, layout,
                                            kind):
    one = worlds[1][0][0]
    j = jax_runs[(world, layout)]
    for arrays, _ in worlds[world]:
        pre = f"{layout}-{kind}-"
        assert np.array_equal(arrays[pre + "n"], one[f"flat-{kind}-n"])
        assert np.array_equal(arrays[pre + "n"], j[f"{kind}-n"])
        for key in ("train", "eval"):
            if kind == "int" and key == "eval":
                assert np.array_equal(arrays[pre + key],
                                      one[f"flat-{kind}-{key}"]), key
            else:
                np.testing.assert_allclose(arrays[pre + key],
                                           one[f"flat-{kind}-{key}"],
                                           rtol=1e-5)
            np.testing.assert_allclose(arrays[pre + key], j[f"{kind}-{key}"],
                                       rtol=1e-5)


@pytest.mark.parametrize("world,layout", CASES, ids=_ids(CASES))
def test_batched_ledger_is_one_sum_a_step(worlds, world, layout):
    from dask_ml_tpu_torch.parallel import hierarchy as hier

    floats = sum(k * D + k + 1 for k in sorted({k for k, _ in MEMBERS}))
    want = {ax: b * MAX_ITER for ax, b in hier.collective_bytes(
        torch_worlds.port_mesh(world, layout), floats * 4).items()}
    for _, info in worlds[world]:
        snap = info[f"{layout}-int-ledger"]
        if world == 1:
            assert set(snap["bytes"].values()) <= {0}
            continue
        assert snap["ops"]["kmeans.batched"] == want
        for ax in want:
            assert snap["calls"][f"{ax}/kmeans.batched"] == MAX_ITER
        assert "kmeans.batched.init" in snap["ops"]
        assert "kmeans.batched.eval" in snap["ops"]


@pytest.mark.parametrize("world,layout", CASES, ids=_ids(CASES))
def test_kmeans_grid_equals_the_world_one_search(worlds, world, layout):
    one_arrays, one_info = worlds[1][0]
    for arrays, info in worlds[world]:
        for key in ("km-scores", "km-split0"):
            assert np.array_equal(arrays[f"{layout}-{key}"],
                                  one_arrays[f"flat-{key}"])
        assert info[f"{layout}-km-best"] == one_info["flat-km-best"]
        assert info[f"{layout}-km-batched"] == 18


@pytest.mark.parametrize("world,layout", CASES, ids=_ids(CASES))
@pytest.mark.parametrize("name", ["lr", "lin"])
def test_glm_grid_against_jax_and_world_one(worlds, jax_runs, world, layout,
                                            name):
    j = jax_runs[(world, layout)]
    one = worlds[1][0][0]
    for arrays, info in worlds[world]:
        scores = arrays[f"{layout}-{name}-scores"]
        np.testing.assert_allclose(scores, j[f"{name}-scores"], rtol=1e-4)
        np.testing.assert_allclose(scores, one[f"flat-{name}-scores"],
                                   rtol=1e-4)
        assert np.array_equal(arrays[f"{layout}-{name}-rank"],
                              j[f"{name}-rank"])
        assert info[f"{layout}-{name}-best"] == j[f"{name}-best"]
        assert info[f"{layout}-{name}-batched"] == j[f"{name}-batched"] == 9


@pytest.mark.parametrize("world,layout", CASES, ids=_ids(CASES))
def test_planned_buckets_align_to_the_data_shards(worlds, jax_runs, world,
                                                  layout):
    """The KMeans search's folds of 601 rows and the GLM search's of 301:
    both packages round each fold to a multiple of the shard count."""
    j = jax_runs[(world, layout)]
    sizes = (400, 401, 200, 201)
    want = sorted({-(-n // world) * world for n in sizes})
    for _, info in worlds[world]:
        assert info[f"{layout}-buckets"] == want
    glm = sorted({-(-n // world) * world for n in (200, 201, 100, 101)})
    assert j["buckets"] == glm

"""The sketched KMeans and MiniBatchKMeans over a mesh of ranks, on the CPU.

Worlds of 1, 3 and 4 gloo ranks (flat, and two pods of two at world 4)
fit ``KMeans(algorithm="sketched")`` on separable 41-feature blobs (its
predict takes the sketched contraction, K2-x: 2p ≤ d and k ≥ 8), predict
through a sketched model the JAX package fitted, and fit
``MiniBatchKMeans`` (``fit``, ``partial_fit``, ``predict``,
``transform``, ``score``) on 2,003 rows, integer-valued and float. The
JAX package runs the same on the matching virtual mesh. Tolerances and
their reasons:

- the sketched fit sums its mean, its restricted Lloyd rounds, its
  polish and its inertia over the ranks in another order than one
  device, in the p-column sketch space where no sum is exact: a world of
  ranks gives the world-1 labels, ``n_iter_`` and ``predict``, centers
  within 1e-4 and inertia within rtol 1e-5; it draws its transform from
  ``torch.Generator`` (the JAX package from ``jax.random``), so it is held
  to the JAX sketched fit (one fit, on the four-device mesh) by quality,
  as ``test_torch_sketched.py`` holds one device: inertia within 5 % of
  the JAX fit's and the true partition (ARI 1.0);
- a sketched model the JAX package fitted predicts over the port's ranks
  (K2-x on each block, gathered) the labels the JAX model predicts on the
  matching mesh;
- MiniBatchKMeans on integer data: the batch indices are global and drawn
  as on one device, and each step's partial sums and counts are integers
  below 2**24, so a world of ranks fits the world-1 centers, counts,
  labels and inertia bit for bit; on floats rtol 1e-5;
  ``partial_fit`` from an explicit init equals the JAX package's on the
  matching mesh in labels and counts, centers within rtol 1e-6 (its update
  ``(1 − η)c + η·mean`` rounds once more or less in XLA, as
  ``test_torch_minibatch.py`` holds one device).
"""

import numpy as np
import pytest
from sklearn.metrics import adjusted_rand_score

import torch_worlds

SK = dict(n_clusters=8, algorithm="sketched", sketch_cols=10,
          random_state=3, max_iter=60)
MB = dict(n_clusters=4, random_state=0, batch_size=256, max_iter=2)
N_MB = 2003

BODY = """
import types
from dask_ml_tpu_torch.cluster import KMeans, MiniBatchKMeans
from dask_ml_tpu_torch.convert import kmeans_from_numpy
from dask_ml_tpu_torch.parallel.sharding import prepare_data

SK, MB = @SK@, @MB@
attrs = {k[6:]: v for k, v in data.items() if k.startswith("jattr-")}
attrs["fast_transform_"] = types.SimpleNamespace(
    angles=data["jft-angles"], d=int(data["jft-d"]),
    d_pad=int(data["jft-dpad"]))
for lay, m in layouts(world).items():
    with mesh_lib.use_mesh(m):
        for kind in ("int", "float"):
            X = data["Xs" + kind[0]]
            hier.reset_ledger()
            sk = KMeans(**SK).fit(X)
            info[f"{lay}-{kind}-sk-ops"] = sorted(
                hier.ledger_snapshot()["ops"])
            pre = f"{lay}-{kind}-sk-"
            res[pre + "labels"] = sk.labels_
            res[pre + "centers"] = sk.cluster_centers_
            res[pre + "inertia"] = np.array(sk.inertia_)
            res[pre + "n"] = np.array(sk.n_iter_)
            res[pre + "pred"] = sk.predict(X)
            res[pre + "mu"] = sk.sketch_mean_
            info[pre + "rows"] = sk.sketch_pruning_["rows_considered"]
        res[lay + "-jsk-pred"] = kmeans_from_numpy(attrs).predict(data["Xq"])
        for kind in ("int", "float"):
            X = data["Xm" + kind[0]]
            mb = MiniBatchKMeans(**MB).fit(X)
            pre = f"{lay}-{kind}-mb-"
            res[pre + "centers"] = mb.cluster_centers_
            res[pre + "counts"] = mb.counts_
            res[pre + "labels"] = mb.labels_
            res[pre + "inertia"] = np.array(mb.inertia_)
            res[pre + "pred"] = mb.predict(X)
            res[pre + "dist"] = mb.transform(X[:50])
            res[pre + "score"] = np.array(mb.score(X))
            info[pre + "n"] = mb.n_iter_
        pf = MiniBatchKMeans(n_clusters=4, init=data["c0"])
        for lo in (0, 700, 1500):
            pf.partial_fit(data["Xmi"][lo:lo + 500])
        res[lay + "-pf-centers"] = pf.cluster_centers_
        res[lay + "-pf-counts"] = pf.counts_
        res[lay + "-pf-pred"] = pf.predict(data["Xmi"])
""".replace("@SK@", repr(SK)).replace("@MB@", repr(MB))

CASES = torch_worlds.cases()


def _ids(cases):
    return [f"w{w}-{lay}" for w, lay in cases]


def _blobs(n, d, k, seed, sep):
    rng = np.random.RandomState(seed)
    C = rng.randn(k, d).astype(np.float32) * sep
    y = rng.randint(0, k, n)
    return (C[y] + rng.randn(n, d).astype(np.float32)).astype(np.float32), y


@pytest.fixture(scope="module")
def jsk():
    """The JAX package's sketched fit, once, on the four-device mesh."""
    from dask_ml_tpu import config as jconfig
    from dask_ml_tpu.cluster import KMeans as JKMeans
    from dask_ml_tpu.parallel import mesh as jmesh

    with jconfig.config_context(pad_policy=None), \
            jmesh.use_mesh(torch_worlds.jax_mesh(4, "flat")):
        return JKMeans(**SK).fit(_blobs(2803, 41, 8, 0, 6.0)[0])


@pytest.fixture(scope="module")
def inputs(jsk):
    from dask_ml_tpu.interop import export_learned_attrs

    Xs, ys = _blobs(2803, 41, 8, 0, 6.0)
    Xm, ym = _blobs(N_MB, 5, 4, 1, 4.0)
    Xmi = np.rint(Xm)
    c0 = Xmi[[int(np.flatnonzero(ym == j)[0]) for j in range(4)]]
    ref = jsk
    out = {"Xsi": np.rint(Xs), "Xsf": Xs, "ys": ys, "Xmi": Xmi, "Xmf": Xm,
           "ym": ym, "c0": c0, "Xq": Xs[:300] + 0.1,
           "jsk-labels": np.asarray(ref.labels_),
           "jsk-inertia": np.array(ref.inertia_)}
    for k, v in export_learned_attrs(ref).items():
        if k == "fast_transform_":
            ft = v.item() if isinstance(v, np.ndarray) else v
            out["jft-angles"] = np.asarray(ft.angles)
            out["jft-d"], out["jft-dpad"] = np.array(ft.d), np.array(ft.d_pad)
        elif isinstance(v, np.ndarray) and v.dtype != object:
            out["jattr-" + k] = v
    return out


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    return torch_worlds.spawn_worlds(BODY, inputs, tmp_path_factory)


@pytest.fixture(scope="module")
def jax_runs(inputs, jsk):
    from dask_ml_tpu import config as jconfig
    from dask_ml_tpu.cluster import MiniBatchKMeans as JMB
    from dask_ml_tpu.parallel import mesh as jmesh

    out = {}
    with jconfig.config_context(pad_policy=None):
        for world, layout in CASES:
            with jmesh.use_mesh(torch_worlds.jax_mesh(world, layout)):
                pf = JMB(n_clusters=4, init=inputs["c0"])
                for lo in (0, 700, 1500):
                    pf.partial_fit(inputs["Xmi"][lo:lo + 500])
                out[(world, layout)] = {
                    "jsk-pred": np.asarray(jsk.predict(inputs["Xq"])),
                    "pf-centers": np.asarray(pf.cluster_centers_),
                    "pf-counts": np.asarray(pf.counts_),
                    "pf-pred": np.asarray(pf.predict(inputs["Xmi"]))}
    return out


@pytest.mark.parametrize("world,layout", CASES, ids=_ids(CASES))
@pytest.mark.parametrize("kind", ["int", "float"])
def test_sketched_fit_equals_the_world_one_fit(worlds, world, layout, kind):
    one = worlds[1][0][0]
    for arrays, info in worlds[world]:
        pre, want = f"{layout}-{kind}-sk-", f"flat-{kind}-sk-"
        for key in ("labels", "n", "pred"):
            assert np.array_equal(arrays[pre + key], one[want + key]), key
        assert np.array_equal(arrays[pre + "pred"], arrays[pre + "labels"])
        np.testing.assert_allclose(arrays[pre + "centers"],
                                   one[want + "centers"], atol=1e-4)
        np.testing.assert_allclose(arrays[pre + "mu"], one[want + "mu"],
                                   atol=1e-5)
        np.testing.assert_allclose(arrays[pre + "inertia"],
                                   one[want + "inertia"], rtol=1e-5)
        assert info[pre + "rows"] == int(arrays[pre + "n"]) * 2803


@pytest.mark.parametrize("world,layout", CASES, ids=_ids(CASES))
def test_sketched_fit_sums_over_the_ranks(worlds, world, layout):
    if world == 1:
        return
    for _, info in worlds[world]:
        ops = info[f"{layout}-float-sk-ops"]
        for op in ("kmeans.sketch.mean", "kmeans.sketch.polish",
                   "kmeans.inertia", "kmeans.mstep", "kmeans.labels"):
            assert op in ops, op


@pytest.mark.parametrize("world,layout", CASES, ids=_ids(CASES))
def test_sketched_fit_against_the_jax_fit(worlds, inputs, world, layout):
    arrays = worlds[world][0][0]
    labels = arrays[f"{layout}-float-sk-labels"]
    assert adjusted_rand_score(inputs["ys"], labels) == 1.0
    assert adjusted_rand_score(inputs["jsk-labels"], labels) == 1.0
    assert float(arrays[f"{layout}-float-sk-inertia"]) <= \
        1.05 * float(inputs["jsk-inertia"])


@pytest.mark.parametrize("world,layout", CASES, ids=_ids(CASES))
def test_jax_sketched_model_predicts_alike_over_the_ranks(worlds, jax_runs,
                                                          world, layout):
    want = jax_runs[(world, layout)]["jsk-pred"]
    for arrays, _ in worlds[world]:
        assert np.array_equal(arrays[f"{layout}-jsk-pred"], want)


@pytest.mark.parametrize("world,layout", CASES, ids=_ids(CASES))
@pytest.mark.parametrize("kind", ["int", "float"])
def test_minibatch_equals_the_world_one_fit(worlds, world, layout, kind):
    one, one_info = worlds[1][0]
    for arrays, info in worlds[world]:
        pre, want = f"{layout}-{kind}-mb-", f"flat-{kind}-mb-"
        assert info[pre + "n"] == one_info[want + "n"] == 2 * 8
        for key in ("labels", "pred"):
            assert np.array_equal(arrays[pre + key], one[want + key]), key
        for key in ("centers", "counts", "inertia", "dist", "score"):
            if kind == "int":
                assert np.array_equal(arrays[pre + key], one[want + key]), \
                    key
            else:
                np.testing.assert_allclose(arrays[pre + key],
                                           one[want + key], rtol=1e-5,
                                           atol=1e-5)


@pytest.mark.parametrize("world,layout", CASES, ids=_ids(CASES))
def test_minibatch_partial_fit_against_jax(worlds, jax_runs, world, layout):
    j = jax_runs[(world, layout)]
    one = worlds[1][0][0]
    for arrays, _ in worlds[world]:
        pre = f"{layout}-pf-"
        assert np.array_equal(arrays[pre + "centers"], one["flat-pf-centers"])
        assert np.array_equal(arrays[pre + "counts"], j["pf-counts"])
        assert np.array_equal(arrays[pre + "pred"], j["pf-pred"])
        np.testing.assert_allclose(arrays[pre + "centers"], j["pf-centers"],
                                   rtol=1e-6)


@pytest.mark.parametrize("world,layout", CASES, ids=_ids(CASES))
def test_minibatch_quality_on_the_ranks(worlds, inputs, world, layout):
    labels = worlds[world][0][0][f"{layout}-float-mb-labels"]
    assert adjusted_rand_score(inputs["ym"], labels) >= 0.99

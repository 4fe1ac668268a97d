"""Spectral clustering and kernel k-means over a mesh of ranks, on the CPU.

Worlds of 1, 3 and 4 gloo ranks (flat, and two pods of two at world 4)
fit ``SpectralClustering`` on standardized blobs and ``KernelKMeans`` on
the XOR data of ``test_torch_spectral.py``, 1,001 and 1,023 rows (the
blocks of worlds 3 and 4 carry padding rows), and call ``predict`` and
``embed``. The JAX package runs the same estimators on the matching
virtual mesh. Tolerances and their reasons:

- the landmarks: one numpy ``RandomState`` draws them in both packages
  and on every world, and every rank takes them from its own whole X:
  equal bit for bit;
- a world of ranks sums the strip's column degrees over the ranks, in
  another order than one device, and the degree functional ``A⁺ colsum``
  carries the near-cutoff spectrum of the rbf block (``test_torch_
  spectral.py``'s pinv tests), which lifts an f32 rounding of the sums to
  ≈ 7e-5 of the eigenvalues: ``eigenvalues_`` and the landmarks' degrees
  within rtol 1e-4 of the world-1 fit, and the labels equal;
  against the JAX package (LAPACK here, XLA there) rtol 1e-4 as in
  ``test_torch_spectral.py``, and the same partition (ARI 1.0);
- ``predict`` over the ranks labels each block through K2 and gathers:
  equal to ``labels_`` on the training rows;
- ``embed``'s ``Bt`` is each rank's block, padding rows zero: gathered,
  within 1e-6 of the world-1 strip (a product per row);
- kernel k-means: ARI ≥ 0.9 against the XOR classes and the JAX fit, the
  XOR gate of ``test_torch_spectral.py``; the ledger's
  ``kernel.gram.colsum`` equals the formula ``collective_bytes(mesh, l·4)``
  and the JAX package's bytes on the matching mesh.
"""

import numpy as np
import pytest
from sklearn.datasets import make_blobs
from sklearn.metrics import adjusted_rand_score

import torch_worlds

N_SC, N_XOR = 1001, 1023
SC = dict(n_clusters=3, n_components=50, gamma=None, random_state=0)
XOR = dict(n_clusters=2, n_components=64, affinity="polynomial", degree=2,
           coef0=1.0, gamma=0.5, random_state=5, n_init=2)

BODY = """
from dask_ml_tpu_torch.cluster import KernelKMeans, SpectralClustering, embed

SC = @SC@
XOR = @XOR@
for lay, m in layouts(world).items():
    with mesh_lib.use_mesh(m):
        sc = SpectralClustering(**SC).fit(data["X"])
        res[lay + "-sc-labels"] = sc.labels_
        res[lay + "-sc-eig"] = sc.eigenvalues_
        res[lay + "-sc-d1"] = sc._extension_[1]
        res[lay + "-sc-landmarks"] = sc._landmarks_
        res[lay + "-sc-pred"] = sc.predict(data["X"])
        res[lay + "-sc-pred-new"] = sc.predict(data["Xnew"])
        hier.reset_ledger()
        kk = KernelKMeans(**XOR).fit(data["Xx"])
        info[lay + "-kk-ledger"] = hier.ledger_snapshot()
        res[lay + "-kk-labels"] = kk.labels_
        res[lay + "-kk-pred"] = kk.predict(data["Xx"])
        res[lay + "-kk-inertia"] = np.array(kk.inertia_)
        A, Bt = embed(data["X"][:40], data["X"][40:], 40, "rbf",
                      {"gamma": 0.5})
        res[lay + "-embed-A"] = A.numpy()
        res[lay + "-embed-Bt"] = Bt.numpy()
""".replace("@SC@", repr(SC)).replace("@XOR@", repr(XOR))

CASES = torch_worlds.cases()


def _xor(n, seed=0):
    rng = np.random.RandomState(seed)
    signs = rng.randint(0, 2, (n, 2)) * 2 - 1
    X = (signs * 2.0 + rng.randn(n, 2) * 0.6).astype(np.float32)
    return X, (signs[:, 0] * signs[:, 1] > 0).astype(np.int32)


@pytest.fixture(scope="module")
def inputs():
    X, y = make_blobs(n_samples=N_SC, n_features=4, centers=3,
                      cluster_std=0.5, random_state=0)
    X = ((X - X.mean(0)) / X.std(0)).astype(np.float32)
    Xx, yx = _xor(N_XOR)
    rng = np.random.RandomState(1)
    Xnew = X[:200] + rng.randn(200, 4).astype(np.float32) * 0.01
    return {"X": X, "y": y, "Xx": Xx, "yx": yx, "Xnew": Xnew}


@pytest.fixture(scope="module")
def worlds(inputs, tmp_path_factory):
    return torch_worlds.spawn_worlds(BODY, inputs, tmp_path_factory)


@pytest.fixture(scope="module")
def jax_fits(inputs):
    from dask_ml_tpu import cluster as jcluster
    from dask_ml_tpu import config as jconfig
    from dask_ml_tpu.parallel import hierarchy as jhier
    from dask_ml_tpu.parallel import mesh as jmesh

    out = {}
    with jconfig.config_context(pad_policy=None):
        for world, layout in CASES:
            with jmesh.use_mesh(torch_worlds.jax_mesh(world, layout)):
                sc = jcluster.SpectralClustering(**SC).fit(inputs["X"])
                jhier.reset_ledger()
                kk = jcluster.KernelKMeans(**XOR).fit(inputs["Xx"])
                out[(world, layout)] = (sc, kk, jhier.ledger_snapshot())
    return out


@pytest.mark.parametrize("world,layout", CASES,
                         ids=[f"w{w}-{lay}" for w, lay in CASES])
def test_spectral_equals_the_world_one_fit(worlds, world, layout):
    want = worlds[1][0][0]
    for arrays, _ in worlds[world]:
        pre = f"{layout}-sc-"
        assert np.array_equal(arrays[pre + "landmarks"],
                              want["flat-sc-landmarks"])
        assert np.array_equal(arrays[pre + "labels"], want["flat-sc-labels"])
        np.testing.assert_allclose(arrays[pre + "eig"], want["flat-sc-eig"],
                                   rtol=1e-4)
        np.testing.assert_allclose(arrays[pre + "d1"], want["flat-sc-d1"],
                                   rtol=1e-4)
        assert np.array_equal(arrays[pre + "pred"], arrays[pre + "labels"])
        assert arrays[pre + "pred"].dtype == np.int32
        assert np.array_equal(arrays[pre + "pred-new"],
                              arrays[pre + "labels"][:200])


@pytest.mark.parametrize("world,layout", CASES,
                         ids=[f"w{w}-{lay}" for w, lay in CASES])
def test_spectral_against_jax_on_the_matching_mesh(worlds, jax_fits, inputs,
                                                   world, layout):
    sc = jax_fits[(world, layout)][0]
    arrays = worlds[world][0][0]
    pre = f"{layout}-sc-"
    assert np.array_equal(arrays[pre + "landmarks"],
                          np.asarray(sc._landmarks_))
    np.testing.assert_allclose(arrays[pre + "eig"],
                               np.asarray(sc.eigenvalues_), rtol=1e-4)
    np.testing.assert_allclose(arrays[pre + "d1"],
                               np.asarray(sc._extension_[1]), rtol=1e-4)
    assert adjusted_rand_score(np.asarray(sc.labels_),
                               arrays[pre + "labels"]) == 1.0
    assert adjusted_rand_score(inputs["y"], arrays[pre + "labels"]) == 1.0


@pytest.mark.parametrize("world,layout", CASES,
                         ids=[f"w{w}-{lay}" for w, lay in CASES])
def test_kernel_kmeans_over_the_ranks(worlds, jax_fits, inputs, world,
                                      layout):
    _, kk, _ = jax_fits[(world, layout)]
    want = worlds[1][0][0]
    for arrays, _ in worlds[world]:
        pre = f"{layout}-kk-"
        labels = arrays[pre + "labels"]
        assert adjusted_rand_score(inputs["yx"], labels) >= 0.9
        assert adjusted_rand_score(np.asarray(kk.labels_), labels) >= 0.9
        assert np.array_equal(arrays[pre + "pred"], labels)
        assert np.array_equal(labels, want["flat-kk-labels"])
        np.testing.assert_allclose(arrays[pre + "inertia"],
                                   want["flat-kk-inertia"], rtol=1e-4)


@pytest.mark.parametrize("world,layout", CASES,
                         ids=[f"w{w}-{lay}" for w, lay in CASES])
def test_gram_colsum_ledger_is_the_formula_and_jax(worlds, jax_fits, world,
                                                   layout):
    from dask_ml_tpu_torch.parallel import hierarchy as hier

    l = XOR["n_components"]
    want = hier.collective_bytes(torch_worlds.port_mesh(world, layout),
                                 l * 4)
    jax_bytes = jax_fits[(world, layout)][2]["ops"].get(
        "kernel.gram.colsum", {})
    for _, info in worlds[world]:
        got = info[f"{layout}-kk-ledger"]["ops"].get("kernel.gram.colsum",
                                                     {})
        if world == 1:
            assert set(got.values()) <= {0}
            continue
        assert got == want
        assert {ax: b for ax, b in jax_bytes.items() if b} == \
            {ax: b for ax, b in want.items() if b}


@pytest.mark.parametrize("world,layout", CASES,
                         ids=[f"w{w}-{lay}" for w, lay in CASES])
def test_embed_returns_each_rank_its_block(worlds, world, layout):
    want_A = worlds[1][0][0]["flat-embed-A"]
    want_Bt = worlds[1][0][0]["flat-embed-Bt"]
    m = N_SC - 40
    blocks = [arrays[f"{layout}-embed-Bt"] for arrays, _ in worlds[world]]
    n_loc = -(-m // world)
    assert all(b.shape == (n_loc, 40) for b in blocks)
    whole = np.concatenate(blocks)
    np.testing.assert_allclose(whole[:m], want_Bt, rtol=1e-6, atol=1e-6)
    assert not whole[m:].any()
    for arrays, _ in worlds[world]:
        assert np.array_equal(arrays[f"{layout}-embed-A"], want_A)

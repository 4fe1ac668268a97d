"""The port's generators over a mesh of ranks (``mesh=``), on the CPU.

Worlds of 1, 3 and 4 gloo ranks (flat, and two pods of two at world 4)
each draw every generator with ``mesh=`` the world's layout. The port's
convention: every rank draws the same whole arrays from the same seed, so

- ``make_blobs``, ``make_classification``, ``make_counts``,
  ``make_regression`` and ``make_sparse_classification`` give every rank
  of every world the world-1 bits, and ``random_state=None`` the same
  arrays on every rank of a world;
- ``make_regression(effective_rank=)`` orthonormalizes its Gaussian basis
  by tsqr over the ranks' blocks, whose sums add in another order: its Q
  is orthonormal to 2e-6 and within 2e-6 of the world-1 Q, its design
  within 2e-6 of the world-1 design (f32 rounding of a (1008, 12) basis;
  the basis test takes 999 rows, so that the blocks carry padding).

The JAX generators draw from ``jax.random``, so they are held by what
does not depend on the bits: shapes, dtypes, label ranges, and the
effective-rank design's singular values, which both packages build as the
same profile ``s`` (rtol 1e-4) on the matching virtual mesh.
"""

import numpy as np
import pytest

import torch_worlds

N, D, CENTERS = 2003, 5, 4
ER_N, ER_D, ER_RANK = 1008, 12, 3
#: rows of the Gaussian draw the tsqr test orthonormalizes: 999 pads the
#: blocks of worlds 3 and 4
G_N = 999

BODY = """
from dask_ml_tpu_torch import datasets
from dask_ml_tpu_torch.datasets import _orthonormal_rows
from dask_ml_tpu_torch.parallel.sharding import prepare_data

def host(t):
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)

for lay, m in layouts(world).items():
    X, y = datasets.make_blobs(@N@, @D@, centers=@C@, random_state=0, mesh=m)
    res[lay + "-blobs-X"], res[lay + "-blobs-y"] = host(X), host(y)
    X, y = datasets.make_classification(@N@, @D@, n_informative=3,
                                        random_state=1, mesh=m)
    res[lay + "-clf-X"], res[lay + "-clf-y"] = host(X), host(y)
    X, y = datasets.make_counts(@N@, @D@, random_state=2, mesh=m)
    res[lay + "-counts-X"], res[lay + "-counts-y"] = host(X), host(y)
    X, y, c = datasets.make_regression(@N@, @D@, n_informative=3, coef=True,
                                       noise=0.5, random_state=3, mesh=m)
    res[lay + "-reg-X"], res[lay + "-reg-y"] = host(X), host(y)
    res[lay + "-reg-c"] = host(c)
    X, y = datasets.make_regression(@ER_N@, @ER_D@, effective_rank=@ER_R@,
                                    random_state=4, mesh=m)
    res[lay + "-er-X"], res[lay + "-er-y"] = host(X), host(y)
    G = torch.as_tensor(data["G"])
    res[lay + "-er-Q"] = host(_orthonormal_rows(G, m))
    A, ys = datasets.make_sparse_classification(500, 200, 0.02,
                                                random_state=5, mesh=m)
    res[lay + "-sparse-v"], res[lay + "-sparse-c"] = A.values, A.cols
    res[lay + "-sparse-y"] = ys
    X, _ = datasets.make_blobs(50, 3, random_state=None, mesh=m)
    res[lay + "-noseed"] = host(X)
    d = prepare_data(res[lay + "-blobs-X"], mesh=m)
    res[lay + "-block"] = host(d.X)
    info[lay + "-offset"] = int(d.row_offset)
""".replace("@N@", str(N)).replace("@D@", str(D)).replace(
    "@C@", str(CENTERS)).replace("@ER_N@", str(ER_N)).replace(
    "@ER_D@", str(ER_D)).replace("@ER_R@", str(ER_RANK))

GENERATORS = ("blobs-X", "blobs-y", "clf-X", "clf-y", "counts-X", "counts-y",
              "reg-X", "reg-y", "reg-c", "sparse-v", "sparse-c", "sparse-y")
CASES = torch_worlds.cases()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    G = np.random.RandomState(7).randn(G_N, ER_D).astype(np.float32)
    return torch_worlds.spawn_worlds(BODY, {"G": G}, tmp_path_factory)


@pytest.mark.parametrize("world,layout", CASES,
                         ids=[f"w{w}-{lay}" for w, lay in CASES])
def test_every_rank_draws_the_world_one_bits(worlds, world, layout):
    want = worlds[1][0][0]
    for arrays, _ in worlds[world]:
        for key in GENERATORS:
            got = arrays[f"{layout}-{key}"]
            assert got.dtype == want[f"flat-{key}"].dtype, key
            assert np.array_equal(got, want[f"flat-{key}"]), key


@pytest.mark.parametrize("world", [3, 4])
def test_no_seed_gives_every_rank_the_same_arrays(worlds, world):
    first = worlds[world][0][0]["flat-noseed"]
    for arrays, _ in worlds[world][1:]:
        assert np.array_equal(arrays["flat-noseed"], first)
    assert first.shape == (50, 3) and np.isfinite(first).all()


@pytest.mark.parametrize("world,layout", CASES,
                         ids=[f"w{w}-{lay}" for w, lay in CASES])
def test_effective_rank_tsqr_over_the_ranks(worlds, world, layout):
    want = worlds[1][0][0]
    for arrays, _ in worlds[world]:
        Q = arrays[f"{layout}-er-Q"].astype(np.float64)
        assert Q.shape == (G_N, ER_D)
        np.testing.assert_allclose(Q.T @ Q, np.eye(ER_D), atol=2e-6)
        np.testing.assert_allclose(Q, want["flat-er-Q"], atol=2e-6)
        np.testing.assert_allclose(arrays[f"{layout}-er-X"],
                                   want["flat-er-X"], atol=2e-6)
        np.testing.assert_allclose(arrays[f"{layout}-er-y"],
                                   want["flat-er-y"], rtol=1e-4, atol=1e-4)
    if world > 1:  # the ranks ran the sums: every rank the same bits
        first = worlds[world][0][0][f"{layout}-er-X"]
        for arrays, _ in worlds[world][1:]:
            assert np.array_equal(arrays[f"{layout}-er-X"], first)


@pytest.mark.parametrize("world,layout", CASES,
                         ids=[f"w{w}-{lay}" for w, lay in CASES])
def test_staging_takes_each_rank_its_block(worlds, world, layout):
    X = worlds[1][0][0]["flat-blobs-X"]
    n_loc = -(-N // world)
    for r, (arrays, info) in enumerate(worlds[world]):
        block = arrays[f"{layout}-block"]
        lo = info[f"{layout}-offset"]
        assert lo == r * n_loc and block.shape == (n_loc, D)
        real = min(N - lo, n_loc)
        assert np.array_equal(block[:real], X[lo:lo + real])
        assert not block[real:].any()


@pytest.mark.parametrize("world,layout", CASES,
                         ids=[f"w{w}-{lay}" for w, lay in CASES])
def test_against_the_jax_generators_on_the_matching_mesh(worlds, world,
                                                         layout):
    from dask_ml_tpu import datasets as jdata

    jm = torch_worlds.jax_mesh(world, layout)
    jX, jy = jdata.make_blobs(N, D, centers=CENTERS, random_state=0,
                              mesh=jm)
    arrays = worlds[world][0][0]
    X, y = arrays[f"{layout}-blobs-X"], arrays[f"{layout}-blobs-y"]
    assert X.shape == np.asarray(jX).shape and X.dtype == np.float32
    assert set(np.unique(y)) <= set(range(CENTERS))
    assert set(np.unique(np.asarray(jy))) <= set(range(CENTERS))
    jXe, _ = jdata.make_regression(ER_N, ER_D, effective_rank=ER_RANK,
                                   random_state=4, mesh=jm)
    s_port = np.linalg.svd(arrays[f"{layout}-er-X"].astype(np.float64),
                           compute_uv=False)
    s_jax = np.linalg.svd(np.asarray(jXe, np.float64), compute_uv=False)
    np.testing.assert_allclose(s_port, s_jax, rtol=1e-4, atol=1e-5)

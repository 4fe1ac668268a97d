"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``gpu``; each test asks the ``cuda`` fixture for the card and skips
when there is none, so every worker collects the same tests. Run them on
the card's machine (which has no jax, hence ``--noconftest``) with

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py

On integer-valued inputs every product and sum is exact, so kernel and
plain version must agree bit for bit.
"""

import numpy as np
import pytest
import torch

from dask_ml_tpu_torch import _kernels, config_context
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.datasets import make_sparse_classification
from dask_ml_tpu_torch.linear_model import LogisticRegression
from dask_ml_tpu_torch.models import glm as glm_core
from dask_ml_tpu_torch.models import kmeans as core
from dask_ml_tpu_torch.ops import fused_distance as fd
from dask_ml_tpu_torch.ops import sparse as sps

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the port's kernels run only there")
    tf32 = torch.backends.cuda.matmul.allow_tf32
    prec = torch.get_float32_matmul_precision()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.set_float32_matmul_precision(prec)


def _ints(rng, shape, dev, lo=-8, hi=8):
    return torch.as_tensor(rng.integers(lo, hi, shape), dtype=torch.float32,
                           device=dev)


@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (533, 37, 13), (129, 7, 3),
                                   (2000, 329, 50), (300, 40, 130)])
def test_fused_kernels_bitexact_int_valued(cuda, n, m, d):
    rng = np.random.default_rng(n + m + d)
    X, Y = _ints(rng, (n, d), cuda), _ints(rng, (m, d), cuda)
    w = _ints(rng, (n,), cuda, 0, 5)
    mask = torch.as_tensor(rng.random(m) > 0.3, device=cuda)
    before = dict(_kernels.launches)
    for args in ((X, Y, mask), (X, Y, None)):
        assert torch.equal(fd.fused_rowwise_min(*args, kernel="cuda"),
                           fd.fused_rowwise_min(*args, kernel="torch"))
        ka, km = fd.fused_argmin_min(*args, kernel="cuda")
        ra, rm = fd.fused_argmin_min(*args, kernel="torch")
        assert ka.dtype == torch.int32
        assert torch.equal(ka, ra) and torch.equal(km, rm)
    ki, kc = fd.fused_argmin_weight(X, w, Y, mask, kernel="cuda")
    ri, rc = fd.fused_argmin_weight(X, w, Y, mask, kernel="torch")
    assert torch.equal(ki, ri) and torch.equal(kc, rc)
    # 'auto' on a CUDA tensor is the kernel
    assert torch.equal(fd.fused_argmin_min(X, Y, None)[0], ka)
    assert _kernels.launches["fused_rowwise_min"] == \
        before["fused_rowwise_min"] + 2
    assert _kernels.launches["fused_argmin_min"] == \
        before["fused_argmin_min"] + 3


def test_row_need_skips_groups(cuda):
    rng = np.random.default_rng(0)
    n = 3 * fd._FUSED_BLK + 5
    X, Y = _ints(rng, (n, 20), cuda), _ints(rng, (30, 20), cuda)
    need = torch.zeros(n, dtype=torch.bool, device=cuda)
    need[fd._FUSED_BLK + 3] = True
    ev = fd.row_block_evaluated(need)
    got = fd.fused_rowwise_min(X, Y, kernel="cuda", row_need=need)
    want = fd.fused_rowwise_min(X, Y, kernel="torch", row_need=need)
    assert torch.equal(got, want)
    assert torch.isinf(got[~ev]).all() and torch.isfinite(got[ev]).all()


def test_all_masked(cuda):
    rng = np.random.default_rng(1)
    X, Y = _ints(rng, (300, 3), cuda), _ints(rng, (8, 3), cuda)
    mask = torch.zeros(8, dtype=torch.bool, device=cuda)
    a, mn = fd.fused_argmin_min(X, Y, mask, kernel="cuda")
    assert (a == 0).all() and torch.isinf(mn).all()
    _, cw = fd.fused_argmin_weight(X, torch.ones(300, device=cuda), Y, mask,
                                   kernel="cuda")
    assert (cw == 0).all()


def _all_four_bitexact(X, Y, mask, w):
    """K2, K3, K4 and K5 through the public entries, kernel against plain
    version bit for bit; K5's argmin and min are K2's."""
    assert torch.equal(fd.fused_rowwise_min(X, Y, mask, kernel="cuda"),
                       fd.fused_rowwise_min(X, Y, mask, kernel="torch"))
    k2 = fd.fused_argmin_min(X, Y, mask, kernel="cuda")
    assert all(torch.equal(a, b) for a, b in zip(
        k2, fd.fused_argmin_min(X, Y, mask, kernel="torch")))
    k4 = fd.fused_argmin_weight(X, w, Y, mask, kernel="cuda")
    assert all(torch.equal(a, b) for a, b in zip(
        k4, fd.fused_argmin_weight(X, w, Y, mask, kernel="torch")))
    k5 = fd.fused_argmin_min2(X, Y, mask, kernel="cuda")
    assert all(torch.equal(a, b) for a, b in zip(
        k5, fd.fused_argmin_min2(X, Y, mask, kernel="torch")))
    assert torch.equal(k5[0], k2[0]) and torch.equal(k5[1], k2[1])
    return k5


@pytest.mark.parametrize("count", [0, 1, 15, 16, 17, 31, 32, 33, 79, 80])
def test_prefix_masks_of_the_rounds_bitexact(cuda, count):
    """The k-means|| rounds' mask: the first ``count`` of 80 slots valid;
    target tiles (16 slots each at m = 80) with no valid slot are skipped
    by the kernel. n is not a multiple of a block's rows."""
    rng = np.random.default_rng(count)
    X, Y = _ints(rng, (1000, 50), cuda), _ints(rng, (80, 50), cuda)
    w = _ints(rng, (1000,), cuda, 0, 5)
    mask = torch.arange(80, device=cuda) < count
    a, b, s = _all_four_bitexact(X, Y, mask, w)
    if count == 0:
        assert (a == 0).all() and torch.isinf(b).all() and torch.isinf(s).all()
    else:
        assert int(a.max()) < count


@pytest.mark.parametrize("m", [80, 329])
def test_lone_valid_target_in_the_last_tile(cuda, m):
    rng = np.random.default_rng(m)
    X, Y = _ints(rng, (777, 41), cuda), _ints(rng, (m, 41), cuda)
    w = _ints(rng, (777,), cuda, 0, 5)
    mask = torch.zeros(m, dtype=torch.bool, device=cuda)
    mask[-1] = True
    a, _, s = _all_four_bitexact(X, Y, mask, w)
    assert (a == m - 1).all() and torch.isinf(s).all()
    _, cw = fd.fused_argmin_weight(X, w, Y, mask, kernel="cuda")
    assert float(cw[-1]) == float(w.sum()) and (cw[:-1] == 0).all()


def test_ties_across_fragments_and_tiles(cuda):
    """Duplicates of target 5 at 7 and 8 (two threads' targets), 31 | 32 |
    33 and 63 | 64 (tile boundaries) and 79: rows that sit on them take the
    lowest index, and argmin_min2's tie is its second-best."""
    rng = np.random.default_rng(5)
    Y = _ints(rng, (80, 50), cuda)
    Y[[7, 8, 31, 32, 33, 63, 64, 79]] = Y[5].clone()
    X = torch.cat([Y[5:6].expand(300, 50), _ints(rng, (301, 50), cuda)])
    w = _ints(rng, (601,), cuda, 0, 5)
    a, b, s = _all_four_bitexact(X, Y, None, w)
    assert (a[:300] == 5).all() and torch.equal(b[:300], s[:300])
    for drop, want in (([5], 7), ([5, 7, 8], 31), ([5, 7, 8, 31], 32),
                       ([5, 7, 8, 31, 32, 33], 63)):
        mask = torch.ones(80, dtype=torch.bool, device=cuda)
        mask[drop] = False
        a, b, s = _all_four_bitexact(X, Y, mask, w)
        assert (a[:300] == want).all() and torch.equal(b[:300], s[:300])


@pytest.mark.parametrize("m", [1, 7, 8, 9, 329])
@pytest.mark.parametrize("d", [1, 3, 50, 64, 65, 130])
def test_every_tile_shape_bitexact(cuda, d, m):
    """Every tile shape (m <= 8: a row x 8 targets a thread; m <= 128: 8
    rows x 4 targets; beyond: 8 rows x 8 targets), one feature chunk and
    several, a ragged n, a random mask."""
    rng = np.random.default_rng(1000 * d + m)
    X, Y = _ints(rng, (389, d), cuda), _ints(rng, (m, d), cuda)
    w = _ints(rng, (389,), cuda, 0, 5)
    _all_four_bitexact(X, Y, None, w)
    _all_four_bitexact(X, Y, torch.as_tensor(rng.random(m) > 0.3,
                                             device=cuda), w)


def test_argmin_weight_repeats_its_bits_on_float_data(cuda):
    g = torch.Generator(device=cuda)
    g.manual_seed(7)
    X = torch.randn((200_003, 50), generator=g, device=cuda)
    Y = X[:329].clone()
    w = torch.rand(200_003, generator=g, device=cuda)
    mask = torch.arange(329, device=cuda) < 321
    first = fd.fused_argmin_weight(X, w, Y, mask, kernel="cuda")
    for _ in range(3):
        again = fd.fused_argmin_weight(X, w, Y, mask, kernel="cuda")
        assert torch.equal(first[0], again[0])
        assert torch.equal(first[1], again[1])


@pytest.mark.parametrize("m", [80, 329])
def test_one_score_loop_on_float_data(cuda, m):
    """K2, K3, K5 and K4 share one score loop: on float data their
    argmins and minima are the same bits."""
    g = torch.Generator(device=cuda)
    g.manual_seed(m)
    X = torch.randn((100_001, 41), generator=g, device=cuda)
    Y = torch.randn((m, 41), generator=g, device=cuda)
    mask = torch.arange(m, device=cuda) < m - 3
    k2 = fd.fused_argmin_min(X, Y, mask, kernel="cuda")
    k5 = fd.fused_argmin_min2(X, Y, mask, kernel="cuda")
    k3 = fd.fused_rowwise_min(X, Y, mask, kernel="cuda")
    k4 = fd.fused_argmin_weight(X, torch.ones(100_001, device=cuda), Y, mask,
                                kernel="cuda")
    assert torch.equal(k5[0], k2[0]) and torch.equal(k5[1], k2[1])
    assert torch.equal(k3, k2[1]) and torch.equal(k4[0], k2[0])


@pytest.mark.parametrize("n,k,d,offset", [
    (1, 1, 1, 0), (1000, 8, 50, 0), (70001, 3, 2, 0), (5000, 13, 7, 0),
    # d % 4 != 0 (a 4-byte tail after the 16-byte copies) at the KDD cell's
    # width; d % 4 == 0 with 16-byte row reads (d / 4 odd, and d % 8 == 0);
    # n not a multiple of the 256-row tile
    (3001, 8, 41, 0), (20001, 8, 52, 0), (1000, 8, 64, 0),
    # k = 8 and k = 9: the register variant's edge
    (4099, 8, 50, 0), (4099, 9, 50, 0),
    # the widest d of the register variant, the first beyond it, and the
    # largest d the kernel's first design admitted at k = 8
    (2000, 8, 110, 0), (2000, 8, 111, 0), (257, 8, 397, 0),
    # X not 16-byte aligned: 4-byte copies although d % 4 == 0
    (3001, 8, 52, 1)])
def test_lloyd_kernel_bitexact_int_valued(cuda, n, k, d, offset):
    rng = np.random.default_rng(n + k)
    X = _ints(rng, (n * d + offset,), cuda, -4, 4)[offset:].view(n, d)
    w = _ints(rng, (n,), cuda, 0, 3)
    C = _ints(rng, (k, d), cuda, -4, 4)
    assert core._lloyd_cuda_supported(k, d)
    got = core._lloyd_stats_cuda(X, w, C)
    want = core._lloyd_stats_ref(X, w, C)
    again = core._lloyd_stats_cuda(X, w, C)
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c)


@pytest.mark.parametrize("k,d", [(8, 41), (8, 50), (9, 50), (8, 64)])
def test_lloyd_counts_are_the_bincount_of_k2_labels(cuda, k, d):
    """K1 scores with K2's loop and |c|² from the same _row_sumsq: from the
    same centers, on float data and unit weights, its counts are the
    bincount of K2's labels exactly; its sums and inertia are within rtol
    1e-5 of the plain version (other summation orders)."""
    g = torch.Generator(device=cuda)
    g.manual_seed(k * 100 + d)
    X = torch.randn((200_003, d), generator=g, device=cuda)
    C = X[:k].clone() + 0.1
    w = torch.ones(200_003, device=cuda)
    sums, counts, inertia = core._lloyd_stats_cuda(X, w, C)
    labels, mind = fd.fused_argmin_min(X, C, kernel="cuda")
    assert torch.equal(counts, torch.bincount(labels.long(),
                                              minlength=k).float())
    rs, _, ri = core._lloyd_stats_ref(X, w, C)
    torch.testing.assert_close(sums, rs, rtol=1e-5,
                               atol=1e-5 * float(rs.abs().max()))
    assert float(inertia) == pytest.approx(float(mind.sum()), rel=1e-5)
    assert float(inertia) == pytest.approx(float(ri), rel=1e-5)


def test_lloyd_beyond_bound_takes_two_pass(cuda):
    rng = np.random.default_rng(2)
    X = _ints(rng, (500, 600), cuda, -4, 4)
    w = torch.ones(500, device=cuda)
    C = X[:64].clone()
    assert not core._lloyd_cuda_supported(64, 600)
    with pytest.raises(ValueError, match="shared-memory"):
        core.lloyd_loop_fused(X, w, C, 0.0, max_iter=1, kernel="cuda")
    got = core.lloyd_loop_fused(X, w, C, 0.0, max_iter=2)
    want = core.lloyd_loop_fused(X, w, C, 0.0, max_iter=2, kernel="torch")
    assert torch.equal(got[0], want[0])


def _blobs(n, d, k, seed):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-10, 10, (k, d))
    y = rng.integers(0, k, n)
    return (centers[y] + rng.standard_normal((n, d))).astype(np.float32), y


def test_kmeans_on_card_matches_cpu_from_init(cuda):
    X, _ = _blobs(20000, 10, 6, 3)
    init = X[:6].copy()
    card = KMeans(n_clusters=6, init=init).fit(X)
    with config_context(device="cpu"):
        host = KMeans(n_clusters=6, init=init).fit(X)
    assert card.n_iter_ == host.n_iter_
    np.testing.assert_array_equal(card.labels_, host.labels_)
    np.testing.assert_allclose(card.cluster_centers_, host.cluster_centers_,
                               rtol=1e-5, atol=1e-5)
    assert card.inertia_ == pytest.approx(host.inertia_, rel=1e-5)


#: the kernels each estimator path launches on the card
_PATH_KERNELS = {
    "full": ("lloyd_iter", "fused_argmin_min", "fused_rowwise_min",
             "fused_argmin_weight"),
    "bounded": ("fused_argmin_min2", "fused_argmin_min", "fused_rowwise_min",
                "fused_argmin_weight"),
    "sketched": ("fused_argmin_min2", "fused_argmin_min_sketched",
                 "fused_argmin_min", "fused_rowwise_min",
                 "fused_argmin_weight"),
}


def test_kmeans_parallel_on_card_uses_every_kernel(cuda):
    X, y = _blobs(50000, 20, 8, 4)
    _kernels.reset_launches()
    km = KMeans(n_clusters=8, random_state=0).fit(X)
    pred = km.predict(X)
    assert all(_kernels.launches[k] > 0 for k in _PATH_KERNELS["full"]), \
        _kernels.launches
    np.testing.assert_array_equal(pred, km.labels_)
    # one cluster per true blob
    pairs = {(int(a), int(b)) for a, b in zip(y, pred)}
    assert len(pairs) == 8
    again = KMeans(n_clusters=8, random_state=0).fit(X)
    np.testing.assert_array_equal(again.cluster_centers_, km.cluster_centers_)


def _min2_sketched_pairs(X, Y, mask, need, x2):
    """(kernel, plain) output pairs of K5 and of the sketched assignment
    (K2 with an external |x|²), with and without row_need."""
    for rn in (None, need):
        yield (fd.fused_argmin_min2(X, Y, mask, kernel="cuda", row_need=rn),
               fd.fused_argmin_min2(X, Y, mask, kernel="torch", row_need=rn))
        yield (fd.fused_argmin_min_sketched(X, Y, mask=mask, x2=x2,
                                            kernel="cuda", row_need=rn),
               fd.fused_argmin_min_sketched(X, Y, mask=mask, x2=x2,
                                            kernel="torch", row_need=rn))


@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (533, 37, 13), (129, 7, 3),
                                   (3 * 1024 + 77, 8, 41), (300, 40, 130)])
def test_min2_and_sketched_kernels_bitexact_int_valued(cuda, n, m, d):
    rng = np.random.default_rng(n * m + d)
    X, Y = _ints(rng, (n, d), cuda), _ints(rng, (m, d), cuda)
    mask = torch.as_tensor(rng.random(m) > 0.3, device=cuda)
    need = torch.zeros(n, dtype=torch.bool, device=cuda)
    need[::2 * fd._FUSED_BLK + 1] = True
    x2 = fd._row_sumsq(X) + _ints(rng, (n,), cuda, 0, 9)
    before = dict(_kernels.launches)
    for got, want in _min2_sketched_pairs(X, Y, mask, need, x2):
        assert got[0].dtype == torch.int32
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert _kernels.launches["fused_argmin_min2"] == \
        before["fused_argmin_min2"] + 2
    assert _kernels.launches["fused_argmin_min_sketched"] == \
        before["fused_argmin_min_sketched"] + 2
    # one score loop: K5's argmin and min are K2's, bit for bit
    k5 = fd.fused_argmin_min2(X, Y, mask, kernel="cuda")
    k2 = fd.fused_argmin_min(X, Y, mask, kernel="cuda")
    assert torch.equal(k5[0], k2[0]) and torch.equal(k5[1], k2[1])


def test_min2_edge_cases_on_card(cuda):
    rng = np.random.default_rng(3)
    Yb = _ints(rng, (9, 5), cuda, -4, 4)
    X = torch.cat([Yb, Yb, Yb])
    a, b, s = fd.fused_argmin_min2(X, torch.cat([Yb, Yb]), kernel="cuda")
    assert int(a.max()) < 9 and torch.equal(b, s)  # the duplicate ties
    X, Y = _ints(rng, (300, 5), cuda), _ints(rng, (8, 5), cuda)
    _, b, s = fd.fused_argmin_min2(X, Y[:1], kernel="cuda")
    assert torch.isfinite(b).all() and torch.isinf(s).all()
    none = torch.zeros(8, dtype=torch.bool, device=cuda)
    a, b, s = fd.fused_argmin_min2(X, Y, none, kernel="cuda")
    assert (a == 0).all() and torch.isinf(b).all() and torch.isinf(s).all()
    n = 3 * fd._FUSED_BLK + 5
    X = _ints(rng, (n, 20), cuda)
    need = torch.zeros(n, dtype=torch.bool, device=cuda)
    need[fd._FUSED_BLK + 3] = True
    ev = fd.row_block_evaluated(need)
    got = fd.fused_argmin_min2(X, Y[:, :1].expand(8, 20).contiguous(),
                               kernel="cuda", row_need=need)
    assert all((t[~ev] == 0).all() for t in got)


@pytest.mark.parametrize("algorithm", ["bounded", "sketched"])
def test_bounded_and_sketched_paths_on_card(cuda, algorithm):
    X, y = _blobs(70000, 41, 8, 5)
    _kernels.reset_launches()
    km = KMeans(n_clusters=8, random_state=0, algorithm=algorithm).fit(X)
    pred = km.predict(X)
    assert all(_kernels.launches[k] > 0 for k in _PATH_KERNELS[algorithm]), \
        _kernels.launches
    assert _kernels.launches["lloyd_iter"] == 0
    np.testing.assert_array_equal(pred, km.labels_)
    assert len({(int(a), int(b)) for a, b in zip(y, pred)}) == 8
    if algorithm == "bounded":
        # the full loop runs the single-pass kernel, which sums each
        # cluster's ~9000 rows in another order than the one-hot M-step:
        # centers agree to rtol 1e-5, partition and n_iter exactly
        full = KMeans(n_clusters=8, random_state=0).fit(X)
        assert full.n_iter_ == km.n_iter_
        np.testing.assert_array_equal(full.labels_, km.labels_)
        np.testing.assert_allclose(full.cluster_centers_,
                                   km.cluster_centers_, rtol=1e-5, atol=1e-5)


def test_bounded_loop_matches_two_pass_loop_on_card(cuda):
    X, _ = _blobs(60000, 12, 6, 6)
    Xt = torch.as_tensor(X, device=cuda)
    w = torch.ones(60000, device=cuda)
    c0 = Xt[:6].clone()
    co, _, no, so = core.lloyd_loop(Xt, w, c0, 1e-6, max_iter=50,
                                    kernel="cuda")
    cb, ib, nb, sb, lb, _ = core.lloyd_loop_bounded(Xt, w, c0, 1e-6,
                                                    max_iter=50,
                                                    kernel="cuda")
    assert torch.equal(co, cb) and no == nb and float(so) == float(sb)
    assert float(ib) == float(core.compute_inertia(Xt, w, co, kernel="cuda"))
    assert torch.equal(lb, core.predict_labels(Xt, co, kernel="cuda"))


# ---------------------------------------------------------------------------
# K6: the SpMV kernel and its autograd Function
# ---------------------------------------------------------------------------


def _ell_ints(rng, n, k, d, dev, lo=-8, hi=8):
    """An integer-valued container with every awkward slot: duplicate
    columns in a row, a hot column shared by every row, and value-0
    padded slots at column 0."""
    cols = rng.integers(0, d, (n, k)).astype(np.int32)
    vals = rng.integers(lo, hi, (n, k)).astype(np.float32)
    if k >= 2:
        cols[:, 1] = cols[:, 0]  # duplicates sum
    if k >= 3:
        cols[:, 2] = d - 1  # one hot column
    if k >= 4:
        cols[:, -1] = 0  # padding
        vals[:, -1] = 0.0
    return sps.SparseRows(torch.as_tensor(vals, device=dev),
                          torch.as_tensor(cols, device=dev), d)


def _routes(k, d, pullback):
    """Every route the wrappers can be told to take: L2 (cluster 0) and
    each cluster the direction is built for whose shared memory holds the
    d-vector."""
    return [0] + [c for c in sps._PLAN_CLUSTERS[pullback]
                  if sps._fits(k, d, c, pullback)]


def _forward_launches():
    return _kernels.launches["spmv"] + _kernels.launches["spmv_l2"]


@pytest.mark.parametrize("n,k,d", [(1, 1, 7), (1, 101, 100_001),
                                   (1_000_003, 101, 100_001), (5000, 1, 7),
                                   (4097, 3, 7), (777, 17, 100_001),
                                   (2048, 64, 7), (33, 101, 7),
                                   (301, 513, 5_003), (1_001, 512, 9_001)])
def test_spmv_kernel_bitexact_int_valued(cuda, n, k, d):
    rng = np.random.default_rng(n + k + d)
    A = _ell_ints(rng, n, k, d, cuda)
    v = _ints(rng, (d,), cuda, -4, 4)
    before = _forward_launches()
    got = sps.matvec(A, v, kernel="cuda")
    assert got.dtype == torch.float32 and got.shape == (n,)
    assert torch.equal(got, sps.matvec(A, v, kernel="torch"))
    assert torch.equal(got, sps.spmv(A, v))  # 'auto' on the card: K6
    assert _forward_launches() == before + 2
    which = "spmv" if sps.dvector_plan(n, k, d) else "spmv_l2"
    assert _kernels.launches[which] >= 2


#: a d on each side of every boundary of the plan at k = 101 (forward:
#: 2 x 2 staging tiles of 20 rows; pullback: none), n large enough for
#: the plan to fill shared memory, ragged
_FWD = 232_448 // 4 - 2 * 2 * 20 * 101
_BWD = 232_448 // 4
_BOUNDARY = [(80_003, 101, d, pull) for pull, ds in (
    (False, (_FWD, _FWD + 1, 2 * _FWD, 2 * _FWD + 1)),
    (True, (_BWD, _BWD + 1, 2 * _BWD, 2 * _BWD + 1, 4 * _BWD,
            4 * _BWD + 1))) for d in ds]


@pytest.mark.parametrize("n,k,d,pullback", _BOUNDARY + [
    (40_001, 32, 30_011, False), (40_001, 32, 30_011, True),
    (9_999, 128, 250_007, False), (9_999, 128, 250_007, True),
    (3001, 5, 777, True), (2049, 3, 8 * _BWD, True),
    (2049, 1, 8 * _BWD + 1, True)])
def test_spmv_kernels_bitexact_on_every_route(cuda, n, k, d, pullback):
    """Forward or pullback through the plan's route and through every
    route that fits (L2, each cluster), bit for bit against the plain version on integer data; the
    forward twice for its own bits. Rows of zeros and a hot column are in
    the container."""
    rng = np.random.default_rng(n + k + d)
    A = _ell_ints(rng, n, k, d, cuda, -4, 4)
    A.values[::7] = 0.0
    A.cols[::7] = 0
    x = _ints(rng, (n if pullback else d,), cuda, -2, 2)
    for c in [None] + _routes(k, d, pullback):
        if pullback:
            got = sps._pullback_cuda(A.values, A.cols, x, d, cluster=c)
            want = sps._pullback_ref(A.values, A.cols, x, d)
        else:
            got = sps._spmv_cuda(A.values, A.cols, x, cluster=c)
            want = sps._spmv_ref(A.values, A.cols, x)
            assert torch.equal(got, sps._spmv_cuda(A.values, A.cols, x,
                                                   cluster=c))
        assert torch.equal(got, want), c


def test_plan_constants_match_the_kernels(cuda):
    """The Python plan's tile geometry is the C source's."""
    from dask_ml_tpu_torch._kernels import build

    lib = build.load("spmv")
    for k in (1, 2, 3, 4, 5, 31, 32, 100, 101, 128, 255, 256, 511, 512):
        assert lib.dml_spmv_tile_rows(k) == sps._tile_rows(k)
    assert lib.dml_spmv_tile_rows(sps._MAX_TILE_K + 1) == 0
    # the cell fits a cluster of 2 both ways, with 124 bytes to spare
    assert sps._fits(101, 100_001, 2, False)
    assert not sps._fits(101, 100_001, 1, True)


def test_spmv_forward_repeats_its_bits_on_float_data(cuda):
    g = torch.Generator(device=cuda)
    g.manual_seed(0)
    n, k, d = 300_007, 101, 100_001
    vals = torch.randn((n, k), generator=g, device=cuda)
    cols = torch.randint(0, d, (n, k), dtype=torch.int32, generator=g,
                         device=cuda)
    v = torch.randn(d, generator=g, device=cuda)
    assert sps.dvector_plan(n, k, d) == 2
    for c in (None, 0, 2):
        first = sps._spmv_cuda(vals, cols, v, cluster=c)
        assert torch.equal(first, sps._spmv_cuda(vals, cols, v, cluster=c))
        ref = sps._spmv_ref(vals, cols, v)
        scale = sps._spmv_ref(vals.abs(), cols, v.abs())
        assert bool(((first - ref).abs() <= k * 2.0 ** -23 * scale).all())


@pytest.mark.parametrize("n,k,d", [(300_007, 101, 100_001),
                                   (200_003, 101, 30_011),
                                   (150_001, 33, 4 * _BWD + 1),
                                   (5_001, 3, 7), (1, 101, 100_001)])
def test_pullback_repeats_its_bits_on_float_data(cuda, n, k, d):
    """Five calls on the same float input give the same bits, on every
    route that fits (the cluster route, and beyond it device memory), and
    every route gives the bits of every other: the products are added as
    fixed-point integers. The bits also stay close to the plain version's
    float sums."""
    g = torch.Generator(device=cuda)
    g.manual_seed(n + k)
    vals = torch.randn((n, k), generator=g, device=cuda)
    cols = torch.randint(0, d, (n, k), dtype=torch.int32, generator=g,
                         device=cuda)
    cols[:, -1] = d - 1  # a hot column, as the intercept is
    r = torch.randn(n, generator=g, device=cuda) / n
    first = sps._pullback_cuda(vals, cols, r, d)
    for c in _routes(k, d, True):
        for _ in range(5):
            assert torch.equal(sps._pullback_cuda(vals, cols, r, d,
                                                  cluster=c), first), c
    want = sps._pullback_ref(vals.double(), cols, r.double(), d)
    scale = sps._pullback_ref(vals.abs().double(), cols, r.abs().double(), d)
    count = sps._pullback_ref((vals != 0).double(), cols,
                              torch.ones_like(r, dtype=torch.float64), d)
    # within the f32 rounding of the sum of each column's products
    assert bool(((first.double() - want).abs()
                 <= count * 2.0 ** -23 * scale + 1e-30).all())


def test_pullback_bound_follows_the_values(cuda):
    """The bound on |values| kept on the tensor is dropped when the tensor
    is written to: after a first call, a value of 2^40 (whose fixed point
    under the first call's scale would overflow 64 bits) sums to the plain
    version's 2^40; a NaN in r makes every column NaN."""
    vals = torch.ones((1000, 4), device=cuda)
    cols = torch.zeros((1000, 4), dtype=torch.int32, device=cuda)
    r = torch.ones(1000, device=cuda)
    assert float(sps._pullback_cuda(vals, cols, r, 3)[0]) == 4000.0
    vals[0, 0] = 2.0 ** 40
    got = sps._pullback_cuda(vals, cols, r, 3)
    assert torch.equal(got, sps._pullback_ref(vals, cols, r, 3))
    r[0] = float("nan")
    assert bool(torch.isnan(sps._pullback_cuda(vals, cols, r, 3)).all())


@pytest.mark.parametrize("n,k,d", [(64, 101, 7), (257, 101, 100_001),
                                   (1000, 1, 50), (150_001, 101, 100_001)])
def test_spmv_gradient_through_kernel(cuda, n, k, d):
    """Values in {-1, 0, 1}: every sum of the gradient stays an exact
    integer, so neither pullback can round. The
    kernel path runs K6 and its pullback kernel, the plain path neither."""
    rng = np.random.default_rng(n + k)
    A = _ell_ints(rng, n, k, d, cuda, -1, 2)
    v0 = _ints(rng, (d,), cuda, -1, 2)
    grads = []
    for kernel in ("cuda", "torch"):
        _kernels.reset_launches()
        vals = A.values.clone().requires_grad_(True)
        v = v0.clone().requires_grad_(True)
        out = sps.matvec(sps.SparseRows(vals, A.cols, d), v, kernel=kernel)
        (out ** 2).sum().backward()
        grads.append((v.grad, vals.grad))
        ran = sum(_kernels.launches.values())
        assert ran == (2 if kernel == "cuda" else 0)
    assert torch.equal(grads[0][0], grads[1][0])
    assert torch.equal(grads[0][1], grads[1][1])
    # an expanded cotangent (the backward of a plain sum) reaches the
    # kernel contiguous
    v = v0.clone().requires_grad_(True)
    sps.matvec(A, v).sum().backward()
    assert torch.equal(v.grad, sps.pullback(
        A, torch.ones(n, device=cuda), kernel="torch"))


def test_spmv_gradcheck_against_plain_path_on_float_data(cuda):
    """The autograd Function's gradients in v through the kernels against
    the plain path's on float data: both sum the same f32 products in
    other orders, rtol 1e-5 against the gradient's scale."""
    g = torch.Generator(device=cuda)
    g.manual_seed(1)
    n, k, d = 200_003, 33, 60_001
    A = sps.SparseRows(
        torch.randn((n, k), generator=g, device=cuda),
        torch.randint(0, d, (n, k), dtype=torch.int32, generator=g,
                      device=cuda), d)
    v0 = torch.randn(d, generator=g, device=cuda)
    w = torch.randn(n, generator=g, device=cuda)
    grads = []
    for kernel in ("cuda", "torch"):
        v = v0.clone().requires_grad_(True)
        (torch.sigmoid(sps.spmv(A, v, kernel=kernel)) * w).sum().backward()
        grads.append(v.grad)
    scale = float(grads[1].abs().max())
    assert float((grads[0] - grads[1]).abs().max()) <= 1e-5 * scale
    got, want = sps.pullback(A, w), sps.pullback(A, w, kernel="torch")
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


def test_spmv_kernel_refuses_bad_input(cuda):
    rng = np.random.default_rng(0)
    A = _ell_ints(rng, 100, 8, 20, cuda)
    v = torch.zeros(20, device=cuda)
    r = torch.zeros(100, device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        sps._spmv_cuda(A.values.T.contiguous().T, A.cols, v)
    with pytest.raises(ValueError, match="int32"):
        sps._spmv_cuda(A.values, A.cols.long(), v)
    with pytest.raises(ValueError, match="one device"):
        sps._spmv_cuda(A.values, A.cols, v.cpu())
    with pytest.raises(ValueError, match="contiguous"):
        sps._pullback_cuda(A.values, A.cols.T.contiguous().T, r, 20)
    with pytest.raises(ValueError, match="contiguous"):
        sps._pullback_cuda(A.values, A.cols, torch.zeros(
            200, device=cuda)[::2], 20)
    with pytest.raises(ValueError, match="one device"):
        sps._pullback_cuda(A.values, A.cols, r.cpu(), 20)
    with pytest.raises(ValueError, match="one r per row"):
        sps._pullback_cuda(A.values, A.cols, r[:50].contiguous(), 20)
    # a shape that does not fit the cluster asked for, and a cluster size
    # the direction is not built for, are refused at launch
    big = torch.zeros(500_009, device=cuda)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sps._spmv_cuda(A.values, A.cols % 20, big, cluster=2)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sps._spmv_cuda(A.values, A.cols, v, cluster=4)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sps._pullback_cuda(A.values, A.cols, r, 2_000_003, cluster=4)
    with pytest.raises(RuntimeError, match="CUDA error"):
        sps._pullback_cuda(A.values, A.cols, r, 20, cluster=8)
    # the public pullback takes any r the plain version takes
    r64 = torch.arange(200, dtype=torch.float64, device=cuda)[::2]
    assert torch.equal(
        sps.pullback(sps.SparseRows(A.values, A.cols, 20), r64),
        sps.pullback(sps.SparseRows(A.values, A.cols, 20), r64,
                     kernel="torch"))


def test_spmv_refuses_a_vector_of_another_length_before_launch(cuda):
    """K6 trusts the stored columns, so a ``v`` shorter than the container
    would be read past its end: the wrapper refuses any length but ``A.d``
    before a launch, and so does predict on rows of another width."""
    rng = np.random.default_rng(3)
    A = _ell_ints(rng, 100, 8, 10, cuda)
    _kernels.reset_launches()
    for length in (6, 14):
        v = torch.ones(length, device=cuda)
        for fn in (sps.spmv, sps.matvec):
            with pytest.raises(ValueError, match=r"shape \(10,\)"):
                fn(A, v, kernel="cuda")
    assert sum(_kernels.launches.values()) == 0
    X, y = make_sparse_classification(2_000, 10, 0.3, random_state=2)
    est = LogisticRegression(solver="lbfgs", max_iter=3).fit(X, y)
    Xw, _ = make_sparse_classification(50, 14, 0.3, random_state=3)
    _kernels.reset_launches()
    with pytest.raises(ValueError, match="fitted with 10"):
        est.predict(Xw)
    assert sum(_kernels.launches.values()) == 0


def test_sparse_lbfgs_fit_on_card(cuda):
    """A small sparse L-BFGS fit through the facade: the kernel path
    launches K6 and its pullback kernel, and agrees with the plain path on
    the card and with the CPU fit (rtol 1e-4: the pullbacks' atomics and
    the kernel's summation order move the last bits)."""
    X, y = make_sparse_classification(20_000, 2_000, 0.01, random_state=1)
    _kernels.reset_launches()
    est = LogisticRegression(solver="lbfgs", max_iter=10).fit(X, y)
    assert _kernels.launches["spmv"] > 0  # 21 slots a row: one block
    assert _kernels.launches["spmv_pullback"] > 0
    assert est.score(X, y) > 0.6
    with config_context(device="cpu"):
        cpu = LogisticRegression(solver="lbfgs", max_iter=10).fit(X, y)
    assert cpu.n_iter_ == est.n_iter_
    np.testing.assert_allclose(est.coef_, cpu.coef_, rtol=1e-4,
                               atol=1e-4 * np.abs(cpu.coef_).max())
    Xd = sps.add_intercept_ell(X.to(cuda))
    yd = torch.as_tensor(y, device=cuda)
    w = torch.ones(20_000, device=cuda)
    mask = torch.ones(2_001, device=cuda)
    mask[-1] = 0
    b0 = torch.zeros(2_001, device=cuda)
    plain, n_plain = glm_core.lbfgs(Xd, yd, w, b0, mask, lamduh=1.0,
                                    max_iter=10, kernel="torch")
    assert n_plain == est.n_iter_
    np.testing.assert_allclose(est._coef, plain.cpu().numpy(), rtol=1e-4,
                               atol=1e-4 * np.abs(est._coef).max())


def test_sparse_admm_outer_step_kernel_against_plain(cuda):
    """One outer ADMM iteration on a container from a shared state:
    through K6 and its pullback kernel, and through the plain versions,
    within 1e-5 normwise (the pullbacks' and the Gram's float atomics
    move the last bits); the kernel run launches both kernels."""
    X, y = make_sparse_classification(20_000, 500, 0.02, random_state=4)
    Xd = sps.add_intercept_ell(X.to(cuda))
    yd = torch.as_tensor(y, device=cuda)
    w = torch.ones(20_000, device=cuda)
    mask = torch.ones(501, device=cuda)
    mask[-1] = 0
    b0 = torch.zeros(501, device=cuda)
    args = (Xd, yd, w, b0, mask)
    _, _, state, _ = glm_core.admm(*args, n_shards=2, lamduh=1.0,
                                   max_iter=2, return_state=True)
    _kernels.reset_launches()
    zc, _ = glm_core.admm(*args, n_shards=2, lamduh=1.0, max_iter=1,
                          state=state, kernel="cuda")
    assert _kernels.launches["spmv"] > 0
    assert _kernels.launches["spmv_pullback"] > 0
    zt, _ = glm_core.admm(*args, n_shards=2, lamduh=1.0, max_iter=1,
                          state=state, kernel="torch")
    assert float(torch.linalg.norm(zc - zt) / torch.linalg.norm(zt)) < 1e-5


def test_tsqr_and_its_fallback_on_card(cuda):
    from dask_ml_tpu_torch.ops import linalg

    rng = np.random.default_rng(5)
    X = torch.as_tensor(rng.standard_normal((50_000, 64), dtype=np.float32),
                        device=cuda)
    linalg.reset_tsqr_counts()
    Q, R = linalg.tsqr(X)
    assert linalg.tsqr_counts["cholqr2"] == 1
    eye = torch.eye(64, device=cuda)
    assert float(torch.abs(Q.T @ Q - eye).max()) < 1e-5
    assert float(torch.abs(Q @ R - X).max()) < 1e-4
    U, _ = np.linalg.qr(rng.standard_normal((4096, 64)))
    V, _ = np.linalg.qr(rng.standard_normal((64, 64)))
    Xi = torch.as_tensor(((U * np.logspace(0, -6, 64)) @ V.T).astype(
        np.float32), device=cuda)
    linalg.reset_tsqr_counts()
    Q, R = linalg.tsqr(Xi)
    assert linalg.tsqr_counts == {"host_reads": 1, "cholqr2": 0,
                                  "householder": 1}
    assert float(torch.abs(Q.T @ Q - eye).max()) < 1e-5
    assert float(torch.abs(Q @ R - Xi).max()) < 1e-5


def test_logistic_regression_and_pca_on_cuda_tensors(cuda):
    """The default LogisticRegression (ADMM), a multinomial fit and PCA
    fitted on tensors that lie on the card agree with the same fits on the
    CPU (rtol 1e-4: cuBLAS and the CPU's BLAS sum in other orders)."""
    from dask_ml_tpu_torch.decomposition import PCA

    rng = np.random.default_rng(6)
    X = rng.standard_normal((4_000, 10), dtype=np.float32)
    y = (X @ rng.standard_normal(10) > 0).astype(np.float32)
    y3 = np.digitize(X[:, 0], [-0.5, 0.5])
    Xc = torch.as_tensor(X, device=cuda)
    for est_kw, target in (({"solver_kwargs": {"rho": 0.1}}, y),
                           ({"multiclass": "multinomial",
                             "solver": "lbfgs"}, y3)):
        card = LogisticRegression(**est_kw).fit(Xc, target)
        with config_context(device="cpu"):
            cpu = LogisticRegression(**est_kw).fit(X, target)
        assert card.n_iter_ == cpu.n_iter_
        np.testing.assert_allclose(card.coef_, cpu.coef_, rtol=1e-4,
                                   atol=1e-4 * np.abs(cpu.coef_).max())
        np.testing.assert_array_equal(card.predict(Xc), cpu.predict(X))
    card = PCA(4, svd_solver="full").fit(Xc)
    with config_context(device="cpu"):
        cpu = PCA(4, svd_solver="full").fit(X)
    np.testing.assert_allclose(card.singular_values_, cpu.singular_values_,
                               rtol=1e-4)
    np.testing.assert_allclose(np.abs(card.components_),
                               np.abs(cpu.components_), atol=1e-4)
    Zc = card.transform(Xc)
    assert Zc.shape == (4_000, 4) and np.isfinite(Zc).all()


# ---------------------------------------------------------------------------
# the streaming tier on the card
# ---------------------------------------------------------------------------


def test_prefetched_block_overlaps_a_busy_compute_stream(cuda):
    """While a long kernel holds the compute stream, a block's copy on the
    source's own stream completes (from locked host memory), and the block
    taken afterwards equals its host block bit for bit."""
    import time

    from dask_ml_tpu_torch.parallel.stream import HostBlockSource

    rng = np.random.default_rng(7)
    X = rng.standard_normal((1 << 20, 16), dtype=np.float32)
    w = rng.random(1 << 20, dtype=np.float32)
    src = HostBlockSource((X, w), 4, prefetch=2)
    # one pass first: the caching allocator then holds the blocks' device
    # memory, and no cudaMalloc (which may wait for the device) is left in
    # the timed copies
    for b in range(4):
        src.take(b)
    torch.cuda.synchronize()
    torch.cuda._sleep(2_000_000_000)  # ~1 s of spinning on the compute stream
    t0 = time.perf_counter()
    src.start(0)
    src.start(1)
    src._inflight[1][1].synchronize()  # block 1's copy event
    copy_s = time.perf_counter() - t0
    busy = not torch.cuda.current_stream().query()
    blk = src.take(0)
    torch.cuda.synchronize()
    assert busy and copy_s < 0.5, (busy, copy_s)
    assert torch.equal(blk[0].cpu(), torch.from_numpy(X[:1 << 18]))
    assert torch.equal(blk[1].cpu(), torch.from_numpy(w[:1 << 18]))
    assert torch.equal(src.take(1)[0].cpu(),
                       torch.from_numpy(X[1 << 18:2 << 18]))
    src.close()


def test_sticky_cuda_error_is_not_retried(cuda):
    """A device-side assert leaves the context broken: through a
    RetryPolicy it propagates on the first attempt, retries == 0. Run in
    a child process, whose context it breaks."""
    import json
    import os
    import subprocess
    import sys

    code = r"""
import json, torch
from dask_ml_tpu_torch.parallel.faults import RetryPolicy
pol = RetryPolicy(max_retries=3, sleep=lambda s: None)
calls = []
def op():
    calls.append(1)
    a = torch.zeros(4, device="cuda")
    a[torch.tensor([10], device="cuda")] = 1.0  # out of range: device assert
    torch.cuda.synchronize()
try:
    pol.run(op, kind="device-put")
    out = {"raised": None}
except RuntimeError as e:
    out = {"raised": type(e).__name__, "message": str(e)[:300]}
out.update(calls=len(calls), retries=pol.retries, giveups=pol.giveups)
print(json.dumps(out))
"""
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root)
    res = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=root, env=env)
    out = json.loads(res.stdout.strip().splitlines()[-1])
    assert out["raised"] is not None and "CUDA error" in out["message"], out
    assert out["calls"] == 1 and out["retries"] == 0, out


def test_staging_buffers_released_after_discard(cuda):
    """Loader-mode blocks are staged through pinned buffers; the ones of
    copies that discard_inflight drops are released once their copies
    completed, and a closed source unregisters its host arrays."""
    import gc
    import weakref

    from dask_ml_tpu_torch.parallel import stream
    from dask_ml_tpu_torch.parallel.stream import HostBlockSource

    rng = np.random.default_rng(8)
    X = rng.standard_normal((4096, 32), dtype=np.float32)
    w = np.ones(4096, np.float32)
    src = HostBlockSource(loader=lambda b: (X[b * 1024:(b + 1) * 1024],
                                            w[b * 1024:(b + 1) * 1024]),
                          n_blocks=4)
    src.start(0)
    src.start(1)
    staged = [weakref.ref(t) for b in (0, 1) for t in src._inflight[b][2]]
    assert all(r() is not None and r().is_pinned() for r in staged)
    src.discard_inflight()
    gc.collect()
    assert src._inflight == {} and src.blocks_started == 0
    assert all(r() is None for r in staged)

    arrays = HostBlockSource((X, w), 4)
    assert X.ctypes.data in stream._registered
    blk = arrays.take(2)
    torch.cuda.synchronize()
    assert torch.equal(blk[0].cpu(), torch.from_numpy(X[2048:3072]))
    arrays.close()
    del arrays
    gc.collect()
    assert X.ctypes.data not in stream._registered


def test_streamed_admm_on_card_prefetch_and_resume(cuda, tmp_path):
    """Host-streamed ADMM on the card: prefetch 2 and 0 give the same
    bits, and a preempted fit resumes bit for bit."""
    from dask_ml_tpu_torch.parallel.faults import FaultInjector, Preempted
    from dask_ml_tpu_torch.parallel.stream import HostBlockSource

    rng = np.random.default_rng(9)
    X = rng.standard_normal((40_000, 20), dtype=np.float32)
    y = (X @ rng.standard_normal(20) > 0).astype(np.float32)
    w = np.ones(40_000, np.float32)
    kw = dict(lamduh=1.0, abstol=0.0, reltol=0.0, max_iter=3,
              return_state=True)

    def fit(prefetch, **extra):
        return glm_core.admm_streamed(
            HostBlockSource((X, y, w), 4, prefetch=prefetch,
                            fault_injector=extra.pop("inj", None)),
            4, 20, 40_000.0, **kw, **extra)

    a, b = fit(2)[2], fit(0)[2]
    for s, t in zip(a, b):
        assert torch.equal(s, t)
    path = str(tmp_path / "admm.ckpt")
    with pytest.raises(Preempted):
        fit(2, inj=FaultInjector().preempt_at(2, epoch=1),
            checkpoint_path=path)
    r = fit(2, checkpoint_path=path)[2]
    for s, t in zip(a, r):
        assert torch.equal(s, t)


def test_sparse_partial_fit_step_through_the_kernels(cuda):
    """One streaming SGD step on a CSR block, staged as a container: through
    K6 and its pullback kernel (each launched once) against the same step
    with the plain versions, within 1e-5 normwise; two runs of the kernel
    step give the same bits."""
    X, y = make_sparse_classification(50_000, 3_000, 0.01, random_state=6)
    est = LogisticRegression(solver="lbfgs", solver_kwargs={"eta0": 0.5})
    est.partial_fit(X[:25_000], y[:25_000])
    A = X[25_000:].to(cuda)
    yd = torch.as_tensor(y[25_000:], dtype=torch.float32, device=cuda)
    w = torch.ones(25_000, device=cuda)
    state = est._pf_state_device(3_000)
    got = []
    for kernel in ("cuda", "cuda", "torch"):
        step = glm_core.make_sgd_step(lamduh=1.0, eta0=0.5, kernel=kernel)
        _kernels.reset_launches()
        with torch.no_grad():
            got.append(step(state, (A, yd, w))[0])
        assert _kernels.launches["spmv"] == (kernel == "cuda")
        assert _kernels.launches["spmv_pullback"] == (kernel == "cuda")
    assert torch.equal(got[0], got[1])
    assert float(torch.linalg.norm(got[0] - got[2])
                 / torch.linalg.norm(got[2])) < 1e-5


def test_incremental_scan_reads_nothing_back(cuda):
    """The device chain of a staged X makes no host read between blocks:
    under the sync debug mode "error" any synchronizing call would raise;
    the GLM host-read counter stays 0; and it equals the partial_fit
    loop bit for bit (whole blocks: a padded remainder block sums more
    rows than the loop's short one, in another order)."""
    from dask_ml_tpu_torch import wrappers

    rng = np.random.default_rng(7)
    X = rng.standard_normal((10_000, 20)).astype(np.float32)
    y = (X[:, 0] > 0).astype(int)
    est = LogisticRegression(C=100, solver_kwargs={"eta0": 0.5})
    step, state, y_enc = est._incremental_begin(X, y)
    Xd = torch.as_tensor(X, device=cuda)
    yd = torch.as_tensor(y_enc, device=cuda)
    torch.cuda.synchronize()
    glm_core.reset_host_reads()
    torch.cuda.set_sync_debug_mode("error")
    try:
        out = wrappers.incremental_scan(step, state, Xd, yd, block_size=1000)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert glm_core.host_reads["n"] == 0
    loop = LogisticRegression(C=100, solver_kwargs={"eta0": 0.5})
    wrappers.fit(loop, X, y, block_size=1000)
    assert np.array_equal(out[0].cpu().numpy(), loop._coef)


# ---------------------------------------------------------------------------
# the softmax gradient in fixed point, and the search tier
# ---------------------------------------------------------------------------


def _float_rows(rng, n, k, d, dev):
    cols = torch.as_tensor(rng.integers(0, d, (n, k)), dtype=torch.int32,
                           device=dev)
    vals = torch.as_tensor(rng.standard_normal((n, k)), dtype=torch.float32,
                           device=dev)
    return sps.SparseRows(vals, cols, d)


def test_pullback_mat_and_matmat_backward_repeat_their_bits(cuda):
    """Float data, columns shared by many rows (where float atomics add in
    an order that changes from run to run): five calls of pullback_mat,
    and of matmat's backward, give one set of bits, within 1e-6 of a
    float64 scatter."""
    rng = np.random.default_rng(21)
    A = _float_rows(rng, 200_000, 11, 503, cuda)
    R = torch.as_tensor(rng.standard_normal((200_000, 6)),
                        dtype=torch.float32, device=cuda)
    first = sps.pullback_mat(A, R)
    for _ in range(4):
        assert torch.equal(sps.pullback_mat(A, R), first)
    B = torch.zeros((503, 6), device=cuda, requires_grad=True)
    grads = [torch.autograd.grad(sps.matmat(A, B), B, R)[0]
             for _ in range(5)]
    for g in grads:
        assert torch.equal(g, first)
    want = torch.zeros((503, 6), dtype=torch.float64, device=cuda)
    want.index_add_(0, A.cols.reshape(-1).long(),
                    (A.values.double()[:, :, None]
                     * R.double()[:, None, :]).reshape(-1, 6))
    err = float((first.double() - want).abs().max())
    assert err <= 1e-6 * float(want.abs().max())


def test_two_sparse_softmax_fits_are_bit_for_bit(cuda):
    """multinomial_lbfgs on a container twice: the same coefficients bit
    for bit (its gradient is pullback_mat's fixed point)."""
    X, _ = make_sparse_classification(60_000, 2_000, 0.01, random_state=8)
    y = np.random.default_rng(9).integers(0, 4, 60_000)
    fits = [LogisticRegression(multiclass="multinomial", solver="lbfgs",
                               max_iter=5).fit(X, y) for _ in range(2)]
    assert fits[0]._coef.shape == (4, 2_001)
    assert np.array_equal(fits[0]._coef, fits[1]._coef)


def _blob_data(rng, n, d, k):
    centers = rng.uniform(-6, 6, (k, d))
    X = centers[rng.integers(0, k, n)] + rng.standard_normal((n, d))
    return X.astype(np.float32)


def test_batched_lloyd_cells_against_plain_on_card(cuda):
    """batched_lloyd_cells through K1 and K2 against its plain version from
    the same init rows: n_iter equal, scores within 1e-5; K1 runs every
    step of every trajectory, K2 scores every member."""
    from dask_ml_tpu_torch.parallel.sharding import prepare_data

    rng = np.random.default_rng(10)
    X = _blob_data(rng, 20_000, 24, 6)
    data = prepare_data(X[:10_000], device=cuda)
    ev = prepare_data(X[10_000:], device=cuda)
    members = [(k, t) for k in (2, 3, 5, 8) for t in (1e-6, 1e-3, 1e-1)]
    idx0 = rng.permutation(10_000)[:8]
    _kernels.reset_launches()
    got = core.batched_lloyd_cells(data, members, [ev], max_iter=10,
                                   idx0=idx0)
    assert _kernels.launches["lloyd_iter"] == 4 * 10
    assert _kernels.launches["fused_argmin_min"] == len(members)
    want = core.batched_lloyd_cells(data, members, [ev], max_iter=10,
                                    idx0=idx0, kernel="torch")
    assert torch.equal(got[0].cpu(), want[0].cpu())
    np.testing.assert_allclose(got[2][0].cpu().numpy(),
                               want[2][0].cpu().numpy(), rtol=1e-5)


def test_pairwise_argmin_min_through_k2(cuda):
    """pairwise_distances_argmin_min launches K2 once and agrees with its
    plain version bit for bit on integer-valued data."""
    from dask_ml_tpu_torch.metrics import pairwise_distances_argmin_min

    rng = np.random.default_rng(11)
    X = _ints(rng, (5_001, 13), cuda)
    Y = _ints(rng, (37, 13), cuda)
    _kernels.reset_launches()
    idx, dist = pairwise_distances_argmin_min(X, Y)
    assert _kernels.launches["fused_argmin_min"] == 1
    pidx, pdist = pairwise_distances_argmin_min(X, Y, kernel="torch")
    assert idx.dtype == torch.int32
    assert torch.equal(idx, pidx) and torch.equal(dist, pdist)


def test_group_dispatch_reads_nothing_back(cuda):
    """KMeans's batched group on trusted device inputs under the sync debug
    mode "error": no host read; and a search over the same members takes
    the batched path for every cell with one bulk fetch."""
    from dask_ml_tpu_torch.model_selection import GridSearchCV, _search
    from dask_ml_tpu_torch.parallel.sharding import staging_memo

    rng = np.random.default_rng(12)
    X = _blob_data(rng, 8_000, 16, 5)
    Xt = torch.as_tensor(X[:4_000], device=cuda)
    Xe = torch.as_tensor(X[4_000:], device=cuda)
    members = [{"n_clusters": k, "tol": t} for k in (2, 4, 6)
               for t in (1e-4, 1e-2)]
    km = KMeans(init="random", max_iter=8, random_state=0)
    with staging_memo() as memo:
        memo.trust(Xt)
        memo.trust(Xe)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            out = km._batched_fit_score(Xt, None, members, [(Xe, None)])
        finally:
            torch.cuda.set_sync_debug_mode("default")
    assert out["scores"][0].is_cuda and out["scores"][0].shape == (6,)
    _search.reset_fetch_counts()
    gs = GridSearchCV(km, {"n_clusters": [2, 4, 6], "tol": [1e-4, 1e-2]},
                      cv=[(np.arange(4_000), np.arange(4_000, 8_000))],
                      refit=False, return_train_score=False).fit(X)
    assert gs.n_batched_cells_ == 6
    assert _search.fetch_counts == {"bulk": 1, "cell": 0}
    np.testing.assert_array_equal(gs.cv_results_["split0_test_score"],
                                  out["scores"][0].cpu().numpy())


def test_kernel_launches_from_many_threads(cuda):
    """K1 from 8 threads at once with another (k, d) in each thread (its
    launch sets the kernel's shared-memory attribute to that shape's
    need, then launches: the library's lock keeps the pair together) —
    every launch succeeds and gives the single-threaded bits."""
    from concurrent.futures import ThreadPoolExecutor

    rng = np.random.default_rng(13)
    X = torch.as_tensor(rng.standard_normal((20_000, 25)),
                        dtype=torch.float32, device=cuda)
    w = torch.ones(20_000, device=cuda)
    shapes = [(k, d) for k in (2, 5, 11) for d in (5, 15, 25)]
    inputs = [(X[:, :d].contiguous(), X[:k, :d].contiguous())
              for k, d in shapes]
    want = [core._lloyd_stats_cuda(Xd, w, C) for Xd, C in inputs]

    def run(i):
        Xd, C = inputs[i % len(inputs)]
        return i % len(inputs), core._lloyd_stats_cuda(Xd, w, C)

    with ThreadPoolExecutor(8) as pool:
        got = list(pool.map(run, range(40 * len(inputs))))
    torch.cuda.synchronize()
    for j, (sums, counts, inertia) in got:
        assert torch.equal(sums, want[j][0])
        assert torch.equal(counts, want[j][1])
        assert torch.equal(inertia, want[j][2])


def _sync_free(fn):
    """``fn()`` under the sync debug mode "error": a host read raises."""
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        return fn()
    finally:
        torch.cuda.set_sync_debug_mode("default")


def test_minibatch_kmeans_on_card(cuda):
    """K2 assigns every step; two fits from one seed give the same bits;
    the steps read nothing back; one update through the kernel equals the
    plain update."""
    from dask_ml_tpu_torch.cluster import MiniBatchKMeans
    from dask_ml_tpu_torch.cluster import minibatch as mb_mod

    rng = np.random.default_rng(21)
    centers = rng.uniform(-10, 10, (5, 12)).astype(np.float32)
    X = centers[rng.integers(0, 5, 30_000)] + rng.standard_normal(
        (30_000, 12), dtype=np.float32)
    _kernels.reset_launches()
    a = MiniBatchKMeans(n_clusters=5, batch_size=512, max_iter=3,
                        random_state=4).fit(X)
    assert _kernels.launches["fused_argmin_min"] >= a.n_iter_
    b = MiniBatchKMeans(n_clusters=5, batch_size=512, max_iter=3,
                        random_state=4).fit(X)
    np.testing.assert_array_equal(a.cluster_centers_, b.cluster_centers_)
    np.testing.assert_array_equal(a.labels_, b.labels_)
    Xd = torch.as_tensor(X, device=cuda)
    w = torch.ones(len(X), device=cuda)
    c0 = torch.as_tensor(a.cluster_centers_, device=cuda)
    idx = torch.randint(0, len(X), (4, 512), device=cuda)
    _sync_free(lambda: mb_mod._minibatch_steps(
        Xd, w, c0, torch.zeros(5, device=cuda), idx))
    got = mb_mod._minibatch_update(Xd[:512], w[:512], c0,
                                   torch.zeros(5, device=cuda))
    want = mb_mod._minibatch_update(Xd[:512], w[:512], c0,
                                    torch.zeros(5, device=cuda),
                                    kernel="torch")
    assert torch.equal(got[2], want[2])
    torch.testing.assert_close(got[0], want[0], rtol=1e-6, atol=1e-6)


def test_batched_rung_reads_nothing_back(cuda):
    """A batched successive-halving rung through ``batched_rung`` under
    the sync debug mode "error", and a search whose records unpickle on
    the host."""
    import pickle

    from dask_ml_tpu_torch.model_selection import SuccessiveHalvingSearchCV
    from dask_ml_tpu_torch.model_selection import _incremental as inc

    rng = np.random.default_rng(22)
    X = rng.standard_normal((4_000, 6), dtype=np.float32)
    y = (X @ rng.standard_normal(6) > 0).astype(np.int64)
    orig = inc.batched_rung
    calls = []

    def guarded(*a, **k):
        calls.append(1)
        return _sync_free(lambda: orig(*a, **k))

    inc.batched_rung = guarded
    try:
        sh = SuccessiveHalvingSearchCV(
            LogisticRegression(solver="gradient_descent"),
            {"C": [0.1, 1.0, 10.0, 100.0]}, n_initial_parameters="grid",
            aggressiveness=2, max_epochs=4, n_blocks=4,
            random_state=0).fit(X, y)
    finally:
        inc.batched_rung = orig
    assert len(calls) == len(sh.rung_table_) == 3
    assert all(r["n_builds"] == 0 for r in sh.rung_compile_stats_[1:])
    assert isinstance(pickle.loads(pickle.dumps(sh.best_estimator_))._coef,
                      np.ndarray)


def test_gaussian_nb_on_card_matches_cpu(cuda):
    from dask_ml_tpu_torch.naive_bayes import GaussianNB

    rng = np.random.default_rng(23)
    X = rng.standard_normal((20_000, 7), dtype=np.float32) + 100.0
    y = rng.integers(0, 3, 20_000)
    a = GaussianNB().fit(X, y)
    with config_context(device="cpu"):
        b = GaussianNB().fit(X, y)
        pb = b.predict_proba(X)
    np.testing.assert_allclose(a.theta_, b.theta_, rtol=1e-6)
    np.testing.assert_allclose(a.var_, b.var_, rtol=1e-4)
    np.testing.assert_allclose(a.predict_proba(X), pb, rtol=1e-4,
                               atol=1e-6)


def test_generators_on_card_repeat_their_bits(cuda):
    from dask_ml_tpu_torch import datasets

    for make in (datasets.make_blobs, datasets.make_classification,
                 datasets.make_regression, datasets.make_counts):
        a, b = make(random_state=5), make(random_state=5)
        assert a[0].is_cuda
        for ta, tb in zip(a, b):
            assert torch.equal(ta, tb)
    X, _ = datasets.make_regression(n_samples=5_000, n_features=40,
                                    effective_rank=5, random_state=1)
    assert X.is_cuda and torch.isfinite(X).all()


def test_k_means_functions_launch_their_kernels(cuda):
    from dask_ml_tpu_torch import cluster

    rng = np.random.default_rng(24)
    centers = rng.uniform(-10, 10, (4, 9)).astype(np.float32)
    X = centers[rng.integers(0, 4, 20_000)] + rng.standard_normal(
        (20_000, 9), dtype=np.float32)
    _kernels.reset_launches()
    c = cluster.init_scalable(X, 4, random_state=0)
    assert _kernels.launches["fused_rowwise_min"] > 0
    assert _kernels.launches["fused_argmin_weight"] > 0
    _kernels.reset_launches()
    centers_, labels, inertia = cluster.k_means(X, 4, random_state=0)
    assert _kernels.launches["lloyd_iter"] > 0
    np.testing.assert_allclose(cluster.evaluate_cost(X, centers_), inertia,
                               rtol=1e-5)
    np.testing.assert_allclose(
        cluster.compute_inertia(X, labels, centers_), inertia, rtol=1e-5)
    assert c.shape == (4, 9)


# ---------------------------------------------------------------------------
# the bf16 cases of K1-K6 (the precision tier)
# ---------------------------------------------------------------------------


def _grid(rng, shape, dev):
    """Values on a 1/256 grid with up to ten significant bits: bf16 rounds
    them, and products of bf16 operands and short sums stay exact."""
    return torch.as_tensor(rng.integers(-512, 512, shape) / 256.0,
                           dtype=torch.float32, device=dev)


def _fused_f32_direct(X, Yf, y2, mask, epi, need=None, x2=None, w=None):
    """The f32 fused kernel on X with the given (already rounded) targets
    and |y|² (from the original targets), through the C entry: the
    function the bf16 kernel must equal on ``X.float()``."""
    from dask_ml_tpu_torch._kernels import build

    lib = build.load("fused_distance")
    n, d = X.shape
    m = Yf.shape[0]
    dev = X.device
    maskf = (torch.ones(m, device=dev) if mask is None
             else mask.to(torch.float32).contiguous())
    am = torch.empty(n, dtype=torch.int32, device=dev)
    mn = torch.empty(n, device=dev)
    mn2 = torch.empty(n, device=dev)
    part = torch.empty((m, -(-n // lib.dml_fused_rows_per_block())),
                       device=dev)
    cw = torch.empty(m, device=dev)
    gneed = (None if need is None
             else fd._group_need(need).to(torch.uint8).contiguous())

    def ptr(t):
        return None if t is None else t.data_ptr()

    code = fd._EPILOGUES[epi][0]
    build.check(lib.dml_fused_distance(
        code, X.data_ptr(), 0, Yf.data_ptr(), y2.data_ptr(), maskf.data_ptr(),
        ptr(gneed), fd._FUSED_BLK, ptr(x2), ptr(w), n, m, d, am.data_ptr(),
        mn.data_ptr(), mn2.data_ptr(), part.data_ptr(), cw.data_ptr(),
        build.stream_of(X)), "f32 kernel")
    return {"min": (mn,), "argmin_min": (am, mn), "argmin_weight": (am, cw),
            "argmin_min2": (am, mn, mn2)}[epi]


def _bf16_fused_all(X16, Y, mask, w, need):
    """Every epilogue of the bf16 kernel: (name, kernel outputs, plain
    outputs, f32 kernel on the widened X)."""
    Yr = Y.to(torch.bfloat16).float().contiguous()
    y2 = fd._row_sumsq(Y).contiguous()
    Xw = X16.float().contiguous()
    out = []
    for epi, call in (
            ("min", lambda k: (fd.fused_rowwise_min(X16, Y, mask, kernel=k,
                                                    row_need=need),)),
            ("argmin_min", lambda k: fd.fused_argmin_min(X16, Y, mask,
                                                         kernel=k)),
            ("argmin_weight", lambda k: fd.fused_argmin_weight(
                X16, w, Y, mask, kernel=k)),
            ("argmin_min2", lambda k: fd.fused_argmin_min2(
                X16, Y, mask, kernel=k, row_need=need))):
        direct = _fused_f32_direct(
            Xw, Yr, y2, mask, epi,
            need=need if epi in ("min", "argmin_min2") else None,
            w=w if epi == "argmin_weight" else None)
        out.append((epi, call("cuda"), call("torch"), direct))
    return out


@pytest.mark.parametrize("n,m,d", [(1, 1, 1), (533, 37, 13), (129, 7, 3),
                                   (2000, 329, 50), (300, 40, 130),
                                   (4097, 8, 41), (3001, 80, 50)])
def test_bf16_fused_kernels_bitexact_int_valued(cuda, n, m, d):
    """bf16 X (integers) and targets that bf16 rounds: the kernel equals
    its plain version bit for bit in every epilogue, with a mask and a
    row_need that skips groups, and counts under the ``_bf16`` names."""
    rng = np.random.default_rng(n + m + d)
    X16 = _ints(rng, (n, d), cuda).to(torch.bfloat16)
    Y = _grid(rng, (m, d), cuda)
    w = _ints(rng, (n,), cuda, 0, 5)
    mask = torch.as_tensor(rng.random(m) > 0.3, device=cuda)
    mask[0] = True
    need = torch.as_tensor(rng.random(n) > 0.7, device=cuda)
    before = dict(_kernels.launches)
    for epi, got, want, direct in _bf16_fused_all(X16, Y, mask, w, need):
        for a, b, c in zip(got, want, direct):
            assert torch.equal(a, b), epi
            assert torch.equal(a, c), epi
    for name in ("fused_rowwise_min", "fused_argmin_min",
                 "fused_argmin_weight", "fused_argmin_min2"):
        assert _kernels.launches[name + "_bf16"] == before[name + "_bf16"] + 1
        assert _kernels.launches[name] == before[name]
    ga, gm = fd.fused_argmin_min_sketched(X16, Y, x2=_ints(rng, (n,), cuda,
                                                            0, 9),
                                          kernel="cuda")
    assert _kernels.launches["fused_argmin_min_sketched_bf16"] == \
        before["fused_argmin_min_sketched_bf16"] + 1


@pytest.mark.parametrize("m", [8, 80, 329])
def test_bf16_fused_kernels_equal_f32_kernel_on_float_data(cuda, m):
    """On float data the bf16 kernel is the f32 kernel run on X widened
    (targets rounded, |y|² from the original targets), bit for bit, in
    every epilogue and tile shape."""
    rng = np.random.default_rng(m)
    X16 = torch.randn(20_003, 50, device=cuda).to(torch.bfloat16)
    Y = torch.randn(m, 50, device=cuda) * 2
    w = torch.rand(20_003, device=cuda)
    mask = torch.as_tensor(rng.random(m) > 0.2, device=cuda)
    mask[0] = True
    need = torch.as_tensor(rng.random(20_003) > 0.9, device=cuda)
    for epi, got, _, direct in _bf16_fused_all(X16, Y, mask, w, need):
        for a, c in zip(got, direct):
            assert torch.equal(a, c), epi


def test_bf16_near_duplicate_centers_through_k2(cuda):
    d = 8
    base = torch.zeros(d, device=cuda)
    base[0] = 8.0
    plus = base.clone()
    plus[0] = 8.01
    X = base.repeat(16, 1).to(torch.bfloat16)
    idx, mind = fd.fused_argmin_min(X, torch.stack([plus, base]),
                                    kernel="cuda")
    assert idx.tolist() == [1] * 16 and float(mind.max()) <= 1e-2


def _lloyd_f32_direct(Xw, w, Cr, c2):
    """The f32 K1 on X widened, with the centers already rounded and |c|²
    from the original centers, through the C entry."""
    from dask_ml_tpu_torch._kernels import build

    lib = build.load("lloyd")
    n, d = Xw.shape
    k = Cr.shape[0]
    P = k * (d + 1) + 1
    part = torch.empty(lib.dml_lloyd_max_partials() * P, device=Xw.device)
    out = torch.empty(P, device=Xw.device)
    build.check(lib.dml_lloyd_iter(
        Xw.data_ptr(), 0, w.data_ptr(), Cr.data_ptr(), c2.data_ptr(), n, k,
        d, part.data_ptr(), out.data_ptr(), build.stream_of(Xw)), "f32 K1")
    acc = out[:-1].view(k, d + 1)
    return acc[:, :d], acc[:, d], out[-1]


@pytest.mark.parametrize("n,k,d,offset", [
    (1, 1, 1, 0), (533, 4, 7, 0), (1_000, 8, 50, 0), (4_099, 8, 41, 0),
    (4_099, 9, 50, 0), (2_000, 8, 110, 0), (2_000, 8, 111, 0),
    (257, 8, 397, 0), (3_001, 8, 52, 1), (3_001, 8, 50, 3)])
def test_bf16_lloyd_kernel_bitexact_int_valued(cuda, n, k, d, offset):
    """K1 on bf16 X (rows of d bf16, 2-byte aligned only with an offset)
    on integer data with centers that bf16 rounds: the sums and counts
    equal its plain version's bit for bit (tolerance 0) and the inertia
    within rtol 1e-6 (|c|^2 of such centers is not exact in f32 at large
    d, so the row minima are fractional and the two sum them in other
    orders); everything equals the f32 K1 on X widened bit for bit, and it
    repeats its bits."""
    rng = np.random.default_rng(n + k + d)
    X16 = _ints(rng, (n * d + offset,), cuda, -4, 4).to(
        torch.bfloat16)[offset:].view(n, d)
    w = _ints(rng, (n,), cuda, 0, 3)
    C = _grid(rng, (k, d), cuda)
    assert core._lloyd_cuda_supported(k, d, torch.bfloat16)
    before = _kernels.launches["lloyd_iter_bf16"]
    got = core._lloyd_stats_cuda(X16, w, C)
    assert _kernels.launches["lloyd_iter_bf16"] == before + 1
    want = core._lloyd_stats_ref(X16, w, C)
    again = core._lloyd_stats_cuda(X16, w, C)
    direct = _lloyd_f32_direct(X16.float().contiguous(), w,
                               C.to(torch.bfloat16).float().contiguous(),
                               fd._row_sumsq(C).contiguous())
    for a, c, e in zip(got, again, direct):
        assert torch.equal(a, c) and torch.equal(a, e)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    assert abs(float(got[2]) - float(want[2])) <= 1e-6 * abs(float(want[2]))


@pytest.mark.parametrize("k,d", [(8, 50), (8, 41), (9, 50), (23, 41)])
def test_bf16_lloyd_equals_f32_kernel_on_float_data(cuda, k, d):
    X16 = torch.randn(100_003, d, device=cuda).to(torch.bfloat16)
    w = torch.rand(100_003, device=cuda)
    C = torch.randn(k, d, device=cuda)
    got = core._lloyd_stats_cuda(X16, w, C)
    direct = _lloyd_f32_direct(X16.float().contiguous(), w,
                               C.to(torch.bfloat16).float().contiguous(),
                               fd._row_sumsq(C).contiguous())
    for a, e in zip(got, direct):
        assert torch.equal(a, e)


def test_bf16_lloyd_budget_holds_more(cuda):
    """The shared-memory budget counts 2-byte tiles: every (k, d) the f32
    kernel takes the bf16 one takes, and some more."""
    grid = [(k, d) for k in (1, 8, 9, 64, 128) for d in
            (1, 50, 397, 600, 900, 1400, 2000)]
    f32 = {kd for kd in grid if core._lloyd_cuda_supported(*kd)}
    b16 = {kd for kd in grid
           if core._lloyd_cuda_supported(*kd, torch.bfloat16)}
    assert f32 < b16


def _ell_bf16(rng, n, k, d, dev):
    A = _ell_ints(rng, n, k, d, dev, -4, 4)
    A.values[::7] = 0.0
    A.cols[::7] = 0
    return sps.SparseRows(A.values.to(torch.bfloat16), A.cols, d)


@pytest.mark.parametrize("n,k,d,pullback", [
    (1, 1, 7, False), (1, 101, 100_001, True), (5000, 1, 7, False),
    (4097, 3, 7, True), (777, 17, 100_001, False), (80_003, 101, 100_001,
                                                    False),
    (80_003, 101, 100_001, True), (40_001, 32, 30_011, True),
    (9_999, 128, 250_007, False), (301, 513, 5_003, True),
    (2049, 3, 8 * 58_112, True)])
def test_bf16_spmv_kernels_bitexact_on_every_route(cuda, n, k, d,
                                                   pullback):
    """K6 and K6-b on a bf16 container (integer values) with a vector that
    bf16 rounds: every route equals the plain version bit for bit, and
    counts under the ``_bf16`` names."""
    rng = np.random.default_rng(n + k + d)
    A = _ell_bf16(rng, n, k, d, cuda)
    x = _grid(rng, (n if pullback else d,), cuda)
    for c in [None] + _routes(k, d, pullback):
        if pullback:
            got = sps._pullback_cuda(A.values, A.cols, x, d, cluster=c)
            want = sps._pullback_ref(A.values, A.cols, x, d)
        else:
            got = sps._spmv_cuda(A.values, A.cols, x, cluster=c)
            want = sps._spmv_ref(A.values, A.cols, x)
        assert torch.equal(got, want), c
    names = ("spmv_pullback", "spmv_pullback_l2") if pullback else (
        "spmv", "spmv_l2")
    assert sum(_kernels.launches[nm + "_bf16"] for nm in names) > 0


def test_bf16_pullback_repeats_its_bits_on_float_data(cuda):
    """Float values and cotangent: the bf16 pullback (products rounded to
    bf16, then fixed point) gives the same bits on every route and run,
    and sits within 1e-5 of the plain f32 sum of the same rounded
    products (normwise)."""
    n, k, d = 200_003, 33, 20_011
    rng = np.random.default_rng(3)
    cols = torch.as_tensor(rng.integers(0, d, (n, k)), dtype=torch.int32,
                           device=cuda)
    vals = torch.randn(n, k, device=cuda).to(torch.bfloat16)
    r = torch.randn(n, device=cuda)
    outs = [sps._pullback_cuda(vals, cols, r, d, cluster=c)
            for c in [None] + _routes(k, d, True) for _ in range(2)]
    for o in outs[1:]:
        assert torch.equal(o, outs[0])
    plain = sps._pullback_ref(vals, cols, r, d)
    rel = float((outs[0] - plain).norm() / plain.norm())
    assert rel <= 1e-5, rel


def test_bf16_sparse_glm_step_through_the_kernels(cuda):
    """A bf16 L-BFGS fit through the facade: K6 and K6-b launch (under the
    ``_bf16`` names, and no f32 K6) and the coefficients are f32 and
    within 5e-2 of the f32 fit (the precision gate). The problem is the
    JAX flagship's at its density (0.001, 10 nonzeros a row), cut to
    200,000 × 10,000; on a 20,000 × 2,000 problem at density 0.01 the
    three-iteration bf16 and f32 fits sit 9 % apart on the CPU too (three
    L-BFGS steps from 0 are far from the optimum there)."""
    X, y = make_sparse_classification(200_000, 10_000, 0.001,
                                      random_state=42)
    f32 = LogisticRegression(solver="lbfgs", max_iter=3).fit(X, y)
    with config_context(device="cuda", precision="bf16"):
        _kernels.reset_launches()
        est = LogisticRegression(solver="lbfgs", max_iter=3).fit(X, y)
        assert _kernels.launches["spmv_bf16"] + \
            _kernels.launches["spmv_l2_bf16"] > 0
        assert _kernels.launches["spmv_pullback_bf16"] + \
            _kernels.launches["spmv_pullback_l2_bf16"] > 0
        assert _kernels.launches["spmv"] == 0
    assert est.coef_.dtype == np.float32
    rel = np.linalg.norm(est.coef_ - f32.coef_) / np.linalg.norm(f32.coef_)
    assert rel <= 5e-2, rel


@pytest.mark.parametrize("n,d,m", [(1, 3, 1), (7, 41, 1), (1000, 41, 3),
                                   (4097, 100, 1), (5, 7, 13)])
def test_bf16_pmatmul_gemm_and_cotangent_split(cuda, n, d, m):
    """``pmatmul`` on bf16 CUDA operands is one bf16-in / f32-out GEMM: on
    integer data its bits are the widened f32 product's, on float data
    within 1e-5 normwise of it, and a second call repeats its bits (2-D
    and batched 3-D). ``pullback_matmul`` splits the f32 cotangent into
    three bf16 parts: within 1e-6 normwise of the float64 ``Xᵀ r`` on
    float data, and the gradient of ``pmatmul`` is its bits."""
    from dask_ml_tpu_torch.parallel import precision as px

    rng = np.random.default_rng(n + d + m)
    Xi = _ints(rng, (n, d), cuda).to(torch.bfloat16)
    Bi = _ints(rng, (d, m), cuda).to(torch.bfloat16)
    assert torch.equal(px.pmatmul(Xi, Bi), Xi.float() @ Bi.float())
    g = torch.Generator(device=cuda)
    g.manual_seed(n + d)
    X = torch.randn(n, d, generator=g, device=cuda).to(torch.bfloat16)
    B = torch.randn(d, m, generator=g, device=cuda)
    out = px.pmatmul(X, B)
    want = X.float() @ B.to(torch.bfloat16).float()
    assert out.dtype == torch.float32
    assert float((out - want).norm() / want.norm()) <= 1e-5
    assert torch.equal(out, px.pmatmul(X, B))
    Xs = torch.stack([X, X.flip(0)])
    ob = px.pmatmul(Xs, B.expand(2, d, m).contiguous())
    assert float((ob[0] - want).norm() / want.norm()) <= 1e-5
    r = torch.randn(n, m, generator=g, device=cuda)
    pb = px.pullback_matmul(X.T, r)
    exact = X.double().T @ r.double()
    assert pb.dtype == torch.float32
    assert float((pb.double() - exact).norm() / exact.norm()) <= 1e-6
    v = torch.randn(d, generator=g, device=cuda).requires_grad_(True)
    rv = r[:, 0].contiguous()
    (grad,) = torch.autograd.grad((px.pmatmul(X, v) * rv).sum(), v)
    assert torch.equal(grad, px.pullback_matmul(X.T, rv[:, None])[:, 0])


# ---------------------------------------------------------------------------
# the sparse moments on K6-b, the scalers and the Nyström estimators
# ---------------------------------------------------------------------------


def _moment_rows(rng, n, k, d, dev, integers, mirror=False):
    """A container without duplicate slots (distinct columns a row, value-0
    padding at column 0). ``mirror``: the second half of the rows is the
    first half negated, so every column's mean is 0."""
    cols = np.argsort(rng.random((n, d - 1)), axis=1)[:, :k].astype(
        np.int32) + 1
    vals = (rng.integers(-8, 8, (n, k)).astype(np.float32) if integers
            else rng.standard_normal((n, k), dtype=np.float32) * 3 + 1)
    cols[:, -1] = 0
    vals[:, -1] = 0.0
    if mirror:
        cols[n // 2:], vals[n // 2:] = cols[:n // 2], -vals[:n // 2]
    return sps.SparseRows(torch.as_tensor(vals, device=dev),
                          torch.as_tensor(cols, device=dev), d)


@pytest.mark.parametrize("n,k,d,mirror", [(64, 9, 40, False),
                                          (65_536, 33, 700, True)])
def test_sparse_moments_through_k6b_bitexact_int_valued(cuda, n, k, d,
                                                        mirror):
    """Integer values of unit weight where every sum is exact: 64 rows (a
    mean is a multiple of 1/64, a squared deviation has at most 18
    significant bits, their sum fits f32's 24) or mirrored rows (every
    mean 0, every square an integer). The moments through the pullback
    kernel then equal the plain ``_pullback_ref`` route (a CPU copy) bit
    for bit; three launches for column_mean_var."""
    rng = np.random.default_rng(n + k)
    A = _moment_rows(rng, n, k, d, cuda, integers=True, mirror=mirror)
    w = torch.ones(n, device=cuda)
    _kernels.reset_launches()
    got = sps.column_mean_var(A, w)
    assert (_kernels.launches["spmv_pullback"]
            + _kernels.launches["spmv_pullback_l2"]) == 3
    want = sps.column_mean_var(A.to("cpu"), w.cpu())
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    got = sps.column_moments(A, w)
    want = sps.column_moments(A.to("cpu"), w.cpu())
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


def test_sparse_moments_repeat_their_bits_on_float_data(cuda):
    rng = np.random.default_rng(31)
    A = _moment_rows(rng, 200_003, 17, 3_001, cuda, integers=False)
    w = torch.as_tensor(rng.uniform(0.5, 2.0, 200_003).astype(np.float32),
                        device=cuda)
    first = sps.column_mean_var(A, w)
    for _ in range(3):
        for a, b in zip(sps.column_mean_var(A, w), first):
            assert torch.equal(a, b)
    ref = np.asarray(sps.to_dense(A.to("cpu")), dtype=np.float64)
    wh = w.cpu().double().numpy()
    mean = (wh[:, None] * ref).sum(0) / wh.sum()
    var = (wh[:, None] * (ref - mean) ** 2).sum(0) / wh.sum()
    np.testing.assert_allclose(first[1].cpu().numpy(), var, rtol=1e-5,
                               atol=1e-7)


def test_sparse_standard_scaler_on_card(cuda):
    from dask_ml_tpu_torch.preprocessing import StandardScaler

    rng = np.random.default_rng(32)
    A = _moment_rows(rng, 100_000, 21, 2_000, cuda, integers=False)
    a = StandardScaler(with_mean=False).fit(A)
    b = StandardScaler(with_mean=False).fit(A)
    np.testing.assert_array_equal(a.var_, b.var_)
    out = a.transform(A)
    assert out.values.is_cuda and out.cols is A.cols
    inv = (1.0 / torch.as_tensor(a.scale_, device=cuda))
    assert torch.equal(out.values, A.values * inv[A.cols.long()])


def test_dense_scalers_on_card_match_cpu(cuda):
    from dask_ml_tpu_torch import preprocessing as pre

    rng = np.random.default_rng(33)
    X = rng.standard_normal((50_000, 12), dtype=np.float32) * 3 + 1
    for est, attrs in ((pre.MinMaxScaler, ("data_min_", "data_max_")),
                       (pre.RobustScaler, ("center_", "scale_")),
                       (lambda: pre.QuantileTransformer(
                           n_quantiles=100, output_distribution="normal"),
                        ("quantiles_",))):
        a = est().fit(X)
        with config_context(device="cpu"):
            b = est().fit(X)
            tb = b.transform(X)
        for name in attrs:
            np.testing.assert_array_equal(getattr(a, name), getattr(b, name))
        np.testing.assert_allclose(a.transform(X), tb, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(a.inverse_transform(a.transform(X)), X,
                                   rtol=1e-4, atol=1e-4)


def test_nystrom_estimators_on_card(cuda):
    from dask_ml_tpu_torch.cluster import KernelKMeans, SpectralClustering

    rng = np.random.default_rng(34)
    centers = rng.uniform(-6, 6, (4, 5)).astype(np.float32)
    y = rng.integers(0, 4, 20_000)
    X = centers[y] + 0.5 * rng.standard_normal((20_000, 5), dtype=np.float32)
    X = (X - X.mean(0)) / X.std(0)
    _kernels.reset_launches()
    sc = SpectralClustering(n_clusters=4, n_components=100, gamma=None,
                            random_state=0).fit(X)
    assert _kernels.launches["lloyd_iter"] > 0
    assert _kernels.launches["fused_argmin_min"] > 0
    table = np.zeros((4, 4), np.int64)
    np.add.at(table, (y, sc.labels_), 1)
    assert (table > 0).sum() == 4  # each blob one label
    np.testing.assert_array_equal(sc.predict(X), sc.labels_)
    signs = rng.integers(0, 2, (20_000, 2)) * 2 - 1
    Xx = (signs * 2.0 + rng.standard_normal((20_000, 2)) * 0.6).astype(
        np.float32)
    yx = signs[:, 0] * signs[:, 1] > 0
    _kernels.reset_launches()
    kk = KernelKMeans(n_clusters=2, n_components=128, affinity="polynomial",
                      degree=2, coef0=1.0, gamma=0.5, random_state=5).fit(Xx)
    for name in ("lloyd_iter", "fused_argmin_min", "fused_rowwise_min",
                 "fused_argmin_weight"):
        assert _kernels.launches[name] > 0, name
    agree = (kk.labels_ == yx).mean()
    assert max(agree, 1 - agree) > 0.97
    np.testing.assert_array_equal(kk.predict(Xx), kk.labels_)


# ---------------------------------------------------------------------------
# the serving tier on the card
# ---------------------------------------------------------------------------


def _served_k2_models(rng):
    from dask_ml_tpu_torch.cluster import KernelKMeans, MiniBatchKMeans

    X, _ = _blobs(20_000, 12, 8, 5)
    return X, {
        "kmeans": KMeans(n_clusters=8, random_state=0).fit(X),
        "minibatch": MiniBatchKMeans(n_clusters=8, random_state=0).fit(X),
        "sketched": KMeans(n_clusters=8, algorithm="sketched",
                           random_state=0).fit(X),
        "kernel_kmeans": KernelKMeans(n_clusters=4, n_components=64,
                                      random_state=0).fit(X[:5000]),
    }


def test_served_equals_direct_on_card_for_k2_families(cuda):
    """The K2 families served on the card equal their direct predict bit
    for bit at ragged sizes; warmup loads every library the runners
    launch, after which traffic builds and loads nothing and still
    launches K2."""
    from dask_ml_tpu_torch.parallel.serving import ModelRegistry, ServingLoop
    from dask_ml_tpu_torch.parallel.shapes import track_compiles

    rng = np.random.default_rng(7)
    X, models = _served_k2_models(rng)
    reg = ModelRegistry()
    for name, est in models.items():
        reg.register(name, est)
    with ServingLoop(reg, max_batch_rows=2048) as loop:
        assert loop.device.type == "cuda" and loop._stream is not None
        loop.warmup()
        _kernels.reset_launches()
        with track_compiles() as t:
            for name, est in models.items():
                futs = [(n, loop.submit(name, X[:n]))
                        for n in (1, 31, 32, 33, 1000, 2047, 2048)]
                for n, f in futs:
                    np.testing.assert_array_equal(f.result(60),
                                                  est.predict(X[:n]))
        assert t["n_compiles"] == 0 and t["n_loads"] == 0, t
        assert _kernels.launches["fused_argmin_min"] > 0
        assert _kernels.launches["fused_argmin_min_sketched"] > 0


def test_two_replica_fleet_on_one_card_matches_one_loop(cuda):
    """Two replicas on cuda:0, each on its own stream, give the labels
    one loop gives."""
    from dask_ml_tpu_torch.parallel.fleet import ServingFleet
    from dask_ml_tpu_torch.parallel.serving import ModelRegistry, ServingLoop

    X, _ = _blobs(20_000, 12, 8, 6)
    km = KMeans(n_clusters=8, random_state=0).fit(X)
    reg = ModelRegistry()
    reg.register("km", km)
    sizes = [int(s) for s in np.random.default_rng(8).integers(1, 2049, 60)]
    with ServingLoop(reg) as loop:
        one = [f.result(60) for f in
               [loop.submit("km", X[:n]) for n in sizes]]
    with ServingFleet(reg, n_replicas=2) as fleet:
        reps = fleet._replicas
        assert [r.device for r in reps] == [torch.device("cuda", 0)] * 2
        assert reps[0].loop._stream != reps[1].loop._stream
        futs = [fleet.submit("km", X[:n]) for n in sizes]
        two = [f.result(60) for f in futs]
        assert all(r["batches"] > 0
                   for r in fleet.stats()["replicas"].values())
    for a, b in zip(one, two):
        np.testing.assert_array_equal(a, b)

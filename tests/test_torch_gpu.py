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
from dask_ml_tpu_torch.models import kmeans as core
from dask_ml_tpu_torch.ops import fused_distance as fd

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


@pytest.mark.parametrize("n,k,d", [(1, 1, 1), (1000, 8, 50), (70001, 3, 2),
                                   (5000, 13, 7)])
def test_lloyd_kernel_bitexact_int_valued(cuda, n, k, d):
    rng = np.random.default_rng(n + k)
    X = _ints(rng, (n, d), cuda, -4, 4)
    w = _ints(rng, (n,), cuda, 0, 3)
    C = _ints(rng, (k, d), cuda, -4, 4)
    got = core._lloyd_stats_cuda(X, w, C)
    want = core._lloyd_stats_ref(X, w, C)
    again = core._lloyd_stats_cuda(X, w, C)
    for a, b, c in zip(got, want, again):
        assert torch.equal(a, b) and torch.equal(a, c)


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

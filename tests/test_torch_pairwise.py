"""The PyTorch port's pairwise metrics held against the JAX package, on the
CPU.

The same numpy inputs go through ``dask_ml_tpu.ops.pairwise`` and
``dask_ml_tpu_torch.ops.pairwise`` (the port under
``config_context(device="cpu")``, where ``pairwise_distances_argmin_min``
takes the fused family's plain version). Tolerances and their reasons:

- integer-valued data: every product and partial sum of the distances
  and the linear kernel is an exactly representable integer, so both
  packages give the same bits, and ``pairwise_distances_argmin_min`` the
  same indices; the kernels with an epilogue (``gamma·x·y + coef0``, then
  a power, ``exp`` or ``tanh``) are held at rtol 1e-6 there: XLA on the
  CPU contracts the epilogue into fused multiply-adds and evaluates
  ``exp``/``tanh`` with its own math library;
- float data: the same products summed in other orders, rtol 1e-5 (with
  an absolute term where the clamp at 0 meets cancellation);
- ``euclidean_distances(X)`` has an exactly zero diagonal in both.
"""

import numpy as np
import pytest
import torch

from dask_ml_tpu.ops import pairwise as jpw
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch import metrics as tmetrics
from dask_ml_tpu_torch.ops import pairwise as tpw


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


def _ints(rng, shape, lo=-4, hi=5):
    return rng.randint(lo, hi, shape).astype(np.float32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


_DIST = ["sq_euclidean", "euclidean_distances", "linear_kernel"]
_TRANSCENDENTAL = ["polynomial_kernel", "rbf_kernel", "sigmoid_kernel"]


def _call(mod, name, X, Y):
    return getattr(mod, name)(X, Y)


@pytest.mark.parametrize("name", _DIST + _TRANSCENDENTAL)
@pytest.mark.parametrize("n,m,d", [(37, 11, 5), (64, 1, 3), (1, 9, 7)])
def test_integer_data_bit_for_bit(name, n, m, d):
    rng = np.random.RandomState(n * m + d)
    X, Y = _ints(rng, (n, d)), _ints(rng, (m, d))
    got = _np(_call(tpw, name, torch.as_tensor(X), torch.as_tensor(Y)))
    want = np.asarray(_call(jpw, name, X, Y))
    assert got.dtype == np.float32 and got.shape == (n, m)
    if name in _TRANSCENDENTAL:
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(want).max()))
    else:
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", _DIST + _TRANSCENDENTAL)
def test_float_data_within_rtol(name):
    rng = np.random.RandomState(3)
    X = rng.standard_normal((120, 16)).astype(np.float32)
    Y = rng.standard_normal((13, 16)).astype(np.float32)
    got = _np(_call(tpw, name, X, Y))
    want = np.asarray(_call(jpw, name, X, Y))
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * float(np.abs(want).max()))


@pytest.mark.parametrize("name,kw", [
    ("rbf_kernel", {"gamma": 0.3}),
    ("polynomial_kernel", {"degree": 2, "gamma": 0.5, "coef0": 0.0}),
    ("sigmoid_kernel", {"gamma": 0.1, "coef0": -1.0}),
])
def test_kernel_parameters(name, kw):
    rng = np.random.RandomState(4)
    X = _ints(rng, (20, 6))
    Y = _ints(rng, (7, 6))
    got = _np(getattr(tpw, name)(X, Y, **kw))
    want = np.asarray(getattr(jpw, name)(X, Y, **kw))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("n,d", [(50, 3), (200, 17)])
def test_euclidean_self_distance_has_an_exact_zero_diagonal(n, d):
    rng = np.random.RandomState(n)
    X = (rng.standard_normal((n, d)) * 100 + 1e3).astype(np.float32)
    got = _np(tpw.euclidean_distances(X))
    want = np.asarray(jpw.euclidean_distances(X))
    assert (np.diag(got) == 0.0).all() and (np.diag(want) == 0.0).all()
    # off the diagonal, squared distances within the cancellation floor
    # of |x|² + |y|² − 2x·y at these magnitudes
    off = ~np.eye(n, dtype=bool)
    x2 = (X.astype(np.float64) ** 2).sum(1)
    floor = 1e-6 * (x2[:, None] + x2[None, :])[off]
    assert (np.abs(got[off] ** 2 - want[off] ** 2) <= floor).all()
    assert (_np(tpw.pairwise_distances(X))[np.eye(n, dtype=bool)]
            == 0.0).all()


@pytest.mark.parametrize("n,m,d", [(257, 8, 5), (33, 1, 2), (100, 40, 9)])
def test_argmin_min_integer_bit_for_bit(n, m, d):
    rng = np.random.RandomState(n + m)
    X, Y = _ints(rng, (n, d)), _ints(rng, (m, d))
    idx, dist = tmetrics.pairwise_distances_argmin_min(X, Y)
    jidx, jdist = jpw.pairwise_distances_argmin_min(X, Y)
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(dist.numpy(), np.asarray(jdist))


def test_argmin_min_float_data():
    rng = np.random.RandomState(9)
    X = rng.standard_normal((500, 12)).astype(np.float32)
    Y = rng.standard_normal((6, 12)).astype(np.float32) * 3
    idx, dist = tpw.pairwise_distances_argmin_min(X, Y)
    jidx, jdist = jpw.pairwise_distances_argmin_min(X, Y)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(dist.numpy(), np.asarray(jdist), rtol=1e-5)


@pytest.mark.parametrize("metric", ["linear", "rbf", "polynomial", "poly",
                                    "sigmoid"])
def test_pairwise_kernels_registry(metric):
    rng = np.random.RandomState(5)
    X, Y = _ints(rng, (15, 4)), _ints(rng, (6, 4))
    kw = {"gamma": 0.2, "degree": 2, "coef0": 0.5, "ignored": 1}
    got = _np(tmetrics.pairwise_kernels(X, Y, metric=metric, **kw))
    want = np.asarray(jpw.pairwise_kernels(X, Y, metric=metric, **kw))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert set(tpw.PAIRWISE_KERNEL_FUNCTIONS) == set(
        jpw.PAIRWISE_KERNEL_FUNCTIONS)
    assert tpw._KERNEL_PARAMS == jpw._KERNEL_PARAMS


def test_registries_callables_and_errors():
    rng = np.random.RandomState(6)
    X, Y = _ints(rng, (10, 3)), _ints(rng, (4, 3))
    np.testing.assert_array_equal(
        _np(tpw.pairwise_distances(X, Y, metric="sqeuclidean")),
        np.asarray(jpw.pairwise_distances(X, Y, metric="sqeuclidean")))
    np.testing.assert_array_equal(
        _np(tpw.pairwise_distances(X, Y)),
        np.asarray(jpw.pairwise_distances(X, Y)))

    def manhattan(A, B):
        return np.abs(np.asarray(A)[:, None] - np.asarray(B)[None]).sum(-1)

    np.testing.assert_array_equal(
        tpw.pairwise_distances(X, Y, metric=manhattan), manhattan(X, Y))
    np.testing.assert_array_equal(
        tpw.pairwise_kernels(X, metric=lambda A, B: np.asarray(A) @
                             np.asarray(B).T), X @ X.T)
    with pytest.raises(ValueError, match="Unknown kernel"):
        tpw.pairwise_kernels(X, Y, metric="cosine")
    with pytest.raises(ValueError, match="Unknown distance"):
        tpw.pairwise_distances(X, Y, metric="cityblock")


def test_check_pairwise_arrays_matches_jax():
    rng = np.random.RandomState(7)
    Xi = rng.randint(0, 5, (6, 3))
    X, Y = tpw.check_pairwise_arrays(Xi, None)
    jX, jY = jpw.check_pairwise_arrays(Xi, None)
    assert X.dtype == torch.float32 and Y is X
    np.testing.assert_array_equal(X.numpy(), np.asarray(jX))
    X, Y = tpw.check_pairwise_arrays(Xi, Xi.T, precomputed=True)
    assert Y.shape == (3, 6)
    for args, kw in [((Xi, Xi[:, :2]), {}), ((Xi[0], None), {}),
                     ((Xi, Xi[:, :2].T), {"precomputed": True}),
                     ((Xi, Xi[0]), {})]:
        with pytest.raises(ValueError):
            jpw.check_pairwise_arrays(*args, **kw)
        with pytest.raises(ValueError):
            tpw.check_pairwise_arrays(*args, **kw)


def test_metrics_exports_the_pairwise_names():
    from dask_ml_tpu import metrics as jmetrics

    names = ["check_pairwise_arrays", "euclidean_distances",
             "linear_kernel", "pairwise_distances",
             "pairwise_distances_argmin_min", "pairwise_kernels",
             "polynomial_kernel", "rbf_kernel", "sigmoid_kernel"]
    for name in names:
        assert hasattr(jmetrics, name)
        assert getattr(tmetrics, name) is getattr(tpw, name)
        assert name in tmetrics.__all__


def test_kmeans_transform_still_uses_the_xy_call():
    from dask_ml_tpu_torch.cluster import KMeans

    rng = np.random.RandomState(8)
    X = rng.standard_normal((60, 4)).astype(np.float32)
    km = KMeans(n_clusters=3, init="random", random_state=0).fit(X)
    got = km.transform(X)
    want = np.sqrt(np.maximum(
        ((X[:, None, :].astype(np.float64)
          - km.cluster_centers_[None]) ** 2).sum(-1), 0))
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("rows", [1, 5, 257])
def test_distance_rows_do_not_depend_on_the_rows_around(rows):
    """A row's f32 distances and kernel values are the same bits whether
    it is computed with all of X or within a block of ``rows`` rows: on
    the CPU the products are summed in float64 and rounded once."""
    rng = np.random.RandomState(rows + 7)
    X = (rng.randn(700, 11) * 3.0).astype(np.float32)
    Y = rng.randn(17, 11).astype(np.float32)
    for name in ("euclidean_distances", "rbf_kernel", "linear_kernel"):
        full = getattr(tpw, name)(torch.as_tensor(X), torch.as_tensor(Y))
        part = getattr(tpw, name)(torch.as_tensor(X[:rows]),
                                  torch.as_tensor(Y))
        assert torch.equal(part, full[:rows]), name

"""The PyTorch port's dense generators, held to the JAX tests' property
gates on the CPU.

The generators draw from ``torch.Generator`` (Philox), which cannot
repeat ``jax.random`` (threefry), so they are held by properties (shapes,
label sets, exact coefficient recovery, the low-rank spectrum, the
conditioning, count support) and by seed determinism, never by equality
with the JAX package's numbers.
"""

import numpy as np
import pytest
import torch

from dask_ml_tpu import datasets as jdatasets
from dask_ml_tpu_torch import config_context, datasets


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


def _np(t):
    return t.numpy()


def test_make_blobs_shapes_and_labels():
    X, y = datasets.make_blobs(n_samples=80, n_features=4, centers=3,
                               random_state=0)
    assert isinstance(X, torch.Tensor) and X.device.type == "cpu"
    assert X.shape == (80, 4) and X.dtype == torch.float32
    assert y.shape == (80,) and y.dtype == torch.int32
    assert set(np.unique(_np(y))) <= {0, 1, 2}
    jX, jy = jdatasets.make_blobs(n_samples=80, n_features=4, centers=3,
                                  random_state=0)
    assert np.asarray(jX).shape == tuple(X.shape)
    assert np.asarray(jy).dtype == _np(y).dtype


def test_make_blobs_explicit_centers():
    centers = np.array([[0.0, 0.0], [100.0, 100.0]], dtype=np.float32)
    X, y, c = datasets.make_blobs(n_samples=64, n_features=2,
                                  centers=centers, cluster_std=0.01,
                                  random_state=0, return_centers=True)
    d = np.linalg.norm(_np(X) - centers[_np(y)], axis=1)
    assert d.max() < 1.0
    np.testing.assert_array_equal(_np(c), centers)


def test_make_blobs_centers_in_box():
    _, _, c = datasets.make_blobs(n_samples=10, n_features=3, centers=5,
                                  center_box=(-2.0, 3.0), random_state=4,
                                  return_centers=True)
    assert c.shape == (5, 3)
    assert float(c.min()) >= -2.0 and float(c.max()) <= 3.0


@pytest.mark.parametrize("make", ["make_blobs", "make_regression",
                                  "make_classification", "make_counts"])
def test_generators_are_deterministic_under_a_seed(make):
    f = getattr(datasets, make)
    a, b, c = f(random_state=42), f(random_state=42), f(random_state=43)
    for ta, tb in zip(a, b):
        assert torch.equal(ta, tb)
    assert not torch.equal(a[0], c[0])


@pytest.mark.parametrize("make", ["make_blobs", "make_regression",
                                  "make_classification", "make_counts"])
def test_mesh_raises(make):
    """``mesh=`` takes a port Mesh and refuses anything else."""
    with pytest.raises(TypeError, match="parallel.mesh.Mesh"):
        getattr(datasets, make)(random_state=0, mesh=object())


def test_make_regression_coef_recovery():
    X, y, coef = datasets.make_regression(
        n_samples=200, n_features=10, n_informative=3, noise=0.0,
        coef=True, random_state=1)
    np.testing.assert_allclose(_np(X) @ _np(coef), _np(y), rtol=1e-4,
                               atol=1e-3)
    assert (_np(coef) != 0).sum() == 3
    assert float(coef.max()) <= 100.0


def test_make_regression_targets_bias_and_noise():
    X, y, coef = datasets.make_regression(
        n_samples=300, n_features=6, n_informative=2, n_targets=3,
        bias=5.0, noise=0.5, coef=True, random_state=2)
    assert y.shape == (300, 3) and coef.shape == (6, 3)
    resid = _np(y) - (_np(X) @ _np(coef) + 5.0)
    assert 0.4 < resid.std() < 0.6


def test_make_regression_effective_rank_spectrum():
    """The low-rank design has ``make_low_rank_matrix``'s singular
    profile exactly: Q (from the port's tsqr) and V are orthonormal."""
    X, y = datasets.make_regression(
        n_samples=120, n_features=30, effective_rank=5, tail_strength=0.5,
        noise=0.0, random_state=0)
    assert X.shape == (120, 30) and y.shape == (120,)
    s = np.linalg.svd(_np(X), compute_uv=False)
    sind = np.arange(30) / 5.0
    expect = 0.5 * np.exp(-(sind ** 2)) + 0.5 * np.exp(-0.1 * sind)
    np.testing.assert_allclose(s, np.sort(expect)[::-1], rtol=1e-3,
                               atol=1e-4)


def test_make_regression_effective_rank_goes_through_tsqr(monkeypatch):
    from dask_ml_tpu_torch.ops import linalg

    calls = []
    orig = linalg.tsqr
    monkeypatch.setattr(linalg, "tsqr",
                        lambda *a, **k: calls.append(1) or orig(*a, **k))
    datasets.make_regression(n_samples=64, n_features=10, effective_rank=4,
                             random_state=2)
    assert calls == [1]


def test_make_regression_effective_rank_conditioning():
    Xlr, _ = datasets.make_regression(
        n_samples=200, n_features=20, effective_rank=3, tail_strength=0.05,
        random_state=1)
    Xg, _ = datasets.make_regression(n_samples=200, n_features=20,
                                     random_state=1)
    assert np.linalg.cond(_np(Xlr)) > 10 * np.linalg.cond(_np(Xg))


def test_make_classification_binary():
    X, y, beta = datasets.make_classification(
        n_samples=96, n_features=8, n_informative=4, random_state=0,
        return_coef=True)
    assert X.shape == (96, 8) and y.dtype == torch.int32
    assert set(np.unique(_np(y))) <= {0, 1}
    assert (_np(beta) != 0).sum() <= 4
    assert float(beta.max()) <= 0.0 and float(beta.min()) >= -1.0


def test_make_classification_labels_follow_the_link():
    X, y, beta = datasets.make_classification(
        n_samples=20000, n_features=5, n_informative=5, scale=4.0,
        random_state=3, return_coef=True)
    p = 1.0 / (1.0 + np.exp(-(_np(X) @ _np(beta))))
    assert abs(_np(y).mean() - p.mean()) < 0.02


def test_make_counts_nonnegative_ints():
    X, y = datasets.make_counts(n_samples=64, n_features=10,
                                n_informative=2, random_state=0)
    assert y.dtype == torch.int32 and X.shape == (64, 10)
    assert (_np(y) >= 0).all()


@pytest.mark.parametrize("make", ["make_blobs", "make_regression",
                                  "make_classification", "make_counts"])
def test_generators_draw_on_the_configured_device(make):
    X, y = getattr(datasets, make)(n_samples=32, random_state=0)[:2]
    assert X.device.type == "cpu" and y.device.type == "cpu"
    assert X.dtype == torch.float32
    assert X.shape[0] == y.shape[0] == 32

"""The PyTorch port's KMeans held against the JAX package, on the CPU.

Inputs are numpy arrays made from a seed and handed to both packages. The
port runs under ``config_context(device="cpu")``, where every kernel
wrapper takes its plain PyTorch version. Tolerances and their reasons:

- one Lloyd step on integer-valued data is bit-identical: sums and counts
  are exact integers and IEEE division is correctly rounded;
- a multi-iteration loop on float blobs from the same ``init=`` array
  gives identical labels and the same ``n_iter``, with centers and
  inertia within rtol 1e-5 (the two sum in different orders);
- k-means|| draws its random numbers from ``torch.Generator`` (Philox),
  which cannot reproduce ``jax.random`` (threefry), so it is held to the
  reference by the result: the same partition of well-separated blobs
  (ARI 1.0), inertia within 1e-4 relative, and identical refits under a
  seed.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dask_ml_tpu import config as jconfig
from dask_ml_tpu.cluster import KMeans as JKMeans
from dask_ml_tpu.interop import export_learned_attrs
from dask_ml_tpu.models import kmeans as jcore
from dask_ml_tpu.parallel.mesh import make_mesh
from dask_ml_tpu_torch import config_context, get_config, set_config
from dask_ml_tpu_torch.cluster import KMeans
from dask_ml_tpu_torch.config import reset_config
from dask_ml_tpu_torch.convert import kmeans_from_numpy
from dask_ml_tpu_torch.models import kmeans as core
from dask_ml_tpu_torch.utils.validation import check_array, check_random_state


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


@pytest.fixture(scope="module")
def mesh1():
    return make_mesh(n_devices=1)


def _blobs(n=600, d=4, k=3, seed=0, std=0.6):
    rng = np.random.RandomState(seed)
    centers = rng.uniform(-10, 10, (k, d))
    y = rng.randint(0, k, n)
    X = (centers[y] + std * rng.randn(n, d)).astype(np.float32)
    return X, y


def _ari(a, b):
    from sklearn.metrics import adjusted_rand_score

    return adjusted_rand_score(a, b)


def _t(a):
    return torch.from_numpy(np.asarray(a))


# ---------------------------------------------------------------------------
# Lloyd core against the JAX core
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jax_kernel", ["xla", "pallas"])
def test_one_lloyd_step_int_valued_bitexact(jax_kernel, mesh1):
    rng = np.random.RandomState(5)
    X = rng.randint(-6, 6, (533, 7)).astype(np.float32)
    w = rng.randint(0, 4, 533).astype(np.float32)
    c0 = X[[3, 100, 200, 400]].copy()
    jX, jw, jc = map(jnp.asarray, (X, w, c0))
    tol0 = jnp.asarray(0.0, jnp.float32)
    jc1, jin, jit, jsh = jcore.lloyd_loop_fused(
        jX, jw, jc, tol0, mesh=mesh1, max_iter=1, kernel=jax_kernel)
    c1, inert, it, sh = core.lloyd_loop_fused(_t(X), _t(w), _t(c0), 0.0,
                                              max_iter=1)
    assert it == int(jit) == 1
    np.testing.assert_array_equal(c1.numpy(), np.asarray(jc1))
    assert float(inert) == float(jin)
    assert float(sh) == float(jsh)
    # lloyd_step: the assignment + one-hot M-step form
    sc, sl, si, ss = jcore.lloyd_step(jX, jw, jc)
    tc, tl, ti, ts = core.lloyd_step(_t(X), _t(w), _t(c0))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(sc))
    np.testing.assert_array_equal(tl.numpy(), np.asarray(sl))
    assert tl.dtype == torch.int32
    assert float(ti) == float(si) and float(ts) == float(ss)
    np.testing.assert_array_equal(tc.numpy(), c1.numpy())


@pytest.mark.parametrize("jax_kernel", ["xla", "pallas"])
def test_lloyd_loop_float_blobs_matches_jax(jax_kernel, mesh1):
    X, _ = _blobs(n=700, d=5, k=4, seed=1, std=2.5)
    w = np.random.RandomState(2).uniform(0.5, 2.0, 700).astype(np.float32)
    c0 = X[:4].copy()
    tol = np.float32(1e-4 * X.var(axis=0).mean())
    jc, jin, jit, _ = jcore.lloyd_loop_fused(
        *map(jnp.asarray, (X, w, c0)), jnp.asarray(tol), mesh=mesh1,
        max_iter=60, kernel=jax_kernel)
    tc, tin, tit, _ = core.lloyd_loop_fused(_t(X), _t(w), _t(c0), tol,
                                            max_iter=60)
    assert tit == int(jit) and tit > 2
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(float(tin), float(jin), rtol=1e-5)
    np.testing.assert_array_equal(
        core.predict_labels(_t(X), tc).numpy(),
        np.asarray(jcore.predict_labels(jnp.asarray(X), jc)))


def _tb(a):
    return torch.from_numpy(np.asarray(a)).to(torch.bfloat16)


def test_one_lloyd_step_bf16_vs_jax_pallas(mesh1):
    """One Lloyd iteration on bf16 X against the JAX single-pass Pallas
    kernel in interpret mode: integer X and weights, centers on a 1/256
    grid that bf16 rounds. The kernel's bf16 case casts the centers to
    bf16 in the product, takes |c|² from the f32 centers and sums X
    widened to f32; the sums, counts and so the new centers are exact
    (bit for bit, tolerance 0); the inertia sums fractional terms in
    another order (rtol 1e-6)."""
    rng = np.random.RandomState(5)
    X = rng.randint(-6, 6, (533, 7)).astype(np.float32)
    w = rng.randint(0, 4, 533).astype(np.float32)
    c0 = (X[[3, 100, 200, 400]] + rng.randint(-128, 128, (4, 7)) / 256.0
          ).astype(np.float32)
    jc1, jin, jit, jsh = jcore.lloyd_loop_fused(
        jnp.asarray(X, jnp.bfloat16), jnp.asarray(w), jnp.asarray(c0),
        jnp.asarray(0.0, jnp.float32), mesh=mesh1, max_iter=1,
        kernel="pallas")
    c1, inert, it, sh = core.lloyd_loop_fused(_tb(X), _t(w), _t(c0), 0.0,
                                              max_iter=1)
    assert it == int(jit) == 1 and c1.dtype == torch.float32
    np.testing.assert_array_equal(c1.numpy(), np.asarray(jc1))
    assert float(inert) == pytest.approx(float(jin), rel=1e-6)
    assert float(sh) == pytest.approx(float(jsh), rel=1e-6)
    # the one plain version: K1's counts are K2's labels' bincount
    sums, counts, _ = core._lloyd_stats_ref(_tb(X), _t(w), _t(c0))
    lab = core.predict_labels(_tb(X), _t(c0))
    np.testing.assert_array_equal(
        counts.numpy(), np.bincount(lab.numpy(), weights=w, minlength=4))


def test_one_lloyd_step_bf16_offset_view_vs_jax_pallas(mesh1):
    """One bf16 Lloyd iteration with X held as a view at an odd element
    offset (d = 41, n ragged: the layout K1-bf16's ring copies as unaligned
    tile spans) against the JAX single-pass Pallas kernel in interpret
    mode: integer X and weights, centers on a 1/256 grid that bf16 rounds.
    The sums and counts, so the new centers, are exact (bit for bit,
    tolerance 0); the inertia sums fractional terms in another order (rtol
    1e-6)."""
    rng = np.random.RandomState(41)
    n, d, k = 2999, 41, 8
    X = rng.randint(-6, 6, (n, d)).astype(np.float32)
    w = rng.randint(0, 4, n).astype(np.float32)
    c0 = (X[rng.choice(n, k, replace=False)]
          + rng.randint(-128, 128, (k, d)) / 256.0).astype(np.float32)
    flat = np.concatenate([np.zeros(1, np.float32), X.ravel()])
    tX = _tb(flat)[1:].view(n, d)
    assert tX.storage_offset() == 1 and torch.equal(tX, _tb(X))
    jc1, jin, jit, _ = jcore.lloyd_loop_fused(
        jnp.asarray(X, jnp.bfloat16), jnp.asarray(w), jnp.asarray(c0),
        jnp.asarray(0.0, jnp.float32), mesh=mesh1, max_iter=1,
        kernel="pallas")
    c1, inert, it, _ = core.lloyd_loop_fused(tX, _t(w), _t(c0), 0.0,
                                             max_iter=1)
    assert it == int(jit) == 1
    np.testing.assert_array_equal(c1.numpy(), np.asarray(jc1))
    assert float(inert) == pytest.approx(float(jin), rel=1e-6)


def test_lloyd_stats_bf16_is_f32_on_rounded_operands():
    """bf16 X in the plain K1 is the f32 plain K1 on X widened and the
    centers rounded to bf16, with |c|² from the f32 centers: on float
    data, bit for bit (tolerance 0) — the identity the card's gate (bf16
    kernel == f32 kernel on the widened X) rests on."""
    X, _ = _blobs(n=400, d=5, k=3, seed=4, std=1.3)
    w = np.random.RandomState(1).uniform(0.5, 2.0, 400).astype(np.float32)
    C = X[:3] + np.float32(0.013)
    sums, counts, inert = core._lloyd_stats_ref(_tb(X), _t(w), _t(C))
    Xw, Cr = _tb(X).float(), _t(C).to(torch.bfloat16).float()
    c2 = (_t(C) * _t(C)).sum(dim=1)
    scores = c2[:, None] - 2.0 * (Cr @ Xw.T)
    best = scores.argmin(dim=0)
    oh = (torch.arange(3)[:, None] == best[None, :]).float() * _t(w)
    assert torch.equal(sums, oh @ Xw) and torch.equal(counts, oh.sum(1))
    mind = torch.clamp(scores.min(0).values + (Xw * Xw).sum(1), min=0.0)
    assert torch.equal(inert, (mind * _t(w)).sum())


@pytest.mark.parametrize("bounds", [torch.float32, torch.float64])
def test_bounded_loop_bf16_equals_fused_loop(bounds):
    """The bounded loop on bf16 X, bounds f32 (the policy's
    lloyd_bounds_dtype) or f64, equals the two-pass loop bit for bit
    (tolerance 0)."""
    X, _ = _blobs(n=3000, d=6, k=5, seed=7, std=1.0)
    w = np.ones(3000, np.float32)
    c0 = _t(X[[0, 700, 1400, 2100, 2800]])
    a = core.lloyd_loop_fused(_tb(X), _t(w), c0, 1e-6, max_iter=15)
    b = core.lloyd_loop_bounded(_tb(X), _t(w), c0, 1e-6, max_iter=15,
                                bounds_dtype=bounds)
    assert a[2] == b[2]
    assert torch.equal(a[0], b[0]) and torch.equal(a[3], b[3])
    assert torch.equal(b[4], core.predict_labels(_tb(X), b[0]))


def test_lloyd_loop_small_matches_jax():
    """lloyd_loop (the k-means|| finishing loop) against the JAX loop on
    integer data: every center is an exact integer sum over an exact
    count, so the trajectory is bit-identical; the inertia against the
    fractional final centers is rounded in another order (rtol 1e-6)."""
    rng = np.random.RandomState(6)
    cand = rng.randint(-5, 5, (90, 6)).astype(np.float32)
    cw = rng.randint(0, 4, 90).astype(np.float32)
    c0 = cand[:5].copy()
    jc, jin, jit, _ = jcore.lloyd_loop(*map(jnp.asarray, (cand, cw, c0)),
                                       jnp.asarray(0.0, jnp.float32),
                                       max_iter=20)
    tc, tin, tit, _ = core.lloyd_loop(_t(cand), _t(cw), _t(c0), 0.0,
                                      max_iter=20)
    assert tit == int(jit)
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
    assert float(tin) == pytest.approx(float(jin), rel=1e-6)


def test_empty_cluster_rule():
    """Only an exact zero count keeps the old center; weighted counts in
    (0, 1) are real clusters."""
    sums = torch.tensor([[1.0, 2.0], [0.25, 0.5], [4.0, 6.0]])
    counts = torch.tensor([0.0, 0.5, 2.0])
    old = torch.tensor([[9.0, 9.0], [8.0, 8.0], [7.0, 7.0]])
    got = core._new_centers(sums, counts, old)
    want = jcore._new_centers(jnp.asarray(sums.numpy()),
                              jnp.asarray(counts.numpy()),
                              jnp.asarray(old.numpy()))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert got[0].tolist() == [9.0, 9.0] and got[1].tolist() == [0.5, 1.0]


def test_lloyd_kernel_modes():
    X, _ = _blobs(n=100)
    w = torch.ones(100)
    c0 = _t(X[:3])
    ref = core.lloyd_loop_fused(_t(X), w, c0, 0.0, max_iter=3,
                                kernel="torch")
    auto = core.lloyd_loop_fused(_t(X), w, c0, 0.0, max_iter=3)
    assert torch.equal(ref[0], auto[0])
    with pytest.raises(ValueError, match="cuda"):
        core.lloyd_loop_fused(_t(X), w, c0, 0.0, max_iter=1, kernel="cuda")
    with pytest.raises(ValueError, match="kernel"):
        core.lloyd_loop_fused(_t(X), w, c0, 0.0, max_iter=1, kernel="xla")
    # the kernel's wrapper checks placement before it builds or launches
    with pytest.raises(ValueError, match="one CUDA device"):
        core._lloyd_stats_cuda(_t(X), w, c0)


def test_scaled_tolerance_matches_jax():
    X, _ = _blobs(n=300)
    w = np.random.RandomState(1).uniform(0, 2, 300).astype(np.float32)
    got = float(core.scaled_tolerance(_t(X), _t(w), 1e-4))
    want = float(jcore.scaled_tolerance(jnp.asarray(X), jnp.asarray(w),
                                        1e-4))
    assert got == pytest.approx(want, rel=1e-5)


# ---------------------------------------------------------------------------
# k-means||
# ---------------------------------------------------------------------------


def test_pack_hits_ascending_first_cap():
    """Candidate packing: the first `cap` hits in ascending index order,
    the same as the reference's top_k over equal scores."""
    rng = np.random.RandomState(0)
    for density in (0.0, 0.01, 0.3, 1.0):
        mask = rng.rand(1000) < density
        got = core._pack_hits(_t(mask), 64).numpy()
        hits = np.flatnonzero(mask)[:64]
        np.testing.assert_array_equal(got[:len(hits)], hits)
        assert (got[len(hits):] == 0).all()


def test_init_scalable_config_matches_jax():
    for args in ((1_000_000, 8, 2.0, None), (4000, 5, 2.0, 3),
                 (100, 3, 1.5, None)):
        assert core._init_scalable_config(*args) == \
            jcore._init_scalable_config(*args)


def test_kmeans_parallel_matches_jax_partition():
    X, y = _blobs(n=4000, d=8, k=5, seed=3, std=1.0)
    port = KMeans(n_clusters=5, random_state=0).fit(X)
    ref = JKMeans(n_clusters=5, random_state=0).fit(X)
    assert _ari(y, port.labels_) == 1.0
    assert _ari(port.labels_, ref.labels_) == 1.0
    assert port.inertia_ == pytest.approx(ref.inertia_, rel=1e-4)
    again = KMeans(n_clusters=5, random_state=0).fit(X)
    np.testing.assert_array_equal(again.cluster_centers_,
                                  port.cluster_centers_)
    np.testing.assert_array_equal(again.labels_, port.labels_)


def test_kmeans_parallel_phases_with_pruning_identical():
    """The rounds' norm-filter prune changes work, not candidates."""
    X, _ = _blobs(n=2000, d=6, k=4, seed=4)
    Xt, w = _t(X), torch.ones(2000)
    cfg = core._init_scalable_config(2000, 4, 2.0, None)
    out = []
    for prune in (True, False):
        g = check_random_state(7)
        cand, mind0, _, n_rounds = core._init_seed_phase(
            Xt, w, g, max_rounds=cfg["max_rounds"], max_cand=cfg["max_cand"])
        res = core._init_rounds_phase(
            Xt, w, cfg["l"], cand, mind0, n_rounds, g,
            max_cand=cfg["max_cand"], cap=cfg["cap"], prune=prune)
        out.append(res)
    assert torch.equal(out[0][0], out[1][0])
    assert int(out[0][1]) == int(out[1][1]) > 1
    assert int(out[0][3]) > 0  # some rows were skipped


# ---------------------------------------------------------------------------
# the estimator
# ---------------------------------------------------------------------------


def test_facade_init_array_matches_jax(mesh1):
    X, _ = _blobs(n=500, d=4, k=3, seed=8, std=2.0)
    Xq = _blobs(n=77, d=4, k=3, seed=9)[0]
    init = X[:3].copy()
    port = KMeans(n_clusters=3, init=init).fit(X)
    with jconfig.config_context(mesh=mesh1):
        ref = JKMeans(n_clusters=3, init=init).fit(X)
        ref_pred, ref_tr, ref_sc = (ref.predict(Xq), ref.transform(Xq),
                                    ref.score(Xq))
    assert port.n_iter_ == ref.n_iter_
    assert port.labels_.dtype == np.int32
    np.testing.assert_array_equal(port.labels_, ref.labels_)
    np.testing.assert_allclose(port.cluster_centers_, ref.cluster_centers_,
                               rtol=1e-5, atol=1e-5)
    assert port.inertia_ == pytest.approx(ref.inertia_, rel=1e-5)
    pred = port.predict(Xq)
    assert pred.dtype == np.int32
    np.testing.assert_array_equal(pred, ref_pred)
    np.testing.assert_allclose(port.transform(Xq), ref_tr, rtol=1e-5,
                               atol=1e-4)
    assert port.score(Xq) == pytest.approx(ref_sc, rel=1e-5)
    assert set(port.fit_phase_seconds_) == {"init", "lloyd"}
    assert port.n_features_in_ == 4


def test_kmeans_from_numpy_predicts_like_jax():
    X, _ = _blobs(n=400, d=5, k=4, seed=10)
    ref = JKMeans(n_clusters=4, random_state=0).fit(X)
    port = kmeans_from_numpy(export_learned_attrs(ref))
    Xq = _blobs(n=123, d=5, k=4, seed=11)[0]
    np.testing.assert_array_equal(port.predict(Xq), ref.predict(Xq))
    np.testing.assert_array_equal(port.labels_, ref.labels_)
    assert port.score(Xq) == pytest.approx(ref.score(Xq), rel=1e-5)
    np.testing.assert_allclose(port.transform(Xq), ref.transform(Xq),
                               rtol=1e-5, atol=1e-4)
    assert port.n_iter_ == ref.n_iter_
    with pytest.raises(ValueError, match="cluster_centers_"):
        kmeans_from_numpy({"cluster_centers_": np.zeros(3)})


def test_sample_weight_matches_jax(mesh1):
    X, _ = _blobs(n=300, d=3, k=3, seed=12)
    rng = np.random.RandomState(1)
    Xo = np.vstack([X, rng.uniform(50, 60, (20, 3)).astype(np.float32)])
    w = np.ones(320, np.float32)
    w[300:] = 0.0
    init = X[:3].copy()
    port = KMeans(n_clusters=3, init=init).fit(Xo, sample_weight=w)
    with jconfig.config_context(mesh=mesh1):
        ref = JKMeans(n_clusters=3, init=init).fit(Xo, sample_weight=w)
    np.testing.assert_allclose(port.cluster_centers_, ref.cluster_centers_,
                               rtol=1e-5, atol=1e-5)
    assert np.abs(port.cluster_centers_).max() < 20.0
    with pytest.raises(ValueError, match="sample_weight"):
        KMeans(n_clusters=3).fit(X, sample_weight=np.ones(5))


@pytest.mark.parametrize("init", ["random", "k-means++"])
def test_other_inits(init):
    X, y = _blobs(n=400, d=4, k=3, seed=13, std=0.5)
    fits = [KMeans(n_clusters=3, init=init, random_state=s).fit(X)
            for s in range(3)]
    best = min(fits, key=lambda e: e.inertia_)
    assert _ari(y, best.labels_) == 1.0


@pytest.mark.parametrize("algorithm",
                         ["bounded", "elkan", "auto", "sketched"])
def test_algorithms_fit_and_dispatch_like_jax(algorithm, monkeypatch):
    """Each value fits and runs the Lloyd loop the JAX estimator runs for
    it: 'bounded'/'elkan' the bounded loop, 'sketched' two bounded
    restricted rounds, and 'auto' the bounded loop exactly when
    n >= 2**16 and k >= 4."""
    X, y = _blobs(n=600, d=5, k=4, seed=14, std=0.5)
    called = []
    for name in ("lloyd_loop_bounded", "lloyd_loop_fused"):
        orig = getattr(core, name)
        monkeypatch.setattr(
            core, name,
            lambda *a, _o=orig, _n=name, **k: called.append(_n) or _o(*a, **k))
    km = KMeans(n_clusters=4, random_state=0, algorithm=algorithm).fit(X)
    want = {"bounded": ["lloyd_loop_bounded"],
            "elkan": ["lloyd_loop_bounded"],
            "auto": ["lloyd_loop_fused"],  # n = 600 < 2**16
            "sketched": ["lloyd_loop_bounded"] * 2}[algorithm]
    assert called == want
    assert _ari(y, km.labels_) == 1.0
    np.testing.assert_array_equal(km.predict(X), km.labels_)
    assert hasattr(km, "lloyd_pruning_") == (algorithm in ("bounded",
                                                           "elkan"))
    assert hasattr(km, "fast_transform_") == (algorithm == "sketched")
    if algorithm == "auto":
        for n, k, want_bounded in ((1 << 16, 4, True), ((1 << 16) - 1, 4,
                                                        False),
                                   (1 << 20, 3, False)):
            est = KMeans(n_clusters=k, algorithm="auto")
            assert est._use_bounded(n, 41) is want_bounded
        called.clear()
        monkeypatch.setattr(core, "_bounded_auto_wins", lambda n, k, d: True)
        KMeans(n_clusters=4, random_state=0, algorithm="auto").fit(X)
        assert called == ["lloyd_loop_bounded"]


def test_bad_params_and_inputs():
    X, _ = _blobs(n=50)
    with pytest.raises(ValueError):
        KMeans(n_clusters=0).fit(X)
    with pytest.raises(ValueError):
        KMeans(max_iter=0).fit(X)
    with pytest.raises(ValueError, match="algorithm"):
        KMeans(algorithm="nope").fit(X)
    with pytest.raises(ValueError, match="init"):
        KMeans(init="bogus").fit(X)
    with pytest.raises(ValueError, match="shape"):
        KMeans(n_clusters=3, init=np.zeros((2, 4))).fit(X)
    with pytest.raises(ValueError, match="n_samples"):
        KMeans(n_clusters=60).fit(X)
    with pytest.raises(AttributeError, match="fit"):
        KMeans().predict(X)
    bad = X.copy()
    bad[0, 0] = np.nan
    with pytest.raises(ValueError, match="NaN"):
        KMeans(n_clusters=3).fit(bad)
    km = KMeans(n_clusters=3, random_state=0).fit(X)
    with pytest.raises(ValueError, match="features"):
        km.predict(X[:, :2])
    # the batched-candidate protocol is ported: it refuses an empty group
    # and scores a real one
    with pytest.raises(ValueError, match="at least one member"):
        km._batched_fit_score(X, None, [], [])
    out = km._batched_fit_score(X, None, [{"n_clusters": 2}], [(X, None)])
    assert out["scores"][0].shape == (1,)


def test_params_protocol_without_sklearn_base():
    """get_params/set_params follow sklearn's protocol, so clone works."""
    from sklearn.base import clone

    km = KMeans(n_clusters=4, tol=1e-3, random_state=3)
    params = km.get_params()
    assert params["n_clusters"] == 4 and params["device"] is None
    twin = clone(km)
    assert twin.get_params() == params and twin is not km
    assert km.set_params(max_iter=7) is km and km.max_iter == 7
    with pytest.raises(ValueError, match="Invalid parameter"):
        km.set_params(bogus=1)
    assert "n_clusters=4" in repr(km)


# ---------------------------------------------------------------------------
# config, validation, device
# ---------------------------------------------------------------------------


def test_default_device_without_card_raises(monkeypatch):
    """The entry points default to the card and raise, rather than carry
    on on the CPU, when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    X, _ = _blobs(n=50)
    with config_context(device="cuda"):
        with pytest.raises(RuntimeError, match="cuda"):
            KMeans(n_clusters=3).fit(X)
    assert get_config()["device"] == "cpu"  # the fixture's scope


def test_config_knobs():
    assert set(get_config()) == {"device", "dtype", "precision",
                                 "device_outputs", "telemetry",
                                 "pad_policy", "compilation_cache", "mesh"}
    with pytest.raises(KeyError):
        set_config(bogus=1)
    # float32 and (since the precision tier) bfloat16 stage; nothing else
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        set_config(dtype=torch.float16)
    try:
        set_config(device="cpu")
        assert get_config()["device"] == "cpu"
    finally:
        reset_config()
    assert get_config()["device"] == "cpu"  # still inside the fixture
    X, _ = _blobs(n=60)
    km = KMeans(n_clusters=3, random_state=0).fit(X)
    with config_context(device_outputs=True, telemetry=True):
        out = km.predict(X)
        assert isinstance(out, torch.Tensor) and out.dtype == torch.int32
        KMeans(n_clusters=3, random_state=0).fit(X)


def test_check_array_and_random_state():
    assert check_array(np.arange(6).reshape(3, 2)).dtype == np.float32
    assert check_array([[1.0, 2.0]]).dtype == np.float32
    assert check_array(torch.ones(2, 2, dtype=torch.float64)).dtype == \
        torch.float32
    with pytest.raises(ValueError, match="2D"):
        check_array(np.ones(3))
    with pytest.raises(ValueError, match="NaN"):
        check_array(np.array([[np.inf]]))
    pd = pytest.importorskip("pandas")
    with pytest.raises(TypeError, match="DataFrame"):
        check_array(pd.DataFrame(np.ones((2, 2))))
    import scipy.sparse

    with pytest.raises(TypeError, match="sparse"):
        check_array(scipy.sparse.csr_matrix(np.eye(3)))
    a = torch.rand(4, generator=check_random_state(5))
    b = torch.rand(4, generator=check_random_state(5))
    assert torch.equal(a, b)
    assert isinstance(check_random_state(None), torch.Generator)
    assert isinstance(check_random_state(np.random.RandomState(0)),
                      torch.Generator)
    with pytest.raises(TypeError):
        check_random_state("seed")


def test_port_never_imports_jax():
    """Every module of the port, and chip_smoke.py, imports without
    pulling in jax, any module of the JAX package, scikit-learn or pandas;
    and again with scikit-learn and pandas made unimportable
    (``sys.modules[name] = None``), as on the card's machine, which has
    neither: ``model_selection``, ``pipeline`` and the serving tier
    (``parallel.serving``, ``.fleet``, ``.telemetry``, ``utils._log``),
    the wire and process tier (``parallel.framing``, ``.shm``,
    ``.elastic``, ``.launcher``, ``.replica``, ``.procfleet``), the
    cross-machine tier (``.snapshots``, ``.autoscaler``), the multi-device
    substrate (``.mesh``, ``.hierarchy``, ``.runtime``, ``.decisions``
    and its cache), ``interop`` and
    its shims, ``model_selection.utils_test``, the star import of the
    package and a call of ``_entry.entry()`` included, no module needs
    them at import time but the scikit-learn subclasses (the ``Partial*``
    estimators), which are loaded only on access and must fail there with
    an ImportError: ``naive_bayes`` (``GaussianNB``) and
    ``cluster.minibatch`` (``MiniBatchKMeans``) import, and their
    ``Partial*`` classes fail on access. The DataFrame encoders
    (``Categorizer``, ``DummyEncoder``, ``OrdinalEncoder``) import and
    fail only on use without pandas; ``OneHotEncoder`` works without
    it. The ``mesh=`` paths run there too, on a mesh of one rank: the
    generators (``effective_rank`` included), the sketched, mini-batch and
    spectral fits, and ``ServingLoop(mesh=)``."""
    for block_sklearn in (False, True):
        _import_walk(block_sklearn)


#: modules that only subclass scikit-learn estimators
_SKLEARN_SUBCLASSES = (
    "dask_ml_tpu_torch.neural_network",
    "dask_ml_tpu_torch.linear_model.stochastic_gradient",
    "dask_ml_tpu_torch.linear_model.perceptron",
    "dask_ml_tpu_torch.linear_model.passive_aggressive")


def _import_walk(block_sklearn: bool):
    code = (
        "import importlib, pkgutil, sys\n"
        + ("sys.modules['sklearn'] = None\nsys.modules['pandas'] = None\n"
           if block_sklearn else "")
        + f"skip = {_SKLEARN_SUBCLASSES!r}\n"
        "deferred = []\n"
        "import dask_ml_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        f"    if m.name in skip and not {block_sklearn!r}:\n"
        "        deferred.append(m.name)\n"
        "        continue\n"
        "    if m.name in skip:\n"
        "        try:\n"
        "            importlib.import_module(m.name)\n"
        "        except ImportError:\n"
        "            continue\n"
        "        raise AssertionError(m.name + ' imported without sklearn')\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "late = [m for m in sys.modules if sys.modules[m] is not None and "
        "m.split('.')[0] in ('sklearn', 'pandas')]\n"
        "assert not late, late\n"
        "import numpy as np\n"
        "from dask_ml_tpu_torch import preprocessing as pre\n"
        "codes = np.arange(6).reshape(3, 2)\n"
        "assert pre.OneHotEncoder().fit_transform(codes).shape == (3, 6)\n"
        "for enc in (pre.Categorizer(), pre.DummyEncoder(), "
        "pre.OrdinalEncoder()):\n"
        "    try:\n"
        "        enc.fit(codes)\n"
        "    except ImportError:\n"
        f"        assert {block_sklearn!r}, type(enc).__name__\n"
        "    except (TypeError, AttributeError):\n"
        f"        assert not {block_sklearn!r}, type(enc).__name__\n"
        "    else:\n"
        "        raise AssertionError(type(enc).__name__ + ' fitted an array')\n"
        "for name in deferred:\n"
        "    importlib.import_module(name)\n"
        "import dask_ml_tpu_torch.model_selection, dask_ml_tpu_torch.pipeline\n"
        "import dask_ml_tpu_torch.parallel.serving\n"
        "import dask_ml_tpu_torch.parallel.fleet\n"
        "import dask_ml_tpu_torch.parallel.telemetry\n"
        "import dask_ml_tpu_torch.parallel.framing\n"
        "import dask_ml_tpu_torch.parallel.shm\n"
        "import dask_ml_tpu_torch.parallel.elastic\n"
        "import dask_ml_tpu_torch.parallel.launcher\n"
        "import dask_ml_tpu_torch.parallel.replica\n"
        "import dask_ml_tpu_torch.parallel.procfleet\n"
        "import dask_ml_tpu_torch.parallel.snapshots\n"
        "import dask_ml_tpu_torch.parallel.autoscaler\n"
        "import dask_ml_tpu_torch.parallel.mesh\n"
        "import dask_ml_tpu_torch.parallel.hierarchy\n"
        "import dask_ml_tpu_torch.parallel.runtime\n"
        "import dask_ml_tpu_torch.parallel.decisions\n"
        "from dask_ml_tpu_torch.parallel import hpsum, make_mesh\n"
        "from dask_ml_tpu_torch.parallel.runtime import initialize\n"
        "import dask_ml_tpu_torch.parallel.decisions as dec\n"
        "assert dec.lookup('no.rule', {}, True, backend='cuda')\n"
        "import dask_ml_tpu_torch.interop, dask_ml_tpu_torch.joblib\n"
        "import dask_ml_tpu_torch.xgboost, dask_ml_tpu_torch.tensorflow\n"
        "import dask_ml_tpu_torch.model_selection.utils_test\n"
        "from dask_ml_tpu_torch import *\n"
        "from dask_ml_tpu_torch._entry import entry\n"
        "fn, args = entry(device='cpu')\n"
        "assert fn(*args).shape == (1024,)\n"
        "import dask_ml_tpu_torch.utils._log\n"
        "from dask_ml_tpu_torch import naive_bayes, cluster\n"
        "from dask_ml_tpu_torch.cluster import minibatch\n"
        "for mod, name in ((minibatch, 'PartialMiniBatchKMeans'),\n"
        "                  (cluster, 'PartialMiniBatchKMeans'),\n"
        "                  (naive_bayes, 'PartialMultinomialNB'),\n"
        "                  (naive_bayes, 'PartialBernoulliNB')):\n"
        "    try:\n"
        "        getattr(mod, name)\n"
        "    except ImportError:\n"
        f"        assert {block_sklearn!r}, name + ' failed with sklearn'\n"
        "    else:\n"
        f"        assert not {block_sklearn!r}, name + ' without sklearn'\n"
        "from dask_ml_tpu_torch.config import set_config\n"
        "set_config(device='cpu')\n"
        "from dask_ml_tpu_torch import datasets\n"
        "from dask_ml_tpu_torch.parallel.mesh import make_mesh as mk, "
        "use_mesh\n"
        "m1 = mk()\n"
        "datasets.make_regression(64, 12, effective_rank=2, random_state=0, "
        "mesh=m1)\n"
        "Xb = datasets.make_blobs(64, 3, random_state=0, mesh=m1)[0].numpy()\n"
        "from dask_ml_tpu_torch.cluster import (KMeans, MiniBatchKMeans, "
        "SpectralClustering)\n"
        "with use_mesh(m1):\n"
        "    KMeans(3, algorithm='sketched', random_state=0, "
        "max_iter=3).fit(Xb)\n"
        "    MiniBatchKMeans(3, random_state=0, max_iter=1).fit(Xb)\n"
        "    SpectralClustering(2, n_components=8, random_state=0).fit(Xb)\n"
        "from dask_ml_tpu_torch.parallel.serving import ServingLoop\n"
        "ServingLoop(mesh=m1).start().stop()\n"
        "import chip_smoke\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'dask_ml_tpu' or m.startswith('dask_ml_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    import pathlib

    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout

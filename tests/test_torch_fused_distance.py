"""The PyTorch port's fused distance family held against the JAX package.

The same integer-valued numpy inputs, made from a seed, go through
``dask_ml_tpu.ops.fused_distance`` (the Pallas kernel in interpret mode,
and the XLA reference) and through ``dask_ml_tpu_torch.ops.fused_distance``
on the CPU, where each wrapper runs its plain PyTorch version because the
tensors lie on the CPU. On integer-valued data every product and sum is
exact, so the results must be bit-identical; on real-valued data argmins
must agree and values agree to accumulation-order tolerance (rtol 1e-5,
atol 1e-5: the two sum the same products in different orders). The CUDA
kernels themselves are held against these plain versions on the card
(tests/test_torch_gpu.py and chip_smoke.py).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dask_ml_tpu.ops import fused_distance as jfd
from dask_ml_tpu_torch import _kernels
from dask_ml_tpu_torch.ops import fused_distance as tfd


@pytest.fixture(autouse=True)
def small_blocks():
    """Shrink both packages' row_need group to 64 rows so small inputs
    span several groups and some can be skipped."""
    old = jfd._FUSED_BLK, tfd._FUSED_BLK
    jfd._FUSED_BLK = tfd._FUSED_BLK = 64
    yield
    jfd._FUSED_BLK, tfd._FUSED_BLK = old


# the JAX package's own test shapes: non-tile-aligned n, prime-ish m and d
SHAPES = [(533, 37, 13), (129, 7, 3), (64, 130, 5), (257, 64, 17)]


def _int_data(n, m, d, seed=0):
    rng = np.random.RandomState(seed)
    X = rng.randint(-8, 8, (n, d)).astype(np.float32)
    Y = rng.randint(-8, 8, (m, d)).astype(np.float32)
    w = rng.randint(0, 5, n).astype(np.float32)
    mask = rng.rand(m) > 0.3
    return X, Y, w, mask


def _t(a):
    return torch.from_numpy(np.asarray(a))


def _np(a):
    return np.asarray(a)


@pytest.mark.parametrize("jax_kernel", ["xla", "pallas"])
@pytest.mark.parametrize("n,m,d", SHAPES)
def test_bitexact_vs_jax_int_valued(n, m, d, jax_kernel):
    X, Y, w, mask = _int_data(n, m, d)
    jX, jY, jw, jm = map(jnp.asarray, (X, Y, w, mask))
    got = tfd.fused_rowwise_min(_t(X), _t(Y), _t(mask))
    want = jfd.fused_rowwise_min(jX, jY, jm, kernel=jax_kernel)
    np.testing.assert_array_equal(got.numpy(), _np(want))

    ga, gm = tfd.fused_argmin_min(_t(X), _t(Y), _t(mask))
    wa, wm = jfd.fused_argmin_min(jX, jY, jm, kernel=jax_kernel)
    assert ga.dtype == torch.int32
    np.testing.assert_array_equal(ga.numpy(), _np(wa))
    np.testing.assert_array_equal(gm.numpy(), _np(wm))

    gi, gc = tfd.fused_argmin_weight(_t(X), _t(w), _t(Y), _t(mask))
    wi, wc = jfd.fused_argmin_weight(jX, jw, jY, jm, kernel=jax_kernel)
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), _np(wi))
    np.testing.assert_array_equal(gc.numpy(), _np(wc))


@pytest.mark.parametrize("op,m,valid", [("min", 80, c) for c in (0, 1, 16, 80)]
                         + [("argmin_weight", 329, c) for c in (8, 321, 329)])
def test_kmeans_parallel_prefix_masks_vs_jax(op, m, valid):
    """The k-means|| rounds' mask (the first ``valid`` of an 80-slot
    candidate buffer) and the weights' mask (the first ``n_cand`` of 329)
    on integer data: the plain versions against the JAX package's XLA
    path, bit for bit."""
    X, Y, w, _ = _int_data(533, m, 50, seed=valid)
    mask = np.arange(m) < valid
    jX, jY, jw, jm = map(jnp.asarray, (X, Y, w, mask))
    if op == "min":
        got = tfd.fused_rowwise_min(_t(X), _t(Y), _t(mask))
        want = jfd.fused_rowwise_min(jX, jY, jm, kernel="xla")
        np.testing.assert_array_equal(got.numpy(), _np(want))
        assert np.isinf(got.numpy()).all() == (valid == 0)
    else:
        gi, gc = tfd.fused_argmin_weight(_t(X), _t(w), _t(Y), _t(mask))
        wi, wc = jfd.fused_argmin_weight(jX, jw, jY, jm, kernel="xla")
        np.testing.assert_array_equal(gi.numpy(), _np(wi))
        np.testing.assert_array_equal(gc.numpy(), _np(wc))
        assert int(gi.max()) < valid and (gc.numpy()[valid:] == 0).all()


def test_real_valued_parity():
    rng = np.random.RandomState(1)
    n, m, d = 321, 29, 11
    X = rng.randn(n, d).astype(np.float32)
    Y = rng.randn(m, d).astype(np.float32)
    w = rng.uniform(0.5, 2.0, n).astype(np.float32)
    ga, gm = tfd.fused_argmin_min(_t(X), _t(Y))
    wa, wm = jfd.fused_argmin_min(jnp.asarray(X), jnp.asarray(Y),
                                  kernel="pallas")
    np.testing.assert_array_equal(ga.numpy(), _np(wa))
    np.testing.assert_allclose(gm.numpy(), _np(wm), rtol=1e-5, atol=1e-5)
    gi, gc = tfd.fused_argmin_weight(_t(X), _t(w), _t(Y))
    wi, wc = jfd.fused_argmin_weight(jnp.asarray(X), jnp.asarray(w),
                                     jnp.asarray(Y), kernel="xla")
    np.testing.assert_array_equal(gi.numpy(), _np(wi))
    np.testing.assert_allclose(gc.numpy(), _np(wc), rtol=1e-5, atol=1e-4)


def test_argmin_ties_break_to_lowest_index():
    rng = np.random.RandomState(2)
    Yb = rng.randint(-4, 4, (9, 5)).astype(np.float32)
    Y = np.concatenate([Yb, Yb])  # rows j and j + 9 identical
    X = np.concatenate([Yb, Yb, Yb])  # every row lands on a duplicate
    ga, _ = tfd.fused_argmin_min(_t(X), _t(Y))
    wa, _ = jfd.fused_argmin_min(jnp.asarray(X), jnp.asarray(Y),
                                 kernel="xla")
    np.testing.assert_array_equal(ga.numpy(), _np(wa))
    assert int(ga.max()) < 9


def test_masked_rows_never_win():
    rng = np.random.RandomState(3)
    n, m, d = 150, 12, 4
    Y = (rng.randn(m, d) * 5).astype(np.float32)
    X = Y[rng.randint(0, 3, n)] + 0.01  # nearest target in {0, 1, 2}
    mask = np.array([False] * 3 + [True] * (m - 3))
    am, _ = tfd.fused_argmin_min(_t(X), _t(Y), _t(mask))
    assert int(am.min()) >= 3
    _, cw = tfd.fused_argmin_weight(_t(X), torch.ones(n), _t(Y), _t(mask))
    assert (cw[:3] == 0).all() and float(cw.sum()) == n


def test_all_masked_edge_case():
    X, Y, w, _ = _int_data(100, 8, 3)
    mask = np.zeros(8, bool)
    am, mn = tfd.fused_argmin_min(_t(X), _t(Y), _t(mask))
    assert (am == 0).all() and torch.isinf(mn).all()
    assert torch.isinf(tfd.fused_rowwise_min(_t(X), _t(Y), _t(mask))).all()
    # every row's argmin is 0 and its weight lands on masked slot 0,
    # which is then zeroed — the reference's rule
    _, cw = tfd.fused_argmin_weight(_t(X), _t(w), _t(Y), _t(mask))
    assert (cw == 0).all()
    _, jcw = jfd.fused_argmin_weight(*map(jnp.asarray, (X, w, Y, mask)),
                                     kernel="pallas")
    np.testing.assert_array_equal(cw.numpy(), _np(jcw))


def test_min_value_clamped_nonnegative():
    rng = np.random.RandomState(4)
    Y = (rng.randn(5, 7) * 100).astype(np.float32)
    X = np.tile(Y, (20, 1))
    mn = tfd.fused_rowwise_min(_t(X), _t(Y))
    assert (mn >= 0).all() and float(mn.max()) < 1e-2


@pytest.mark.parametrize("jax_kernel", ["xla", "pallas"])
def test_row_need_matches_jax(jax_kernel):
    """Skipped groups return +inf, evaluated groups the full answer — the
    same rows, the same bits as the JAX package."""
    X, Y, _, mask = _int_data(533, 37, 13)
    rng = np.random.RandomState(23)
    need = (rng.rand(533) > 0.6) & (np.arange(533) < 200)
    ev = tfd.row_block_evaluated(_t(need)).numpy()
    np.testing.assert_array_equal(
        ev, _np(jfd.row_block_evaluated(jnp.asarray(need))))
    assert ev.any() and not ev.all()
    got = tfd.fused_rowwise_min(_t(X), _t(Y), _t(mask), row_need=_t(need))
    want = jfd.fused_rowwise_min(*map(jnp.asarray, (X, Y, mask)),
                                 kernel=jax_kernel,
                                 row_need=jnp.asarray(need))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    assert np.isinf(got.numpy()[~ev]).all()
    full = tfd.fused_rowwise_min(_t(X), _t(Y), _t(mask))
    np.testing.assert_array_equal(got.numpy()[ev], full.numpy()[ev])
    none = tfd.fused_rowwise_min(_t(X), _t(Y), _t(mask),
                                 row_need=torch.zeros(533, dtype=torch.bool))
    assert torch.isinf(none).all()


def test_dispatch_rules():
    """'auto' on a CPU tensor runs the plain version and launches nothing;
    'cuda' on a CPU tensor raises instead of falling back; unknown kernels
    are loud."""
    X, Y, w, mask = _int_data(64, 5, 3)
    before = dict(_kernels.launches)
    for kernel in ("auto", "torch"):
        tfd.fused_rowwise_min(_t(X), _t(Y), kernel=kernel)
        tfd.fused_argmin_min(_t(X), _t(Y), kernel=kernel)
        tfd.fused_argmin_weight(_t(X), _t(w), _t(Y), kernel=kernel)
    assert _kernels.launches == before
    with pytest.raises(ValueError, match="cuda"):
        tfd.fused_argmin_min(_t(X), _t(Y), kernel="cuda")
    with pytest.raises(ValueError, match="cuda"):
        tfd.fused_rowwise_min(_t(X), _t(Y), kernel="cuda")
    with pytest.raises(ValueError, match="kernel"):
        tfd.fused_argmin_weight(_t(X), _t(w), _t(Y), kernel="pallas")


def test_row_groups_one_definition():
    """The group count and the per-row evaluated mask come from one
    definition, _row_blocks, at the module's _FUSED_BLK."""
    assert tfd._row_blocks(129) == (3, 192)
    need = torch.zeros(129, dtype=torch.bool)
    need[70] = True
    ev = tfd.row_block_evaluated(need)
    assert ev.tolist() == [i // 64 == 1 for i in range(129)]
    assert tfd._group_need(need).tolist() == [False, True, False]


# ---------------------------------------------------------------------------
# argmin_min2 (bounded Lloyd) and the sketched assignment
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("jax_kernel", ["xla", "pallas"])
@pytest.mark.parametrize("n,m,d", SHAPES)
def test_min2_bitexact_vs_jax_int_valued(n, m, d, jax_kernel):
    X, Y, _, mask = _int_data(n, m, d)
    ga, g1, g2 = tfd.fused_argmin_min2(_t(X), _t(Y), _t(mask))
    wa, w1, w2 = jfd.fused_argmin_min2(*map(jnp.asarray, (X, Y, mask)),
                                       kernel=jax_kernel)
    assert ga.dtype == torch.int32
    np.testing.assert_array_equal(ga.numpy(), _np(wa))
    np.testing.assert_array_equal(g1.numpy(), _np(w1))
    np.testing.assert_array_equal(g2.numpy(), _np(w2))
    # the shared outputs are argmin_min's, and second >= best
    aa, mm = tfd.fused_argmin_min(_t(X), _t(Y), _t(mask))
    assert torch.equal(aa, ga) and torch.equal(mm, g1)
    assert (g2 >= g1).all()


def test_min2_real_valued_parity():
    rng = np.random.RandomState(21)
    X = rng.randn(321, 11).astype(np.float32)
    Y = rng.randn(29, 11).astype(np.float32)
    ga, g1, g2 = tfd.fused_argmin_min2(_t(X), _t(Y))
    wa, w1, w2 = jfd.fused_argmin_min2(jnp.asarray(X), jnp.asarray(Y),
                                       kernel="xla")
    np.testing.assert_array_equal(ga.numpy(), _np(wa))
    np.testing.assert_allclose(g1.numpy(), _np(w1), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(g2.numpy(), _np(w2), rtol=1e-5, atol=1e-5)


def test_min2_second_best_is_true_runner_up():
    """The second-best is the min over the non-argmin columns (a dense
    numpy oracle), and a duplicate of the best target is the runner-up."""
    rng = np.random.RandomState(22)
    X = rng.randn(200, 5).astype(np.float32)
    Y = rng.randn(13, 5).astype(np.float32)
    D = ((X[:, None, :] - Y[None]) ** 2).sum(-1)
    idx, _, d2 = tfd.fused_argmin_min2(_t(X), _t(Y))
    D[np.arange(200), idx.numpy()] = np.inf
    np.testing.assert_allclose(d2.numpy(), D.min(1), rtol=1e-4, atol=1e-4)
    Y2 = np.concatenate([Y, Y[:3]])
    idx, d1, d2 = tfd.fused_argmin_min2(_t(Y[:3]), _t(Y2))
    np.testing.assert_array_equal(idx.numpy(), np.arange(3))
    assert torch.equal(d1, d2) and (d2 < 1e-3).all()


def test_min2_edge_cases():
    X, Y, _, _ = _int_data(100, 8, 3)
    am, mn, mn2 = tfd.fused_argmin_min2(_t(X), _t(Y),
                                        torch.zeros(8, dtype=torch.bool))
    assert (am == 0).all() and torch.isinf(mn).all()
    assert torch.isinf(mn2).all()
    am, mn, mn2 = tfd.fused_argmin_min2(_t(X), _t(Y[:1]))
    assert (am == 0).all() and torch.isfinite(mn).all()
    assert torch.isinf(mn2).all()
    one = torch.tensor([False, True] + [False] * 6)
    am, mn, mn2 = tfd.fused_argmin_min2(_t(X), _t(Y), one)
    assert (am == 1).all() and torch.isinf(mn2).all()


@pytest.mark.parametrize("jax_kernel", ["xla", "pallas"])
def test_min2_row_need_matches_jax(jax_kernel):
    """Evaluated groups give the full answer, skipped groups zeros — the
    same rows and bits as the JAX package."""
    X, Y, _, mask = _int_data(533, 37, 13)
    rng = np.random.RandomState(23)
    need = (rng.rand(533) > 0.6) & (np.arange(533) < 200)
    ev = tfd.row_block_evaluated(_t(need)).numpy()
    got = tfd.fused_argmin_min2(_t(X), _t(Y), _t(mask), row_need=_t(need))
    want = jfd.fused_argmin_min2(*map(jnp.asarray, (X, Y, mask)),
                                 kernel=jax_kernel,
                                 row_need=jnp.asarray(need))
    full = tfd.fused_argmin_min2(_t(X), _t(Y), _t(mask))
    for g, w_, f in zip(got, want, full):
        np.testing.assert_array_equal(g.numpy(), _np(w_))
        np.testing.assert_array_equal(g.numpy()[ev], f.numpy()[ev])
        assert (g.numpy()[~ev] == 0).all()
    none = tfd.fused_argmin_min2(_t(X), _t(Y), _t(mask),
                                 row_need=torch.zeros(533, dtype=torch.bool))
    assert all((t == 0).all() for t in none)
    alln = tfd.fused_argmin_min2(_t(X), _t(Y), _t(mask),
                                 row_need=torch.ones(533, dtype=torch.bool))
    assert all(torch.equal(a, b) for a, b in zip(alln, full))


def _sk_problem(n, k, p, seed=0):
    """Integer-valued restricted data and sketch values, and a full-space
    x2 that holds off-support energy the restricted block cannot see."""
    rng = np.random.RandomState(seed)
    Zp = rng.randint(-8, 8, (n, p)).astype(np.float32)
    vals = rng.randint(-8, 8, (k, p)).astype(np.float32)
    x2 = (Zp * Zp).sum(1) + rng.randint(0, 9, n).astype(np.float32)
    mask = rng.rand(k) > 0.3
    return Zp, vals, x2, mask


@pytest.mark.parametrize("jax_kernel", ["xla", "pallas"])
@pytest.mark.parametrize("n,k,p", [(533, 37, 13), (129, 7, 3),
                                   (257, 64, 17)])
def test_sketched_bitexact_vs_jax_int_valued(n, k, p, jax_kernel):
    Zp, vals, x2, mask = _sk_problem(n, k, p)
    ga, gm = tfd.fused_argmin_min_sketched(_t(Zp), _t(vals), x2=_t(x2),
                                           mask=_t(mask))
    wa, wm = jfd.fused_argmin_min_sketched(
        jnp.asarray(Zp), jnp.asarray(vals), x2=jnp.asarray(x2),
        mask=jnp.asarray(mask), kernel=jax_kernel)
    assert ga.dtype == torch.int32
    np.testing.assert_array_equal(ga.numpy(), _np(wa))
    np.testing.assert_array_equal(gm.numpy(), _np(wm))


def test_sketched_value_is_full_space():
    Zp, vals, x2, _ = _sk_problem(64, 5, 4, seed=1)
    a, m = tfd.fused_argmin_min_sketched(_t(Zp), _t(vals), x2=_t(x2))
    d2 = x2[:, None] - 2.0 * Zp @ vals.T + (vals * vals).sum(1)[None, :]
    np.testing.assert_allclose(m.numpy(), np.maximum(d2.min(1), 0.0),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(a.numpy(), d2.argmin(1))


def test_sketched_ties_and_all_masked():
    Zp = torch.zeros(9, 4)
    a, _ = tfd.fused_argmin_min_sketched(Zp, torch.ones(6, 4),
                                         x2=torch.zeros(9))
    assert (a == 0).all()
    Zq, vals, x2, _ = _sk_problem(33, 4, 3, seed=2)
    a, m = tfd.fused_argmin_min_sketched(_t(Zq), _t(vals), x2=_t(x2),
                                         mask=torch.zeros(4, dtype=torch.bool))
    assert (a == 0).all() and torch.isinf(m).all()


@pytest.mark.parametrize("jax_kernel", ["xla", "pallas"])
def test_sketched_row_need_matches_jax(jax_kernel):
    Zp, vals, x2, mask = _sk_problem(200, 9, 5, seed=3)
    need = np.arange(200) < 70  # groups 0-1 needed, group 3 not
    ev = tfd.row_block_evaluated(_t(need)).numpy()
    assert ev.any() and not ev.all()
    ga, gm = tfd.fused_argmin_min_sketched(_t(Zp), _t(vals), x2=_t(x2),
                                           mask=_t(mask), row_need=_t(need))
    wa, wm = jfd.fused_argmin_min_sketched(
        *map(jnp.asarray, (Zp, vals)), x2=jnp.asarray(x2),
        mask=jnp.asarray(mask), row_need=jnp.asarray(need),
        kernel=jax_kernel)
    np.testing.assert_array_equal(ga.numpy(), _np(wa))
    np.testing.assert_array_equal(gm.numpy(), _np(wm))
    assert (ga.numpy()[~ev] == 0).all() and (gm.numpy()[~ev] == 0).all()


def test_sketched_support_mode_matches_prerestricted():
    rng = np.random.RandomState(4)
    Z = rng.randint(-8, 8, (129, 21)).astype(np.float32)
    vals = rng.randint(-8, 8, (8, 6)).astype(np.float32)
    support = np.sort(rng.choice(21, 6, replace=False))
    a1, m1 = tfd.fused_argmin_min_sketched(_t(Z), _t(vals), _t(support))
    a2, m2 = tfd.fused_argmin_min_sketched(
        _t(Z[:, support]), _t(vals), x2=_t((Z * Z).sum(1)))
    assert torch.equal(a1, a2) and torch.equal(m1, m2)
    wa, wm = jfd.fused_argmin_min_sketched(
        jnp.asarray(Z), jnp.asarray(vals), jnp.asarray(support, jnp.int32),
        kernel="xla")
    np.testing.assert_array_equal(a1.numpy(), _np(wa))
    np.testing.assert_array_equal(m1.numpy(), _np(wm))


def test_new_ops_dispatch_rules():
    """'auto' on CPU tensors launches nothing; 'cuda' raises; restricted
    mode without x2 raises."""
    X, Y, _, _ = _int_data(64, 5, 3)
    before = dict(_kernels.launches)
    for kernel in ("auto", "torch"):
        tfd.fused_argmin_min2(_t(X), _t(Y), kernel=kernel)
        tfd.fused_argmin_min_sketched(_t(X), _t(Y), x2=torch.zeros(64),
                                      kernel=kernel)
    assert _kernels.launches == before
    with pytest.raises(ValueError, match="cuda"):
        tfd.fused_argmin_min2(_t(X), _t(Y), kernel="cuda")
    with pytest.raises(ValueError, match="cuda"):
        tfd.fused_argmin_min_sketched(_t(X), _t(Y), x2=torch.zeros(64),
                                      kernel="cuda")
    with pytest.raises(ValueError, match="x2"):
        tfd.fused_argmin_min_sketched(_t(X), _t(Y))


# ---------------------------------------------------------------------------
# bf16 X (the JAX kernel's bf16 case)
# ---------------------------------------------------------------------------


def _bf16_data(n, m, d, seed=0):
    """Integer X (exact in bf16) and targets on a 1/256 grid with up to
    ten significant bits, so that casting Y to bf16 rounds: products of
    bf16 operands and every sum here are exact in f32, and any route that
    skips the rounding (or takes |y|² from the rounded Y) gives other
    bits."""
    rng = np.random.RandomState(seed)
    X = rng.randint(-8, 8, (n, d)).astype(np.float32)
    Y = (rng.randint(-512, 512, (m, d)) / 256.0).astype(np.float32)
    w = rng.randint(0, 5, n).astype(np.float32)
    mask = rng.rand(m) > 0.3
    assert not np.array_equal(
        np.asarray(jnp.asarray(Y, jnp.bfloat16), np.float32), Y)
    return X, Y, w, mask


def _tb(a):
    return torch.from_numpy(np.asarray(a)).to(torch.bfloat16)


@pytest.mark.parametrize("n,m,d", SHAPES)
def test_bf16_bitexact_vs_jax_pallas(n, m, d):
    """bf16 X through every epilogue, against the JAX Pallas kernel in
    interpret mode, bit for bit (tolerance 0): Y cast to X's dtype for the
    product, |y|² from the original f32 Y, f32 accumulation."""
    X, Y, w, mask = _bf16_data(n, m, d)
    jX = jnp.asarray(X, jnp.bfloat16)
    jY, jw, jm = map(jnp.asarray, (Y, w, mask))
    tX = _tb(X)
    got = tfd.fused_rowwise_min(tX, _t(Y), _t(mask))
    want = jfd.fused_rowwise_min(jX, jY, jm, kernel="pallas")
    np.testing.assert_array_equal(got.numpy(), _np(want))
    ga, gm = tfd.fused_argmin_min(tX, _t(Y), _t(mask))
    wa, wm = jfd.fused_argmin_min(jX, jY, jm, kernel="pallas")
    np.testing.assert_array_equal(ga.numpy(), _np(wa))
    np.testing.assert_array_equal(gm.numpy(), _np(wm))
    gi, gc = tfd.fused_argmin_weight(tX, _t(w), _t(Y), _t(mask))
    wi, wc = jfd.fused_argmin_weight(jX, jw, jY, jm, kernel="pallas")
    np.testing.assert_array_equal(gi.numpy(), _np(wi))
    np.testing.assert_array_equal(gc.numpy(), _np(wc))
    g2 = tfd.fused_argmin_min2(tX, _t(Y), _t(mask))
    w2 = jfd.fused_argmin_min2(jX, jY, jm, kernel="pallas")
    for a, b in zip(g2, w2):
        np.testing.assert_array_equal(a.numpy(), _np(b))


def test_bf16_row_need_and_sketched_vs_jax_pallas():
    """The group skip and the external |x|² with bf16 X, bit for bit
    against the JAX Pallas kernel (tolerance 0)."""
    X, Y, _, mask = _bf16_data(533, 37, 13, seed=3)
    need = (np.random.RandomState(4).rand(533) > 0.6) & (
        np.arange(533) < 200)
    jX = jnp.asarray(X, jnp.bfloat16)
    got = tfd.fused_rowwise_min(_tb(X), _t(Y), _t(mask), row_need=_t(need))
    want = jfd.fused_rowwise_min(jX, jnp.asarray(Y), jnp.asarray(mask),
                                 kernel="pallas", row_need=jnp.asarray(need))
    np.testing.assert_array_equal(got.numpy(), _np(want))
    x2 = (np.random.RandomState(5).randint(0, 64, 533)).astype(np.float32)
    ga, gm = tfd.fused_argmin_min_sketched(_tb(X), _t(Y), x2=_t(x2),
                                           row_need=_t(need))
    wa, wm = jfd.fused_argmin_min_sketched(jX, jnp.asarray(Y),
                                           x2=jnp.asarray(x2),
                                           kernel="pallas",
                                           row_need=jnp.asarray(need))
    np.testing.assert_array_equal(ga.numpy(), _np(wa))
    np.testing.assert_array_equal(gm.numpy(), _np(wm))


def test_bf16_plain_is_f32_plain_on_the_rounded_operands():
    """The convention the card's gate rests on (the bf16 kernel equals the
    f32 kernel on ``X.float()``): with bf16 X the plain version is the f32
    plain version on the widened X and the bf16-rounded Y, with |y|² from
    the original Y — on float data, bit for bit (tolerance 0)."""
    rng = np.random.RandomState(6)
    X = rng.randn(300, 11).astype(np.float32)
    Y = rng.randn(9, 11).astype(np.float32)
    tX = _tb(X)
    Yr = torch.from_numpy(Y).to(torch.bfloat16).float()
    y2 = tfd._row_sumsq(_t(Y))
    s16 = tfd._scores_ref(tX, _t(Y), None)
    s32 = y2[None, :] - 2.0 * (tX.float() @ Yr.T)
    assert torch.equal(s16, s32)
    ga, gm = tfd.fused_argmin_min(tX, _t(Y))
    wa, wm = jfd.fused_argmin_min(jnp.asarray(X, jnp.bfloat16),
                                  jnp.asarray(Y), kernel="pallas")
    np.testing.assert_array_equal(ga.numpy(), _np(wa))
    np.testing.assert_allclose(gm.numpy(), _np(wm), rtol=1e-5, atol=1e-5)

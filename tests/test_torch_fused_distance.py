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

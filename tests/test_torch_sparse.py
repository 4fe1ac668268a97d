"""The PyTorch port's sparse tier held against the JAX package, on the CPU.

The same numpy inputs, made from a seed, go through
``dask_ml_tpu.ops.sparse`` (the Pallas SpMV in interpret mode where the
row count tiles, and the XLA reference) and through
``dask_ml_tpu_torch.ops.sparse`` on the CPU, where ``matvec`` runs the
plain version ``_spmv_ref`` because the tensors lie on the CPU.
Tolerances and their reasons:

- integer-valued data: every product and partial sum is an exactly
  representable integer, so the contractions are bit-identical to each
  other and to the dense products, whatever the summation order;
- float data: the same products summed in other orders, rtol 1e-6 and
  atol 1e-6 (the JAX package's own Pallas-vs-XLA tolerance);
- the container encoding and the sparse generator are integer and
  counter-seeded numpy work: equal slot for slot and bit for bit.

The K6 kernels themselves (forward and pullback) are held against
``_spmv_ref`` and ``_pullback_ref`` on the card (tests/test_torch_gpu.py
and chip_smoke.py); here the rule that picks where they keep the
``(d,)`` vector, ``dvector_plan``, is held to its boundaries.
"""

import numpy as np
import pytest
import scipy.sparse as scipy_sparse
import torch

import jax
import jax.numpy as jnp

from dask_ml_tpu import datasets as jdatasets
from dask_ml_tpu.ops import sparse as jsps
from dask_ml_tpu.parallel import shapes as jshapes
from dask_ml_tpu_torch import _kernels, config_context
from dask_ml_tpu_torch import datasets as tdatasets
from dask_ml_tpu_torch.ops import sparse as tsps
from dask_ml_tpu_torch.parallel import shapes as tshapes
from dask_ml_tpu_torch.parallel.sharding import (is_sparse_input,
                                                 prepare_data, unpad_rows)
from dask_ml_tpu_torch.utils.validation import check_array


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


def _int_sparse(rng, n, d, density=0.3, lo=-3, hi=4):
    """Integer-valued sparse matrix with an empty row and an all-zero
    column (the JAX package's test recipe)."""
    dense = (rng.randint(lo, hi, (n, d))
             * (rng.uniform(size=(n, d)) < density)).astype(np.float32)
    if n > 3:
        dense[2] = 0.0
    if d > 5:
        dense[:, 4] = 0.0
    return dense, scipy_sparse.csr_matrix(dense)


def _pair(A):
    """The same host container for both packages."""
    return (jsps.SparseRows(jnp.asarray(A.values), jnp.asarray(A.cols), A.d),
            tsps.SparseRows(torch.as_tensor(A.values),
                            torch.as_tensor(A.cols), A.d))


def _dup_rows(rng, n, d, k):
    """A container written slot by slot: duplicate columns in a row, and
    value-0 padded slots at column 0."""
    cols = rng.randint(0, d, (n, k)).astype(np.int32)
    cols[:, 1] = cols[:, 0]  # duplicates sum
    vals = rng.randint(-3, 4, (n, k)).astype(np.float32)
    vals[:, -1] = 0.0
    cols[:, -1] = 0  # padding
    return tsps.SparseRows(vals, cols, d)


# ---------------------------------------------------------------------------
# K6: the plain version against the JAX package's two paths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d,pallas", [(512, 33, True), (37, 17, True),
                                        (300, 9, False), (1, 6, True)])
def test_spmv_bit_exact_on_integer_data(n, d, pallas):
    rng = np.random.RandomState(n + d)
    dense, csr = _int_sparse(rng, n, d)
    Aj, At = _pair(jsps.ell_from_csr(csr))
    v = rng.randint(-3, 4, d).astype(np.float32)
    got = tsps.matvec(At, torch.as_tensor(v), kernel="torch").numpy()
    np.testing.assert_array_equal(got, dense @ v)
    np.testing.assert_array_equal(
        got, np.asarray(jsps.matvec(Aj, jnp.asarray(v), kernel="xla")))
    if pallas:  # the Pallas kernel tiles this n (interpret mode here)
        np.testing.assert_array_equal(
            got, np.asarray(jsps.matvec(Aj, jnp.asarray(v),
                                        kernel="pallas")))
    # 'auto' on CPU tensors is the plain version and launches nothing
    before = dict(_kernels.launches)
    np.testing.assert_array_equal(tsps.spmv(At, torch.as_tensor(v)).numpy(),
                                  got)
    assert _kernels.launches == before


@pytest.mark.parametrize("k", [1, 5, 101])
def test_spmv_duplicates_padding_and_widths(k):
    rng = np.random.RandomState(k)
    A = _dup_rows(rng, 301, 7, max(k, 2)) if k > 1 else tsps.SparseRows(
        rng.randint(-3, 4, (301, 1)).astype(np.float32),
        rng.randint(0, 7, (301, 1)).astype(np.int32), 7)
    Aj, At = _pair(A)
    v = rng.randint(-3, 4, 7).astype(np.float32)
    dense = tsps.to_dense(At).numpy()
    got = tsps.matvec(At, torch.as_tensor(v)).numpy()
    np.testing.assert_array_equal(got, dense @ v)
    np.testing.assert_array_equal(
        got, np.asarray(jsps.matvec(Aj, jnp.asarray(v), kernel="xla")))
    np.testing.assert_array_equal(dense, np.asarray(jsps.to_dense(Aj)))


def test_spmv_float_data_within_rtol():
    rng = np.random.RandomState(3)
    _, csr = _int_sparse(rng, 512, 33)
    csr.data = rng.standard_normal(csr.nnz).astype(np.float32)
    Aj, At = _pair(jsps.ell_from_csr(csr))
    v = rng.standard_normal(33).astype(np.float32)
    got = tsps.matvec(At, torch.as_tensor(v)).numpy()
    for kernel in ("xla", "pallas"):
        np.testing.assert_allclose(
            got, np.asarray(jsps.matvec(Aj, jnp.asarray(v), kernel=kernel)),
            rtol=1e-6, atol=1e-6)


def test_spmv_gradient_matches_jax():
    """The autograd Function's backward against ``jax.grad`` through the
    Pallas ``spmv``'s custom VJP: in v (the segment-sum pullback) and in
    the values (formed only when asked for). Float data, rtol 1e-6."""
    rng = np.random.RandomState(4)
    _, csr = _int_sparse(rng, 256, 9)
    csr.data = rng.standard_normal(csr.nnz).astype(np.float32)
    Aj, At = _pair(jsps.ell_from_csr(csr))
    v0 = rng.standard_normal(9).astype(np.float32)
    gj_v = jax.grad(lambda v: jnp.sum(jsps.spmv(Aj, v) ** 2))(jnp.asarray(v0))
    gj_vals = jax.grad(lambda x: jnp.sum(jsps.spmv(
        jsps.SparseRows(x, Aj.cols, Aj.d), jnp.asarray(v0)) ** 2))(Aj.values)
    vals = At.values.clone().requires_grad_(True)
    v = torch.tensor(v0, requires_grad=True)
    out = tsps.spmv(tsps.SparseRows(vals, At.cols, At.d), v)
    (out ** 2).sum().backward()
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(gj_v), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(vals.grad.numpy(), np.asarray(gj_vals),
                               rtol=1e-6, atol=1e-6)
    # without a values gradient only the pullback runs
    v2 = torch.tensor(v0, requires_grad=True)
    (tsps.matvec(At, v2) ** 2).sum().backward()
    assert torch.equal(v2.grad, v.grad)


def test_autodiff_pullback_is_segment_sum():
    rng = np.random.RandomState(5)
    _, csr = _int_sparse(rng, 40, 7)
    Aj, At = _pair(jsps.ell_from_csr(csr))
    r = rng.randint(-2, 3, 40).astype(np.float32)
    v = torch.zeros(7, requires_grad=True)
    torch.dot(tsps.matvec(At, v), torch.as_tensor(r)).backward()
    want = np.asarray(jsps.pullback(Aj, jnp.asarray(r)))
    np.testing.assert_array_equal(v.grad.numpy(), want)
    np.testing.assert_array_equal(
        tsps.pullback(At, torch.as_tensor(r)).numpy(), want)


@pytest.mark.parametrize("objective", ["sum", "squares", "dot"])
def test_autograd_grad_through_spmv_matches_jax_grad(objective):
    """``torch.autograd.grad`` through the port's ``spmv`` (forward and
    pullback wired through one Function) against ``jax.grad`` through the
    JAX ``spmv`` (its Pallas kernel in interpret mode, its custom VJP).
    ``sum`` hands the backward an expanded cotangent. Integer data: bit
    for bit."""
    rng = np.random.RandomState(11)
    dense, csr = _int_sparse(rng, 128, 13)
    Aj, At = _pair(jsps.ell_from_csr(csr))
    v0 = rng.randint(-3, 4, 13).astype(np.float32)
    r = rng.randint(-2, 3, 128).astype(np.float32)
    fj = {"sum": lambda o: jnp.sum(o), "squares": lambda o: jnp.sum(o ** 2),
          "dot": lambda o: jnp.dot(o, jnp.asarray(r))}[objective]
    ft = {"sum": lambda o: o.sum(), "squares": lambda o: (o ** 2).sum(),
          "dot": lambda o: torch.dot(o, torch.as_tensor(r))}[objective]
    want = jax.grad(lambda v: fj(jsps.spmv(Aj, v)))(jnp.asarray(v0))
    v = torch.tensor(v0, requires_grad=True)
    (got,) = torch.autograd.grad(ft(tsps.spmv(At, v)), v)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    (got_t,) = torch.autograd.grad(ft(tsps.spmv(At, v, kernel="torch")), v)
    assert torch.equal(got, got_t)


@pytest.mark.parametrize("n,d", [(40, 7), (300, 9), (512, 33)])
def test_pullback_kernel_argument(n, d):
    """``pullback(kernel=)``: 'auto' and 'torch' on CPU tensors are the
    plain version and launch nothing, 'cuda' raises; against the JAX
    package bit for bit on integer data and within rtol 1e-5 on float
    data (the same products, scatter-added in another order)."""
    rng = np.random.RandomState(n)
    dense, csr = _int_sparse(rng, n, d)
    Aj, At = _pair(jsps.ell_from_csr(csr))
    r = rng.randint(-2, 3, n).astype(np.float32)
    want = np.asarray(jsps.pullback(Aj, jnp.asarray(r)))
    before = dict(_kernels.launches)
    for kernel in ("auto", "torch"):
        got = tsps.pullback(At, torch.as_tensor(r), kernel=kernel)
        assert got.dtype == torch.float32 and got.shape == (d,)
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(got.numpy(), dense.T @ r)
    assert torch.equal(tsps.pullback(At, torch.as_tensor(r)), got)
    assert _kernels.launches == before
    with pytest.raises(ValueError, match="CUDA"):
        tsps.pullback(At, torch.as_tensor(r), kernel="cuda")
    with pytest.raises(ValueError, match="kernel must be"):
        tsps.pullback(At, torch.as_tensor(r), kernel="xla")
    csr.data = rng.standard_normal(csr.nnz).astype(np.float32)
    Aj, At = _pair(jsps.ell_from_csr(csr))
    rf = rng.standard_normal(n).astype(np.float32)
    np.testing.assert_allclose(
        tsps.pullback(At, torch.as_tensor(rf)).numpy(),
        np.asarray(jsps.pullback(Aj, jnp.asarray(rf))), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# where the kernels keep the d-vector
# ---------------------------------------------------------------------------

#: floats of one block's shared memory, and what the forward's staging
#: takes of them at k = 101 (2 groups x 2 tiles x 20 rows x 101 slots)
_BLOCK = 232_448 // 4
_STAGE_101 = 2 * 2 * 20 * 101


@pytest.mark.parametrize("n,k,d,pullback,want", [
    # the sparse GLM cell and its score rows: a cluster of 2, both ways
    (10_000_000, 101, 100_001, False, 2),
    (10_000_000, 101, 100_001, True, 2),
    (262_144, 101, 100_001, False, 2),
    # forward: one block up to 58,112 less the staging, then a cluster of
    # 2 up to twice that, then L2 (a cluster of 4 loses to the L2 kernel)
    (10_000_000, 101, _BLOCK - _STAGE_101, False, 1),
    (10_000_000, 101, _BLOCK - _STAGE_101 + 1, False, 2),
    (10_000_000, 101, 2 * (_BLOCK - _STAGE_101), False, 2),
    (10_000_000, 101, 2 * (_BLOCK - _STAGE_101) + 1, False, 0),
    # pullback: no staging; one block, 2, 4, then device atomics
    (10_000_000, 101, _BLOCK, True, 1),
    (10_000_000, 101, _BLOCK + 1, True, 2),
    (10_000_000, 101, 2 * _BLOCK, True, 2),
    (10_000_000, 101, 2 * _BLOCK + 1, True, 4),
    (10_000_000, 101, 4 * _BLOCK, True, 4),
    (10_000_000, 101, 4 * _BLOCK + 1, True, 0),
    # a row wider than a tile stays with the L2 kernels
    (100_000, 512, 1_000, False, 1),
    (100_000, 513, 1_000, False, 0),
    (100_000, 513, 1_000, True, 0),
    # too few slots to pay for filling shared memory: a full grid copies
    # 132 / cluster times d floats
    (1, 1, 7, False, 0),
    (924, 1, 7, False, 0),
    (924, 1, 7, True, 1),
    (923, 1, 7, False, 0),
    (65_347, 101, 100_001, False, 0),
    (65_348, 101, 100_001, False, 2),
    (0, 101, 100_001, True, 0),
])
def test_dvector_plan(n, k, d, pullback, want):
    assert tsps.dvector_plan(n, k, d, pullback=pullback) == want


#: rows of the one-block grid's tiles at the served request's k = 10
_R10 = 204


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,k,d,forward,back", [
    # the served sparse request: 11 tiles, 6 blocks of the one-block grid,
    # so the forward gathers from L2; the pullback keeps one block
    (2048, 10, 100, 0, 1),
    # the elastic block: 1,303 tiles fill the grid
    (125_000, 21, 1_001, 1, 1),
    # the forward's one block starts where the grid gets a block an SM:
    # 262 tiles (131 blocks) and 263 (132)
    (262 * _R10, 10, 100, 0, 1),
    (262 * _R10 + 1, 10, 100, 1, 1),
    # below, too few slots to fill shared memory: L2 for both
    (1_320, 10, 100, 0, 1),
    (1_319, 10, 100, 0, 0),
    (1, 1, 1, 0, 0),
    (132, 1, 1, 0, 1),
    # a row of 512 slots: 4 rows a tile
    (262 * 4, 512, 2_000, 0, 1),
    (262 * 4 + 1, 512, 2_000, 1, 1),
])
def test_dvector_plan_short_containers_gather_from_l2(n, k, d, forward,
                                                      back, dtype):
    """A forward whose one-block grid would have fewer blocks than the
    card has SMs gathers from L2 (whose grid gives every SM rows), where
    one block fits and the slots would fill shared memory. The pullback
    keeps its plan."""
    assert tsps._tile_rows(10) == _R10
    assert tsps.dvector_plan(n, k, d, dtype=dtype) == forward
    assert tsps.dvector_plan(n, k, d, pullback=True, dtype=dtype) == back


@pytest.mark.parametrize("n,k,d,want", [
    # the bf16 forward keeps v as bf16 (2 bytes a column): at k = 101 one
    # block up to (232,448 - the staging) / 2 = 100,064 columns, the sparse
    # GLM cell's 100,001 among them; a cluster of 2 up to twice that; L2
    (10_000_000, 101, 100_001, 1),
    (10_000_000, 101, (_BLOCK * 4 - 4 * _STAGE_101) // 2, 1),
    (10_000_000, 101, (_BLOCK * 4 - 4 * _STAGE_101) // 2 + 1, 2),
    (10_000_000, 101, _BLOCK * 4 - 4 * _STAGE_101, 2),
    (10_000_000, 101, _BLOCK * 4 - 4 * _STAGE_101 + 1, 0),
    # the score rows of the cell: still enough slots to fill one block
    (262_144, 101, 100_001, 1),
    (130_693, 101, 100_001, 0),
])
def test_dvector_plan_bf16_forward(n, k, d, want):
    assert (_BLOCK * 4 - 4 * _STAGE_101) // 2 == 100_064
    assert tsps.dvector_plan(n, k, d, dtype=torch.bfloat16) == want
    # the pullback keeps g's low words, 4 bytes a column, for either dtype
    assert (tsps.dvector_plan(n, k, d, pullback=True, dtype=torch.bfloat16)
            == tsps.dvector_plan(n, k, d, pullback=True))


def test_dvector_plan_fits_the_block():
    """Whatever the plan picks fits a block's shared memory (2 bytes a
    column of v for the bf16 forward, else 4), tile rows are a multiple of
    4 within a tile, a forward's one-block grid has a block an SM, and the
    plan is a pure function."""
    rng = np.random.RandomState(12)
    for _ in range(300):
        n = int(rng.randint(1, 10 ** 7))
        k = int(rng.randint(1, 600))
        d = int(rng.randint(1, 600_000))
        for pull in (False, True):
            for dt in (torch.float32, torch.bfloat16):
                c = tsps.dvector_plan(n, k, d, pullback=pull, dtype=dt)
                assert c == tsps.dvector_plan(n, k, d, pullback=pull,
                                              dtype=dt)
                assert c in (0,) + tsps._PLAN_CLUSTERS[pull]
                if not c:
                    continue
                R = tsps._tile_rows(k)
                if c == 1 and not pull:
                    assert -(-n // R) > tsps._GROUPS * (tsps._SMS - 1)
                assert R >= 4 and R % 4 == 0 and R * k <= tsps._TILE_SLOTS
                besides = 0 if pull else 8 * tsps._GROUPS * R * k
                width = 2 if dt == torch.bfloat16 and not pull else 4
                assert width * -(-d // c) + besides <= tsps._SMEM_BLOCK_BYTES
                assert n * k >= (tsps._SMS // c) * d
                assert not any(tsps._fits(k, d, s, pull, dt)
                               for s in tsps._PLAN_CLUSTERS[pull] if s < c)


# ---------------------------------------------------------------------------
# the other contractions, bit for bit on integer data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n,d", [(24, 9), (37, 17), (64, 5)])
def test_contractions_bit_exact_on_integer_data(n, d):
    rng = np.random.RandomState(n * d)
    dense, csr = _int_sparse(rng, n, d)
    Aj, At = _pair(jsps.ell_from_csr(csr))
    r = rng.randint(-3, 4, n).astype(np.float32)
    h = rng.randint(0, 4, n).astype(np.float32)
    B = rng.randint(-2, 3, (d, 3)).astype(np.float32)
    R = rng.randint(-2, 3, (n, 3)).astype(np.float32)
    cases = [
        (tsps.pullback(At, torch.as_tensor(r)),
         jsps.pullback(Aj, jnp.asarray(r)), dense.T @ r),
        (tsps.pullback_mat(At, torch.as_tensor(R)),
         jsps.pullback_mat(Aj, jnp.asarray(R)), dense.T @ R),
        (tsps.matmat(At, torch.as_tensor(B)),
         jsps.matmat(Aj, jnp.asarray(B)), dense @ B),
        (tsps.weighted_gram(At, torch.as_tensor(h)),
         jsps.weighted_gram(Aj, jnp.asarray(h)),
         dense.T @ (h[:, None] * dense)),
        (tsps.to_dense(At), jsps.to_dense(Aj), dense),
    ]
    for got, jax_out, want in cases:
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), np.asarray(jax_out))
        np.testing.assert_array_equal(got.numpy(), want)


def test_weighted_gram_chunks_like_one_pass(monkeypatch):
    """Row chunks with a ragged last chunk give the one-chunk Gram."""
    rng = np.random.RandomState(6)
    dense, csr = _int_sparse(rng, 50, 8)
    _, At = _pair(jsps.ell_from_csr(csr))
    h = torch.as_tensor(rng.randint(0, 4, 50).astype(np.float32))
    whole = tsps.weighted_gram(At, h)
    monkeypatch.setattr(tsps, "_GRAM_BUDGET", 3 * At.k * At.k)
    assert torch.equal(tsps.weighted_gram(At, h), whole)


def _float_container(rng, n, d, k):
    cols = rng.randint(0, d, (n, k)).astype(np.int32)
    vals = rng.standard_normal((n, k)).astype(np.float32)
    vals[:, -1] = 0.0  # a padded slot
    cols[:, -1] = 0
    return tsps.SparseRows(torch.as_tensor(vals), torch.as_tensor(cols), d)


def _pullback_mat_f64(A, R):
    out = np.zeros((A.d, R.shape[1]))
    np.add.at(out, A.cols.numpy().reshape(-1),
              (A.values.numpy().astype(np.float64)[:, :, None]
               * R.astype(np.float64)[:, None, :]).reshape(-1, R.shape[1]))
    return out


@pytest.mark.parametrize("n,d,k,m", [(200, 31, 7, 4), (1000, 300, 11, 10),
                                     (1, 5, 3, 2)])
def test_pullback_mat_fixed_point_within_1e6_of_float64(n, d, k, m):
    """Float data: the fixed-point sums within rtol 1e-6 of a float64
    scatter of the same f32 products, and the same bits in row chunks."""
    rng = np.random.RandomState(n + d)
    A = _float_container(rng, n, d, k)
    R = rng.standard_normal((n, m)).astype(np.float32)
    got = tsps.pullback_mat(A, torch.as_tensor(R))
    want = _pullback_mat_f64(A, R)
    assert got.dtype == torch.float32 and got.shape == (d, m)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())


def test_pullback_mat_chunks_and_bound_cache(monkeypatch):
    """Row chunks give the one-chunk bits; the bound is cached on the values
    tensor and dropped when the tensor is written to; a non-finite bound
    gives NaN everywhere."""
    rng = np.random.RandomState(3)
    A = _float_container(rng, 101, 17, 5)
    R = torch.as_tensor(rng.standard_normal((101, 3)).astype(np.float32))
    whole = tsps.pullback_mat(A, R)
    version, word = A.values._dml_absmax
    assert version == A.values._version
    assert word.view(torch.float32)[0] == A.values.abs().max()
    monkeypatch.setattr(tsps, "_PULLBACK_MAT_BUDGET", 4 * A.k * 3)
    assert torch.equal(tsps.pullback_mat(A, R), whole)
    A.values.mul_(2.0)  # a write bumps _version: the bound is taken again
    np.testing.assert_allclose(tsps.pullback_mat(A, R).numpy(),
                               2 * whole.numpy(), rtol=1e-6, atol=1e-6)
    assert A.values._dml_absmax[0] == A.values._version
    R[5, 1] = float("inf")
    assert torch.isnan(tsps.pullback_mat(A, R)).all()


@pytest.mark.parametrize("n,d,k,m", [(300, 40, 9, 5), (64, 7, 3, 3)])
def test_matmat_gradient_is_pullback_mat(n, d, k, m):
    """The softmax-shaped gradient through matmat: its backward for B is
    pullback_mat (within rtol 1e-6 of float64), for the values the
    slot-wise product of autograd's own gather."""
    rng = np.random.RandomState(n * m)
    A = _float_container(rng, n, d, k)
    B = torch.as_tensor(rng.standard_normal((d, m)).astype(np.float32))
    G = rng.standard_normal((n, m)).astype(np.float32)
    B.requires_grad_(True)
    vals = A.values.clone().requires_grad_(True)
    out = tsps.matmat(tsps.SparseRows(vals, A.cols, d), B)
    np.testing.assert_allclose(
        out.detach().numpy(),
        tsps.to_dense(A).numpy().astype(np.float64) @ B.detach().numpy(),
        rtol=1e-5, atol=1e-5)
    gB, gv = torch.autograd.grad(out, (B, vals), torch.as_tensor(G))
    want = _pullback_mat_f64(A, G)
    np.testing.assert_allclose(gB.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    assert torch.equal(gB, tsps.pullback_mat(A, torch.as_tensor(G)))
    Bg = B.detach().numpy().astype(np.float64)[A.cols.numpy()]  # (n, k, m)
    np.testing.assert_allclose(gv.numpy(), (Bg * G[:, None, :]).sum(2),
                               rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# container and encoding
# ---------------------------------------------------------------------------


def test_bucket_nnz_matches_jax():
    for k in list(range(0, 70)) + [100, 128, 129, 1000]:
        assert tshapes.bucket_nnz(k) == jshapes.bucket_nnz(k, record=False)
    assert tshapes.bucket_nnz(3, min_slots=16) == 16
    with pytest.raises(ValueError):
        tshapes.bucket_nnz(-1)


@pytest.mark.parametrize("n,d,k", [(23, 11, None), (16, 8, 8), (5, 300, 8)])
def test_ell_from_csr_and_intercept_match_slot_for_slot(n, d, k):
    rng = np.random.RandomState(n + d)
    dense, csr = _int_sparse(rng, n, d, density=0.3 if d < 100 else 0.004)
    tA = tsps.ell_from_csr(csr, k=k)
    jA = jsps.ell_from_csr(csr, k=k)
    assert tA.shape == jA.shape and tA.k == jA.k
    np.testing.assert_array_equal(tA.values, jA.values)
    np.testing.assert_array_equal(tA.cols, jA.cols)
    assert tA.cols.dtype == np.int32 and tA.values.dtype == np.float32
    for tB, jB in ((tsps.add_intercept_ell(tA), jsps.add_intercept_ell(jA)),
                   (tsps.add_intercept_ell(tA.to("cpu")),
                    jsps.add_intercept_ell(jax.device_put(jA)))):
        assert tB.d == jB.d == d + 1 and tB.k == jB.k
        np.testing.assert_array_equal(np.asarray(tB.values),
                                      np.asarray(jB.values))
        np.testing.assert_array_equal(np.asarray(tB.cols),
                                      np.asarray(jB.cols))
    np.testing.assert_array_equal(tsps.to_dense(tA).numpy(), dense)
    np.testing.assert_array_equal(
        tsps.ell_from_dense(dense, k=k).values, tA.values)


def test_ell_width_too_small_raises():
    rng = np.random.RandomState(0)
    _, csr = _int_sparse(rng, 16, 8, density=0.9)
    with pytest.raises(ValueError, match="widen k"):
        tsps.ell_from_csr(csr, k=1)
    with pytest.raises(TypeError):
        tsps.ell_from_csr(np.eye(3))


def test_container_surface():
    rng = np.random.RandomState(1)
    A = _dup_rows(rng, 10, 6, 4)
    assert A.shape == (10, 6) and A.ndim == 2 and A.k == 4
    assert A.dtype == np.float32
    assert A.nbytes == A.values.nbytes + A.cols.nbytes
    T = A.to("cpu")
    assert isinstance(T.values, torch.Tensor) and T.cols.dtype == torch.int32
    assert T.nbytes == A.nbytes and T.dtype == torch.float32
    sub = T[2:5]
    assert sub.shape == (3, 6) and torch.equal(sub.cols, T.cols[2:5])
    assert T[np.array([0, 3])].shape == (2, 6)
    with pytest.raises(TypeError, match="scalar"):
        T[3]
    assert "SparseRows" in repr(T)


def test_kernel_wrapper_refuses_what_it_cannot_take():
    """kernel='cuda' needs CUDA tensors; the wrapper raises rather than
    running the plain version."""
    rng = np.random.RandomState(2)
    _, csr = _int_sparse(rng, 8, 5)
    _, At = _pair(jsps.ell_from_csr(csr))
    v = torch.zeros(5)
    with pytest.raises(ValueError, match="CUDA"):
        tsps.matvec(At, v, kernel="cuda")
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsps._spmv_cuda(At.values, At.cols, v)
    with pytest.raises(ValueError, match="int32 cols"):
        tsps._spmv_cuda(At.values, At.cols.long(), v)
    with pytest.raises(ValueError, match="kernel must be"):
        tsps.matvec(At, v, kernel="xla")


def test_pullback_wrapper_refuses_what_it_cannot_take():
    """The pullback's wrapper holds its arguments as K6's does, before it
    builds or launches anything."""
    rng = np.random.RandomState(2)
    _, csr = _int_sparse(rng, 8, 5)
    _, At = _pair(jsps.ell_from_csr(csr))
    r = torch.zeros(8)
    with pytest.raises(ValueError, match="CUDA tensors"):
        tsps._pullback_cuda(At.values, At.cols, r, At.d)
    with pytest.raises(ValueError, match="int32 cols"):
        tsps._pullback_cuda(At.values, At.cols.long(), r, At.d)
    with pytest.raises(ValueError, match="1-D f32 r"):
        tsps._pullback_cuda(At.values, At.cols, r.double(), At.d)
    with pytest.raises(ValueError, match="1-D f32 r"):
        tsps._pullback_cuda(At.values, At.cols, r[:, None], At.d)
    with pytest.raises(ValueError, match=r"one \(n, k\) shape"):
        tsps._pullback_cuda(At.values, At.cols[:, :1], r, At.d)
    with pytest.raises(ValueError, match=r"one \(n, k\) shape"):
        tsps._spmv_cuda(At.values[0], At.cols[0], torch.zeros(5))


def test_pullback_hands_the_kernel_a_contiguous_f32_r(monkeypatch):
    """The public ``pullback`` takes any ``r`` the plain version takes (a
    strided view, float64): the kernel's wrapper, which refuses both, gets
    it contiguous in f32."""
    rng = np.random.RandomState(4)
    _, csr = _int_sparse(rng, 16, 6)
    _, At = _pair(jsps.ell_from_csr(csr))
    r = torch.arange(32, dtype=torch.float64)[::2]
    seen = {}

    def wrapper(values, cols, r, d):
        seen.update(dtype=r.dtype, contiguous=r.is_contiguous())
        return tsps._pullback_ref(values, cols, r, d)

    monkeypatch.setattr(tsps, "_pullback_cuda", wrapper)
    monkeypatch.setattr(_kernels, "use_cuda", lambda kernel, t: True)
    got = tsps.pullback(At, r, kernel="cuda")
    assert seen == {"dtype": torch.float32, "contiguous": True}
    monkeypatch.undo()
    assert torch.equal(got, tsps.pullback(At, r))


# ---------------------------------------------------------------------------
# the sparse generator
# ---------------------------------------------------------------------------


def test_make_sparse_classification_bit_for_bit():
    args = (10_000, 700, 0.01)
    jX, jy, jcoef = jdatasets.make_sparse_classification(
        *args, random_state=42, return_coef=True)
    tX, ty, tcoef = tdatasets.make_sparse_classification(
        *args, random_state=42, return_coef=True)
    assert tX.shape == jX.shape and tX.k == jX.k == 7
    np.testing.assert_array_equal(tX.values, jX.values)
    np.testing.assert_array_equal(tX.cols, jX.cols)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_array_equal(tcoef, jcoef)
    # blocks: any blocking gives the same rows
    jb = jdatasets.make_sparse_classification(*args, random_state=42,
                                              n_blocks=3)
    tb = tdatasets.make_sparse_classification(*args, random_state=42,
                                              n_blocks=3)
    for b in range(3):
        (tXb, tyb, twb), (jXb, jyb, _) = tb(b), jb(b)
        np.testing.assert_array_equal(tXb.values, jXb.values)
        np.testing.assert_array_equal(tXb.cols, jXb.cols)
        np.testing.assert_array_equal(tyb, jyb)
        assert (twb == 1).all()
    mX, my, _ = tb.materialize()
    np.testing.assert_array_equal(mX.values, tX.values)
    np.testing.assert_array_equal(my, ty)
    with pytest.raises(IndexError):
        tb(3)
    with pytest.raises(TypeError, match="INTEGER"):
        tdatasets.make_sparse_classification(random_state=None)


# ---------------------------------------------------------------------------
# validation and staging
# ---------------------------------------------------------------------------


def test_check_array_sparse_branch():
    rng = np.random.RandomState(7)
    _, csr = _int_sparse(rng, 20, 6)
    assert check_array(csr, accept_sparse=True) is csr
    out = check_array(csr.astype(np.float64), accept_sparse=True)
    assert out.dtype == np.float32 and out.nnz == csr.nnz
    with pytest.raises(TypeError, match=r"tocsr"):
        check_array(csr.tocsc(), accept_sparse=True)
    with pytest.raises(TypeError, match="sparse"):
        check_array(csr)  # the dense-only default
    bad = csr.copy()
    bad.data[0] = np.nan
    with pytest.raises(ValueError, match="NaN or infinity"):
        check_array(bad, accept_sparse=True)
    oob = csr.copy()
    oob.indices[0] = 6
    with pytest.raises(ValueError, match=r"\[0, 6\)"):
        check_array(oob, accept_sparse=True)
    # containers, host and staged: int values cast, range and NaN checked
    A_int = tsps.SparseRows(np.array([[1, 2], [3, 0]], np.int32),
                            np.array([[0, 2], [1, 0]], np.int32), 3)
    out = check_array(A_int, accept_sparse=True)
    assert out.values.dtype == np.float32
    np.testing.assert_array_equal(out.values, A_int.values)
    A_ok = tsps.SparseRows(np.ones((4, 2), np.float32),
                           np.zeros((4, 2), np.int32), 2)
    assert check_array(A_ok, accept_sparse=True) is A_ok
    staged = A_ok.to("cpu")
    assert check_array(staged, accept_sparse=True) is staged
    for A in (tsps.SparseRows(np.array([[np.nan, 1.0]], np.float32),
                              np.array([[0, 1]], np.int32), 2),
              tsps.SparseRows(torch.tensor([[np.inf, 1.0]]),
                              torch.tensor([[0, 1]], dtype=torch.int32), 2)):
        with pytest.raises(ValueError, match="NaN or infinity"):
            check_array(A, accept_sparse=True)
    for cols in (np.array([[0, 2]], np.int32), np.array([[-1, 0]], np.int32),
                 torch.tensor([[0, 2]], dtype=torch.int32)):
        vals = np.ones((1, 2), np.float32)
        A = tsps.SparseRows(torch.as_tensor(vals) if isinstance(
            cols, torch.Tensor) else vals, cols, 2)
        with pytest.raises(ValueError, match=r"\[0, 2\)"):
            check_array(A, accept_sparse=True)
    with pytest.raises(TypeError, match="sparse"):
        check_array(A_ok)


def test_prepare_data_stages_one_contiguous_container():
    rng = np.random.RandomState(8)
    dense, csr = _int_sparse(rng, 30, 8)
    assert is_sparse_input(csr) and not is_sparse_input(dense)
    A = tsps.ell_from_csr(csr)
    assert is_sparse_input(A)
    for X in (csr, A):
        data = prepare_data(X, y=np.arange(30))
        assert isinstance(data.X, tsps.SparseRows)
        assert data.n == 30 and data.n_features == 8
        assert data.X.values.shape == (30, A.k)  # no row or slot padding
        assert data.X.values.dtype == torch.float32
        assert data.X.cols.dtype == torch.int32
        assert data.X.values.is_contiguous() and data.X.cols.is_contiguous()
        assert data.y.dtype == torch.float32 and float(data.y[-1]) == 29.0
        assert float(data.weights.sum()) == 30.0
        np.testing.assert_array_equal(tsps.to_dense(data.X).numpy(), dense)
        sub = unpad_rows(data.X, 10)
        assert sub.shape == (10, 8)
    with pytest.raises(ValueError, match="y shape"):
        prepare_data(csr, y=np.arange(3))


def test_kmeans_still_rejects_sparse():
    from dask_ml_tpu_torch.cluster import KMeans

    rng = np.random.RandomState(9)
    _, csr = _int_sparse(rng, 30, 8)
    with pytest.raises(TypeError, match="sparse"):
        KMeans(n_clusters=2).fit(csr)
    with pytest.raises(TypeError, match="sparse"):
        KMeans(n_clusters=2).fit(tsps.ell_from_csr(csr))


@pytest.mark.parametrize("kernel", ["auto", "torch"])
@pytest.mark.parametrize("length", [6, 14])
def test_spmv_and_matvec_refuse_a_vector_of_another_length(kernel, length):
    """A ``v`` whose length is not the container's width is refused before
    anything runs: the plain path would read the wrong columns (or past
    ``v``), and so would the kernel."""
    rng = np.random.RandomState(0)
    _, csr = _int_sparse(rng, 20, 10)
    A = _pair(tsps.ell_from_csr(csr))[1]
    v = torch.ones(length)
    before = dict(_kernels.launches)
    for fn in (tsps.spmv, tsps.matvec):
        with pytest.raises(ValueError, match=r"shape \(10,\)"):
            fn(A, v, kernel=kernel)
    with pytest.raises(ValueError, match=r"shape \(10,\)"):
        tsps.spmv(A, torch.ones((10, 1)), kernel=kernel)
    assert _kernels.launches == before
    assert tsps.matvec(A, torch.ones(10), kernel=kernel).shape == (20,)


@pytest.mark.parametrize("rows", [6, 14])
def test_matmat_refuses_an_operand_of_another_height(rows):
    rng = np.random.RandomState(1)
    _, csr = _int_sparse(rng, 20, 10)
    A = _pair(tsps.ell_from_csr(csr))[1]
    with pytest.raises(ValueError, match=r"shape \(10, m\)"):
        tsps.matmat(A, torch.ones((rows, 3)))
    assert tsps.matmat(A, torch.ones((10, 3))).shape == (20, 3)


# ---------------------------------------------------------------------------
# bf16 containers (the JAX package's bf16 case)
# ---------------------------------------------------------------------------


def _bf16_pair(rng, n, d):
    """A bf16 container both packages build from one CSR (integer values,
    exact in bf16), as ``ell_from_csr(..., dtype=bfloat16)`` makes it."""
    dense, csr = _int_sparse(rng, n, d)
    Ah = jsps.ell_from_csr(csr, dtype=jnp.bfloat16)
    Aj = jsps.SparseRows(jnp.asarray(Ah.values), jnp.asarray(Ah.cols), Ah.d)
    At = tsps.ell_from_csr(csr, dtype=torch.bfloat16)
    return dense, Aj, At


def _grid(rng, size):
    """Values on a 1/256 grid with up to ten significant bits: bf16
    rounds them, products of bf16 operands and short sums stay exact."""
    return (rng.randint(-512, 512, size) / 256.0).astype(np.float32)


def test_bf16_container_matches_jax_slot_for_slot():
    rng = np.random.RandomState(21)
    _, Aj, At = _bf16_pair(rng, 90, 11)
    assert At.values.dtype == torch.bfloat16 and At.cols.dtype == torch.int32
    assert At.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        At.values.float().numpy(), np.asarray(Aj.values, np.float32))
    np.testing.assert_array_equal(At.cols.numpy(), np.asarray(Aj.cols))
    assert tsps._accum_dtype(At) == torch.float32
    with config_context(precision="bf16"):
        staged = prepare_data(
            scipy_sparse.csr_matrix(tsps.to_dense(At).numpy())).X
    assert staged.values.dtype == torch.bfloat16
    assert staged.cols.dtype == torch.int32


@pytest.mark.parametrize("n,d", [(512, 33), (256, 9), (1, 6)])
def test_bf16_spmv_bitexact_vs_jax_pallas(n, d):
    """K6's plain version on a bf16 container against the JAX Pallas SpMV
    in interpret mode, bit for bit (tolerance 0): v rounded to bf16, each
    product formed in f32, f32 row sums. (The JAX XLA ``matvec`` rounds
    each product to bf16 instead: not the kernel's function.)"""
    rng = np.random.RandomState(n + d)
    _, Aj, At = _bf16_pair(rng, n, d)
    v = _grid(rng, d)
    got = tsps.matvec(At, torch.as_tensor(v), kernel="torch")
    assert got.dtype == torch.float32
    want = jsps.matvec(Aj, jnp.asarray(v), kernel="pallas")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the function: the f32 product of the rounded operands
    vr = torch.as_tensor(v).to(torch.bfloat16).float()
    np.testing.assert_array_equal(
        got.numpy(), tsps.matvec(tsps.SparseRows(At.values.float(), At.cols,
                                                 At.d), vr).numpy())


@pytest.mark.parametrize("n,d", [(40, 7), (300, 9)])
def test_bf16_pullbacks_bitexact_vs_jax(n, d):
    """K6-b's plain version, ``pullback_mat`` and ``matmat`` on a bf16
    container, bit for bit (tolerance 0) against the JAX package on the
    same values widened to f32: the pullbacks keep the cotangent in f32
    and form f32 products (the JAX bf16 ``pullback`` rounds both to bf16,
    which loses a logistic gradient: see ``ops/sparse.py``), ``matmat``
    rounds B to bf16 and forms f32 products, as K6 does."""
    rng = np.random.RandomState(7 * n + d)
    _, Aj16, At = _bf16_pair(rng, n, d)
    Aj = jsps.SparseRows(Aj16.values.astype(jnp.float32), Aj16.cols, Aj16.d)
    r = _grid(rng, n)
    got = tsps.pullback(At, torch.as_tensor(r))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jsps.pullback(Aj, jnp.asarray(r))))
    R = _grid(rng, (n, 3))
    np.testing.assert_array_equal(
        tsps.pullback_mat(At, torch.as_tensor(R)).numpy(),
        np.asarray(jsps.pullback_mat(Aj, jnp.asarray(R))))
    B = _grid(rng, (d, 3))
    Br = jnp.asarray(B, jnp.bfloat16).astype(jnp.float32)
    np.testing.assert_array_equal(
        tsps.matmat(At, torch.as_tensor(B)).numpy(),
        np.asarray(jsps.matmat(Aj, Br)))
    # autograd through the port's spmv: the same f32 pullback
    v = torch.tensor(_grid(rng, d), requires_grad=True)
    (gv,) = torch.autograd.grad(
        torch.dot(tsps.spmv(At, v), torch.as_tensor(r)), v)
    np.testing.assert_array_equal(gv.numpy(), got.numpy())


def test_bf16_pullback_keeps_the_logistic_gradient():
    """Why the bf16 pullback keeps its cotangent in f32. Near σ(η) = ½ a
    logistic cotangent is ±½ plus what η adds, and bf16's 8 bits round
    that part away: with balanced labels the intercept column's gradient
    is exactly that part. Against the float64 gradient of the same bf16
    values, the port's intercept gradient is within 1e-5 (relative) and
    its other columns within 1e-5 (normwise); the JAX bf16 ``pullback``,
    which rounds the cotangent and each product to bf16, is off by more
    than a quarter of the intercept's gradient (0.49 here)."""
    rng = np.random.RandomState(5)
    n, d, k = 20_000, 50, 6
    cols = rng.randint(0, d, (n, k)).astype(np.int32)
    vals = rng.randn(n, k).astype(np.float32)
    # the intercept: one more slot a row, column d, value 1
    cols = np.concatenate([cols, np.full((n, 1), d, np.int32)], 1)
    vals = np.concatenate([vals, np.ones((n, 1), np.float32)], 1)
    A16 = tsps.SparseRows(torch.as_tensor(vals).to(torch.bfloat16),
                          torch.as_tensor(cols), d + 1)
    eta = torch.as_tensor((rng.randn(n) * 1e-3 + 4e-4).astype(np.float32))
    y = torch.as_tensor((np.arange(n) % 2).astype(np.float32))
    r = (torch.sigmoid(eta) - y) / n
    exact = torch.zeros(d + 1, dtype=torch.float64).index_add_(
        0, A16.cols.reshape(-1).long(),
        (A16.values.double() * r.double()[:, None]).reshape(-1))
    g16 = tsps.pullback(A16, r).double()
    assert abs(float(g16[-1] - exact[-1])) <= 1e-5 * abs(float(exact[-1]))
    assert float((g16[:-1] - exact[:-1]).norm() / exact[:-1].norm()) <= 1e-5
    jax_g = np.asarray(jsps.pullback(
        jsps.SparseRows(jnp.asarray(vals, jnp.bfloat16), jnp.asarray(cols),
                        d + 1), jnp.asarray(r.numpy())), np.float64)
    jax_rel = abs(jax_g[-1] - float(exact[-1])) / abs(float(exact[-1]))
    assert jax_rel > 0.25, jax_rel


def test_bf16_weighted_gram_accumulates_f32():
    rng = np.random.RandomState(31)
    dense, Aj, At = _bf16_pair(rng, 200, 8)
    h = rng.randint(0, 3, 200).astype(np.float32)
    got = tsps.weighted_gram(At, torch.as_tensor(h))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), dense.T @ (h[:, None] * dense))


# ---------------------------------------------------------------------------
# the sparse preprocessing: column ranges, moments, duplicates, scaling
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("edges", [[], [4, 9], [0, 12], [5, 5, 7]])
@pytest.mark.parametrize("host", [True, False])
def test_split_merge_cols_match_jax(edges, host):
    rng = np.random.RandomState(2)
    dense, csr = _int_sparse(rng, 40, 12)
    A = tsps.ell_from_csr(csr)
    if not host:
        A = A.to("cpu")
    jA, _ = _pair(tsps.ell_from_csr(csr))
    blocks = tsps.split_cols(A, edges)
    jblocks = jsps.split_cols(jA, edges)
    assert [b.d for b in blocks] == [b.d for b in jblocks]
    for b, jb in zip(blocks, jblocks):
        np.testing.assert_array_equal(np.asarray(b.values),
                                      np.asarray(jb.values))
        np.testing.assert_array_equal(np.asarray(b.cols),
                                      np.asarray(jb.cols))
        assert isinstance(b.values, np.ndarray) == host
    merged = tsps.merge_cols(blocks)
    np.testing.assert_array_equal(tsps.to_dense(merged).numpy(), dense)
    jm = jsps.merge_cols(jblocks)
    np.testing.assert_array_equal(np.asarray(merged.cols),
                                  np.asarray(jm.cols))
    v = torch.as_tensor(rng.randint(-3, 4, 12).astype(np.float32))
    # matvec(A, v) is the sum over the blocks (a zero-width block adds 0)
    parts = sum(tsps.matvec(b.to("cpu"), v[lo:lo + b.d]) for b, lo in zip(
        blocks, np.cumsum([0] + [b.d for b in blocks])[:-1]) if b.d)
    np.testing.assert_array_equal(parts.numpy(), dense @ v.numpy())


def test_split_merge_refusals():
    A = tsps.ell_from_dense(np.eye(4, dtype=np.float32))
    with pytest.raises(ValueError, match="nondecreasing"):
        tsps.split_cols(A, [3, 1])
    with pytest.raises(ValueError, match="nondecreasing"):
        tsps.split_cols(A, [5])
    with pytest.raises(ValueError, match="at least one"):
        tsps.merge_cols([])
    with pytest.raises(ValueError, match="row count"):
        tsps.merge_cols([A, A[:2]])


@pytest.mark.parametrize("n", [32, 64])
def test_column_moments_bit_for_bit_on_integer_data(n):
    """At most 64 rows of unit weight, integer values in [-3, 4): a mean
    is a multiple of 1/n, a squared deviation has at most 18 significant
    bits and a column's sum of them fits f32's 24, so every sum is exact
    and the port's pullback sums equal the JAX segment sums bit for bit;
    a zero-weight row drops out of both."""
    rng = np.random.RandomState(n)
    dense, csr = _int_sparse(rng, n, 17)
    A = tsps.ell_from_csr(csr)
    jA, tA = _pair(A)
    w = np.ones(n, np.float32)
    w[3] = 0.0
    w[5] = 2.0
    got = tsps.column_moments(tA, torch.as_tensor(w))
    want = jsps.column_moments(jA, jnp.asarray(w))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    w[5] = 1.0
    w[3] = 1.0
    got = tsps.column_mean_var(tA, torch.as_tensor(w))
    want = jsps.column_mean_var(jA, jnp.asarray(w))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    np.testing.assert_array_equal(got[1].numpy(),
                                  dense.astype(np.float64).var(0))


def test_column_mean_var_float_data_close_to_jax():
    rng = np.random.RandomState(9)
    dense = (rng.randn(333, 30) * (rng.uniform(size=(333, 30)) < 0.1)
             ).astype(np.float32)
    dense[:, 3] += (dense[:, 3] != 0) * 1e3  # mean ≫ spread
    jA, tA = _pair(tsps.ell_from_csr(scipy_sparse.csr_matrix(dense)))
    w = rng.uniform(0.5, 2.0, 333).astype(np.float32)
    got = tsps.column_mean_var(tA, torch.as_tensor(w))
    want = jsps.column_mean_var(jA, jnp.asarray(w))
    for a, b in zip(got, want):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=1e-5,
                                   atol=1e-6)


def test_has_duplicate_slots_matches_jax(monkeypatch):
    rng = np.random.RandomState(4)
    dup = _dup_rows(rng, 50, 9, 5)
    _, csr = _int_sparse(rng, 50, 9)
    clean = tsps.ell_from_csr(csr)
    split = tsps.split_cols(clean, [4])[0]  # blanked slots alias column 0
    one = tsps.SparseRows(clean.values[:, :1], clean.cols[:, :1], clean.d)
    for A, want in ((dup, True), (clean, False), (split, False),
                    (one, False)):
        jA, tA = _pair(A)
        assert bool(tsps.has_duplicate_slots(tA)) is want
        assert bool(jsps.has_duplicate_slots(jA)) is want
    # the row chunks of the sort see a duplicate in the last chunk only
    monkeypatch.setattr(tsps, "_DUP_CHUNK_SLOTS", 10)
    late = tsps.SparseRows(clean.values.copy(), clean.cols.copy(), clean.d)
    late.values[-1, :2] = 1.0
    late.cols[-1, :2] = 3
    assert bool(tsps.has_duplicate_slots(late))
    assert not bool(tsps.has_duplicate_slots(clean))


def test_scale_columns_matches_jax():
    rng = np.random.RandomState(5)
    dense = (rng.randn(60, 14) * (rng.uniform(size=(60, 14)) < 0.3)
             ).astype(np.float32)
    jA, tA = _pair(tsps.ell_from_csr(scipy_sparse.csr_matrix(dense)))
    scale = rng.uniform(0.5, 3.0, 14).astype(np.float32)
    got = tsps.scale_columns(tA, scale)
    want = jsps.scale_columns(jA, jnp.asarray(scale))
    np.testing.assert_array_equal(got.values.numpy(),
                                  np.asarray(want.values))
    assert got.cols is tA.cols and got.d == tA.d
    # bf16 values scale in f32 and round back
    b16 = tsps.SparseRows(tA.values.to(torch.bfloat16), tA.cols, tA.d)
    out = tsps.scale_columns(b16, scale)
    assert out.values.dtype == torch.bfloat16
    ref = (b16.values.float() * (1.0 / torch.as_tensor(scale))[
        b16.cols.long()]).to(torch.bfloat16)
    assert torch.equal(out.values, ref)

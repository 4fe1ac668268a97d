"""The PyTorch port's streamed solvers and checkpointed fits held against
the JAX package, on the CPU.

The same numpy blocks go through both packages:

- ``admm_streamed`` (host source and callable modes) and the facades'
  ``fit_blocks``: coefficients and the stacked state within rtol 1e-4 /
  atol 1e-5 and the same ``n_iter``, the tolerance of the in-memory ADMM
  parity tests (the two packages sum in other orders, and an iterative
  solver carries the ulps forward);
- ``streamed_moments``: ``(sw, s, G)`` within rtol 1e-5; ``pca_fit_blocks``
  components and variances within rtol 1e-4 over the well-separated top
  of the spectrum;
- ``solve_checkpointed`` and the facades' ``checkpoint=``: within the
  ADMM tolerance of the JAX package's run, and bit-identical to the
  port's own uninterrupted run when preempted and resumed;
- a ``ScanCheckpoint`` snapshot written by one package and resumed by the
  other lands within 1e-4 of the uninterrupted run of the writer.

Within the port, the two block-source modes give the same bits from the
same blocks, and a preempted run resumes bit for bit.
"""

import os

import numpy as np
import pytest
import scipy.sparse as scipy_sparse
import torch

import jax.numpy as jnp

from dask_ml_tpu import checkpoint as jckpt
from dask_ml_tpu import linear_model as jlm
from dask_ml_tpu.decomposition import streaming as jstreaming
from dask_ml_tpu.models import glm as jcore
from dask_ml_tpu.parallel import faults as jfaults
from dask_ml_tpu.parallel import stream as jstream
from dask_ml_tpu_torch import checkpoint as ckpt
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch import linear_model as tlm
from dask_ml_tpu_torch.convert import stream_state_from_numpy
from dask_ml_tpu_torch.decomposition import PCA, streaming
from dask_ml_tpu_torch.models import glm as tcore
from dask_ml_tpu_torch.ops import sparse as tsps
from dask_ml_tpu_torch.parallel.faults import (FaultInjector, Preempted,
                                               RetryPolicy)
from dask_ml_tpu_torch.parallel.stream import HostBlockSource

COEF_TOL = dict(rtol=1e-4, atol=1e-5)
MOMENT_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def on_cpu():
    with config_context(device="cpu"):
        yield


def _problem(n=640, d=5, seed=0, family="logistic"):
    rng = np.random.RandomState(seed)
    X = rng.randn(n, d).astype(np.float32)
    beta = rng.randn(d).astype(np.float32)
    eta = X @ beta
    if family == "logistic":
        y = (eta + 0.5 * rng.randn(n) > 0).astype(np.float32)
    else:
        y = (eta + 0.3 * rng.randn(n)).astype(np.float32)
    return X, y, np.ones(n, np.float32)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _assert_state(port, jax_, tol=COEF_TOL):
    for a, b in zip(port, jax_):
        np.testing.assert_allclose(_np(a), _np(b), **tol)


# ---------------------------------------------------------------------------
# admm_streamed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("family,regularizer,kw", [
    ("logistic", "l2", dict(n_blocks=8, seed=1, lamduh=1.0, abstol=1e-2,
                            reltol=1e-1, max_iter=100)),
    ("normal", "l1", dict(n_blocks=4, seed=0, lamduh=0.5, abstol=0.0,
                          reltol=0.0, max_iter=12)),
], ids=["logistic-l2-converging", "normal-l1-tol0"])
def test_admm_streamed_host_matches_jax(family, regularizer, kw):
    kw = dict(kw)
    B, seed = kw.pop("n_blocks"), kw.pop("seed")
    X, y, w = _problem(family=family, seed=seed)
    n, d = X.shape
    kw.update(family=family, regularizer=regularizer, return_state=True)
    jz, jn, jstate, _ = jcore.admm_streamed(
        jstream.HostBlockSource((X, y, w), B), B, d, float(n), **kw)
    src = HostBlockSource((X, y, w), B)
    z, n_iter, state, _ = tcore.admm_streamed(src, B, d, float(n), **kw)
    assert n_iter == int(jn)
    _assert_state(state, jstate)
    assert src._inflight == {}
    if kw["abstol"]:
        # converged early: the wrapped lookahead was discarded
        assert n_iter < kw["max_iter"]
    assert src.blocks_started == B * n_iter


def test_admm_streamed_modes_agree_bit_for_bit_and_follow_admm():
    """Callable mode over the same blocks gives the host mode's bits; the
    in-memory admm over the same B row blocks takes the same
    trajectory."""
    X, y, w = _problem(seed=1)
    n, d = X.shape
    kw = dict(lamduh=0.3, abstol=0.0, reltol=0.0, max_iter=5,
              return_state=True)
    _, n1, s1, _ = tcore.admm_streamed(HostBlockSource((X, y, w), 4), 4, d,
                                       float(n), **kw)
    Xt, yt, wt = (torch.from_numpy(a) for a in (X, y, w))

    def block_fn(b):
        s = slice(b * 160, (b + 1) * 160)
        return Xt[s].clone(), yt[s].clone(), wt[s].clone()

    _, n2, s2, _ = tcore.admm_streamed(block_fn, 4, d, float(n), **kw)
    assert n1 == n2 == 5
    for a, b in zip(s1, s2):
        assert torch.equal(a, b)
    _, n3, s3, _ = tcore.admm(Xt, yt, wt, torch.zeros(d), torch.ones(d),
                              n_shards=4, **kw)
    assert n3 == 5
    _assert_state(s1, s3, dict(rtol=1e-5, atol=1e-6))


def test_admm_streamed_state_resume_and_validation():
    X, y, w = _problem(n=320, seed=2)
    n, d = X.shape
    kw = dict(lamduh=0.3, abstol=0.0, reltol=0.0, return_state=True)
    src = HostBlockSource((X, y, w), 4)
    _, _, full, _ = tcore.admm_streamed(src, 4, d, float(n), max_iter=6,
                                        **kw)
    _, _, half, _ = tcore.admm_streamed(src, 4, d, float(n), max_iter=3,
                                        **kw)
    _, n2, rest, _ = tcore.admm_streamed(
        src, 4, d, float(n), max_iter=3,
        state=tuple(t.numpy() for t in half), **kw)
    assert n2 == 3
    for a, b in zip(full, rest):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="block counts"):
        tcore.admm_streamed(src, 4, d, float(n), state=(
            np.zeros(d), np.zeros((2, d)), np.zeros((2, d))))
    with pytest.raises(ValueError, match="does not match"):
        tcore.admm_streamed(src, 8, d, float(n))
    with pytest.raises(ValueError, match="HostBlockSource"):
        tcore.admm_streamed(lambda b: None, 4, d, float(n),
                            checkpoint_path="unused")
    with pytest.raises(NotImplementedError, match="item 10"):
        tcore.admm_streamed(src, 4, d, float(n), elastic=object())


@pytest.mark.parametrize("preempt_at", [(0, 0), (2, 1), (4, 3)],
                         ids=["first-block", "mid-epoch", "last-block"])
def test_admm_streamed_preempt_resume_bit_identical(tmp_path, preempt_at):
    epoch, block = preempt_at
    X, y, w = _problem(n=320, d=4)
    n, d = X.shape
    kw = dict(family="logistic", regularizer="l2", lamduh=0.5, abstol=0.0,
              reltol=0.0, max_iter=5)
    _, _, full, _ = tcore.admm_streamed(
        HostBlockSource((X, y, w), 4), 4, d, float(n), return_state=True,
        **kw)
    path = str(tmp_path / "admm.ckpt")
    inj = FaultInjector().preempt_at(block=block, epoch=epoch)
    with pytest.raises(Preempted) as ei:
        tcore.admm_streamed(
            HostBlockSource((X, y, w), 4, fault_injector=inj), 4, d,
            float(n), checkpoint_path=path, **kw)
    assert ei.value.path == path and os.path.exists(path)
    _, n_iter, res, _ = tcore.admm_streamed(
        HostBlockSource((X, y, w), 4), 4, d, float(n), checkpoint_path=path,
        return_state=True, **kw)
    assert n_iter == 5
    for a, b in zip(full, res):
        assert torch.equal(a, b)
    assert not os.path.exists(path)


def test_admm_streamed_transient_faults_identical_results():
    X, y, w = _problem(n=320, d=4)
    n, d = X.shape
    kw = dict(family="logistic", regularizer="l1", lamduh=0.3, abstol=0.0,
              reltol=0.0, max_iter=4)
    clean_src = HostBlockSource((X, y, w), 4)
    z_clean, _ = tcore.admm_streamed(clean_src, 4, d, float(n), **kw)
    pol = RetryPolicy(max_retries=3, sleep=lambda s: None)
    inj = FaultInjector().fail_load(1, times=2).fail_transfer(3, times=1)
    src = HostBlockSource((X, y, w), 4, retry_policy=pol, fault_injector=inj)
    z, _ = tcore.admm_streamed(src, 4, d, float(n), **kw)
    assert torch.equal(z, z_clean)
    s = pol.stats()
    assert s["retries"] == 3 and s["giveups"] == 0
    assert s["by_kind"] == {"block-load": 2, "device-put": 1}
    assert src.blocks_started == 16
    assert src.bytes_streamed == clean_src.bytes_streamed


def test_admm_streamed_checkpoint_rejects_different_problem(tmp_path):
    X, y, w = _problem(n=320, d=4)
    n, d = X.shape
    path = str(tmp_path / "admm.ckpt")
    inj = FaultInjector().preempt_at(block=1, epoch=1)
    with pytest.raises(Preempted):
        tcore.admm_streamed(
            HostBlockSource((X, y, w), 4, fault_injector=inj), 4, d,
            float(n), max_iter=4, checkpoint_path=path, lamduh=0.5,
            abstol=0.0, reltol=0.0)
    with pytest.raises(ValueError, match="different problem"):
        tcore.admm_streamed(
            HostBlockSource((X, y, w), 4), 4, d, float(n), max_iter=4,
            checkpoint_path=path, lamduh=0.9, abstol=0.0, reltol=0.0)


def test_admm_streamed_sparse_blocks():
    """SparseRows blocks (the intercept appended per block) follow the
    in-memory admm over the same container's row blocks, and the JAX
    package's dense streamed ADMM over the densified blocks."""
    rng = np.random.RandomState(4)
    n, d = 512, 12
    D = ((rng.rand(n, d) < 0.3) * rng.randn(n, d)).astype(np.float32)
    y = (D @ rng.randn(d) + 0.3 * rng.randn(n) > 0).astype(np.float32)
    w = np.ones(n, np.float32)
    A = tsps.ell_from_csr(scipy_sparse.csr_matrix(D))
    kw = dict(lamduh=0.5, abstol=0.0, reltol=0.0, max_iter=4,
              return_state=True)
    est = tlm.LogisticRegression(solver="admm", max_iter=4,
                                 solver_kwargs={"abstol": 0.0,
                                                "reltol": 0.0})
    src = HostBlockSource((A, y, w), 4)
    est.fit_blocks(src, 4, n, d)
    assert src.blocks_started == 16  # the intercept copy's counts
    Ai = tsps.add_intercept_ell(A).to("cpu")
    mask = torch.ones(d + 1)
    mask[-1] = 0.0
    _, n_mem, s_mem, _ = tcore.admm(
        Ai, torch.from_numpy(y), torch.from_numpy(w), torch.zeros(d + 1),
        mask, n_shards=4, **dict(kw, lamduh=1.0))
    assert est.n_iter_ == n_mem == 4
    np.testing.assert_allclose(est._coef, s_mem[0].numpy(), rtol=1e-5,
                               atol=1e-6)
    Di = np.concatenate([D, np.ones((n, 1), np.float32)], 1)
    _, jn, jstate, _ = jcore.admm_streamed(
        jstream.HostBlockSource((Di, y, w), 4), 4, d + 1, float(n),
        mask=jnp.asarray(mask.numpy()), **dict(kw, lamduh=1.0))
    assert int(jn) == 4
    np.testing.assert_allclose(est._coef, np.asarray(jstate[0]), **COEF_TOL)


# ---------------------------------------------------------------------------
# streamed moments and PCA
# ---------------------------------------------------------------------------


def _pca_data(n=2000, d=8, seed=0):
    rng = np.random.RandomState(seed)
    X = (rng.randn(n, d) * np.linspace(3.0, 0.3, d) + 1.0).astype(np.float32)
    w = rng.rand(n).astype(np.float32)
    return X, w


def test_streamed_moments_match_jax_in_both_modes():
    X, w = _pca_data()
    jm = jstreaming.streamed_moments(
        block_fn=jstream.HostBlockSource((X, w), 8), n_blocks=8)
    host = streaming.streamed_moments(block_fn=HostBlockSource((X, w), 8),
                                      n_blocks=8)
    Xt, wt = torch.from_numpy(X), torch.from_numpy(w)

    def block_fn(b):
        return Xt[b * 250:(b + 1) * 250].clone(), wt[b * 250:(b + 1) * 250]

    dev = streaming.streamed_moments(block_fn=block_fn, n_blocks=8)
    for a, b, c in zip(host, dev, jm):
        assert torch.equal(a, b)
        np.testing.assert_allclose(a.numpy(), np.asarray(c), **MOMENT_TOL)
    # against float64 numpy
    np.testing.assert_allclose(float(host[0]), w.sum(dtype=np.float64),
                               rtol=1e-6)
    G64 = (X.astype(np.float64) * w[:, None]).T @ X
    np.testing.assert_allclose(host[2].numpy(), G64, rtol=1e-5)
    with pytest.raises(ValueError, match="HostBlockSource"):
        streaming.streamed_moments(block_fn=block_fn, n_blocks=8,
                                   checkpoint_path="unused")
    with pytest.raises(NotImplementedError, match="item 10"):
        streaming.streamed_moments(block_fn=block_fn, n_blocks=8,
                                   elastic=object())


def test_pca_fit_blocks_matches_jax_and_in_memory():
    X, _ = _pca_data(n=4000, d=10, seed=1)
    w = np.ones(4000, np.float32)
    jest = jstreaming.pca_fit_blocks(jstream.HostBlockSource((X, w), 8), 8,
                                     4)
    est = streaming.pca_fit_blocks(HostBlockSource((X, w), 8), 8, 4)
    assert isinstance(est, PCA) and est.n_components_ == 4
    assert est.n_samples_ == 4000 and est.n_features_ == 10
    np.testing.assert_allclose(est.mean_, jest.mean_, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(est.explained_variance_,
                               jest.explained_variance_, rtol=1e-4)
    np.testing.assert_allclose(est.components_, jest.components_,
                               atol=1e-4)
    np.testing.assert_allclose(est.noise_variance_, jest.noise_variance_,
                               rtol=1e-4)
    mem = PCA(4, svd_solver="full").fit(X)
    np.testing.assert_allclose(est.explained_variance_,
                               mem.explained_variance_, rtol=1e-4)
    np.testing.assert_allclose(np.abs(np.sum(est.components_
                                             * mem.components_, axis=1)),
                               1.0, atol=1e-5)
    Z = est.transform(X[:50])
    np.testing.assert_allclose(Z, mem.transform(X[:50]), rtol=1e-3,
                               atol=1e-3)


def test_streamed_moments_preempt_resume_bit_identical(tmp_path):
    X, w = _pca_data()
    clean = streaming.streamed_moments(block_fn=HostBlockSource((X, w), 8),
                                       n_blocks=8)
    path = str(tmp_path / "moments.ckpt")
    inj = FaultInjector().preempt_at(block=4, epoch=0)
    with pytest.raises(Preempted):
        streaming.streamed_moments(
            block_fn=HostBlockSource((X, w), 8, fault_injector=inj),
            n_blocks=8, checkpoint_path=path, checkpoint_every=2)
    assert os.path.exists(path)
    resumed = streaming.streamed_moments(
        block_fn=HostBlockSource((X, w), 8), n_blocks=8,
        checkpoint_path=path)
    for a, b in zip(clean, resumed):
        assert torch.equal(a, b)
    assert not os.path.exists(path)


# ---------------------------------------------------------------------------
# snapshots across the packages
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_admm_snapshot_resumes_across_packages(tmp_path, writer):
    """A streamed ADMM snapshot written by one package resumes in the
    other (the bind dicts are identical) and lands within 1e-4 of the
    writer's uninterrupted run."""
    X, y, w = _problem(n=320, d=4, seed=5)
    n, d = X.shape
    kw = dict(family="logistic", regularizer="l2", lamduh=0.5, abstol=0.0,
              reltol=0.0, max_iter=4, return_state=True)
    path = str(tmp_path / "admm.ckpt")
    if writer == "jax":
        _, _, ref, _ = jcore.admm_streamed(
            jstream.HostBlockSource((X, y, w), 4), 4, d, float(n), **kw)
        inj = jfaults.FaultInjector().preempt_at(block=2, epoch=1)
        with pytest.raises(jfaults.Preempted):
            jcore.admm_streamed(
                jstream.HostBlockSource((X, y, w), 4, fault_injector=inj),
                4, d, float(n), checkpoint_path=path, **kw)
        _, n_iter, res, _ = tcore.admm_streamed(
            HostBlockSource((X, y, w), 4), 4, d, float(n),
            checkpoint_path=path, **kw)
    else:
        _, _, ref, _ = tcore.admm_streamed(
            HostBlockSource((X, y, w), 4), 4, d, float(n), **kw)
        inj = FaultInjector().preempt_at(block=2, epoch=1)
        with pytest.raises(Preempted):
            tcore.admm_streamed(
                HostBlockSource((X, y, w), 4, fault_injector=inj), 4, d,
                float(n), checkpoint_path=path, **kw)
        _, n_iter, res, _ = jcore.admm_streamed(
            jstream.HostBlockSource((X, y, w), 4), 4, d, float(n),
            checkpoint_path=path, **kw)
    assert int(n_iter) == 4
    assert not os.path.exists(path)
    _assert_state(res, ref)


def test_moments_snapshot_resumes_across_packages(tmp_path):
    X, w = _pca_data(seed=3)
    ref = jstreaming.streamed_moments(
        block_fn=jstream.HostBlockSource((X, w), 8), n_blocks=8)
    path = str(tmp_path / "m.ckpt")
    inj = jfaults.FaultInjector().preempt_at(block=3, epoch=0)
    with pytest.raises(jfaults.Preempted):
        jstreaming.streamed_moments(
            block_fn=jstream.HostBlockSource((X, w), 8, fault_injector=inj),
            n_blocks=8, checkpoint_path=path, checkpoint_every=1)
    res = streaming.streamed_moments(block_fn=HostBlockSource((X, w), 8),
                                     n_blocks=8, checkpoint_path=path)
    for a, b in zip(res, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **MOMENT_TOL)


def test_stream_state_from_numpy_resumes_a_jax_carry():
    X, y, w = _problem(n=320, d=4, seed=6)
    n, d = X.shape
    kw = dict(lamduh=0.5, abstol=0.0, reltol=0.0, return_state=True)
    _, _, ref, _ = jcore.admm_streamed(
        jstream.HostBlockSource((X, y, w), 4), 4, d, float(n), max_iter=4,
        **kw)
    _, _, half, _ = jcore.admm_streamed(
        jstream.HostBlockSource((X, y, w), 4), 4, d, float(n), max_iter=2,
        **kw)
    state = stream_state_from_numpy([np.asarray(a) for a in half])
    assert all(isinstance(t, torch.Tensor) and t.dtype == torch.float32
               for t in state)
    _, n2, res, _ = tcore.admm_streamed(
        HostBlockSource((X, y, w), 4), 4, d, float(n), max_iter=2,
        state=state, **kw)
    assert n2 == 2
    _assert_state(res, ref)


# ---------------------------------------------------------------------------
# the facades: fit_blocks and checkpoint=
# ---------------------------------------------------------------------------


def test_fit_blocks_matches_jax_and_in_memory_fit():
    X, y, w = _problem(n=640, d=5, seed=3)
    n, d = X.shape
    skw = {"abstol": 0.0, "reltol": 0.0}
    jest = jlm.LogisticRegression(solver="admm", max_iter=6,
                                  solver_kwargs=skw)
    jest.fit_blocks(jstream.HostBlockSource((X, y, w), 8), 8, n, d)
    src = HostBlockSource((X, y, w), 8)
    est = tlm.LogisticRegression(solver="admm", max_iter=6,
                                 solver_kwargs=skw)
    est.fit_blocks(src, 8, n, d)
    assert est.n_iter_ == jest.n_iter_ == 6
    np.testing.assert_allclose(est.coef_, jest.coef_, **COEF_TOL)
    np.testing.assert_allclose(est.intercept_, jest.intercept_, **COEF_TOL)
    np.testing.assert_array_equal(est.classes_, [0, 1])
    # the caller's source carries the counts of the intercept copy
    assert src.blocks_started == 48
    assert src.bytes_streamed == 6 * (X.nbytes + y.nbytes + w.nbytes)
    # a callable block_fn takes the same trajectory
    Xt, yt, wt = (torch.from_numpy(a) for a in (X, y, w))

    def block_fn(b):
        s = slice(b * 80, (b + 1) * 80)
        return Xt[s].clone(), yt[s].clone(), wt[s].clone()

    est2 = tlm.LogisticRegression(solver="admm", max_iter=6,
                                  solver_kwargs=skw)
    est2.fit_blocks(block_fn, 8, n, d, classes=["a", "b"])
    np.testing.assert_array_equal(est2.coef_, est.coef_)
    np.testing.assert_array_equal(est2.classes_, ["a", "b"])
    assert est.predict(X[:20]).shape == (20,)
    lin = tlm.LinearRegression(solver="admm", max_iter=3,
                               fit_intercept=False, solver_kwargs=skw)
    lin.fit_blocks(HostBlockSource((X, X @ np.ones(d, np.float32), w), 8),
                   8, n, d)
    assert lin.coef_.shape == (d,) and not hasattr(lin, "classes_")
    with pytest.raises(ValueError, match="solver='admm'"):
        tlm.LogisticRegression(solver="lbfgs").fit_blocks(src, 8, n, d)
    with pytest.raises(ValueError, match="HostBlockSource"):
        tlm.LogisticRegression(checkpoint="p").fit_blocks(block_fn, 8, n, d)


def test_facade_fit_blocks_checkpoint_preempt_resume(tmp_path):
    X, y, w = _problem(n=640, d=5, seed=3)
    n, d = X.shape
    path = str(tmp_path / "fit")
    clean = tlm.LogisticRegression(solver="admm", C=1.0, max_iter=20)
    clean.fit_blocks(HostBlockSource((X, y, w), 8), 8, n, d, classes=[0, 1])
    inj = FaultInjector().preempt_at(block=3, epoch=7)
    flaky = tlm.LogisticRegression(solver="admm", C=1.0, max_iter=20,
                                   checkpoint=path, checkpoint_every=4)
    with pytest.raises(Preempted):
        flaky.fit_blocks(HostBlockSource((X, y, w), 8, fault_injector=inj),
                         8, n, d, classes=[0, 1])
    assert os.path.exists(path + ".stream")
    resumed = tlm.LogisticRegression(solver="admm", C=1.0, max_iter=20,
                                     checkpoint=path, checkpoint_every=4)
    resumed.fit_blocks(HostBlockSource((X, y, w), 8), 8, n, d,
                       classes=[0, 1])
    np.testing.assert_array_equal(resumed.coef_, clean.coef_)
    np.testing.assert_array_equal(resumed.intercept_, clean.intercept_)
    assert resumed.n_iter_ == clean.n_iter_
    assert not os.path.exists(path + ".stream")


def test_solve_checkpointed_lbfgs_matches_jax_and_resumes(tmp_path):
    X, y, w = _problem(n=512, d=6, seed=7)
    Xi = np.concatenate([X, np.ones((512, 1), np.float32)], 1)
    mask = np.ones(7, np.float32)
    mask[-1] = 0.0
    kw = dict(family="logistic", regularizer="l2", lamduh=1.0, tol=1e-6)
    jb, jn = jckpt.solve_checkpointed(
        "lbfgs", jnp.asarray(Xi), jnp.asarray(y), jnp.asarray(w),
        jnp.zeros(7), jnp.asarray(mask), path=str(tmp_path / "j.ckpt"),
        chunk_iters=3, max_iter=12, **kw)
    args = tuple(torch.from_numpy(a) for a in (Xi, y, w)) + (
        torch.zeros(7), torch.from_numpy(mask))
    path = str(tmp_path / "t.ckpt")
    b, n_it = ckpt.solve_checkpointed("lbfgs", *args, path=path,
                                      chunk_iters=3, max_iter=12, **kw)
    assert n_it == int(jn)
    np.testing.assert_allclose(b.numpy(), np.asarray(jb), **COEF_TOL)
    one, n1 = tcore.lbfgs(*args, max_iter=12, **kw)
    assert n1 == n_it and torch.equal(one, b)
    # kept with converged set, or at the budget: a rerun returns it at once
    b2, n2 = ckpt.solve_checkpointed("lbfgs", *args, path=path,
                                     chunk_iters=3, max_iter=12, **kw)
    assert n2 == n_it and torch.equal(b2, b)
    with pytest.raises(ValueError, match="different problem"):
        ckpt.solve_checkpointed("lbfgs", *args, path=path, chunk_iters=3,
                                max_iter=12, **dict(kw, lamduh=2.0))
    with pytest.raises(ValueError, match="written by solver"):
        ckpt.solve_checkpointed("newton", *args, path=path, max_iter=3,
                                **kw)
    with pytest.raises(ValueError, match="unknown solver"):
        ckpt.solve_checkpointed("sgd", *args, path=path)


@pytest.mark.parametrize("solver", ["admm", "newton"])
def test_solve_checkpointed_chunks_compose(tmp_path, solver):
    """A run interrupted after a chunk and resumed with a larger budget
    equals the one-shot run bit for bit (admm: the whole carry; newton:
    its carry is beta)."""
    X, y, w = _problem(n=512, d=6, seed=8)
    args = tuple(torch.from_numpy(a) for a in (X, y, w)) + (
        torch.zeros(6), torch.ones(6))
    kw = dict(family="logistic", regularizer="l2", lamduh=1.0)
    extra = dict(n_shards=4) if solver == "admm" else {}
    if solver == "admm":
        kw.update(abstol=0.0, reltol=0.0)
    path = str(tmp_path / "c.ckpt")
    _, n_a = ckpt.solve_checkpointed(solver, *args, path=path,
                                     chunk_iters=2, max_iter=4, **extra, **kw)
    assert n_a == 4
    b, n_b = ckpt.solve_checkpointed(solver, *args, path=path,
                                     chunk_iters=2, max_iter=6, **extra, **kw)
    one, n_one = tcore.solve(solver, *args, max_iter=6, **extra, **kw)
    assert n_b == n_one == 6
    assert torch.equal(b, one)


def test_facade_checkpoint_matches_jax_and_resumes(tmp_path):
    X, y, w = _problem(n=512, d=6, seed=9)
    prefix = str(tmp_path / "lr")
    jest = jlm.LogisticRegression(solver="lbfgs", max_iter=6,
                                  checkpoint=str(tmp_path / "jlr"),
                                  checkpoint_every=2).fit(X, y)
    plain = tlm.LogisticRegression(solver="lbfgs", max_iter=6).fit(X, y)
    ck = tlm.LogisticRegression(solver="lbfgs", max_iter=6,
                                checkpoint=prefix,
                                checkpoint_every=2).fit(X, y)
    assert ck.n_iter_ == plain.n_iter_ == jest.n_iter_
    np.testing.assert_array_equal(ck.coef_, plain.coef_)
    np.testing.assert_allclose(ck.coef_, jest.coef_, **COEF_TOL)
    files = [f for f in os.listdir(tmp_path) if f.startswith("lr.")]
    assert len(files) == 1

    # interrupted after the second chunk's save, then resumed
    class Stop(Exception):
        pass

    saves = []
    orig = ckpt.save_pytree

    def save_then_stop(*a, **k):
        orig(*a, **k)
        saves.append(1)
        if len(saves) == 2:
            raise Stop

    prefix2 = str(tmp_path / "lr2")
    ckpt.save_pytree = save_then_stop
    try:
        with pytest.raises(Stop):
            tlm.LogisticRegression(solver="lbfgs", max_iter=6,
                                   checkpoint=prefix2,
                                   checkpoint_every=2).fit(X, y)
    finally:
        ckpt.save_pytree = orig
    resumed = tlm.LogisticRegression(solver="lbfgs", max_iter=6,
                                     checkpoint=prefix2,
                                     checkpoint_every=2).fit(X, y)
    assert resumed.n_iter_ == plain.n_iter_
    np.testing.assert_array_equal(resumed.coef_, plain.coef_)
    np.testing.assert_array_equal(resumed.intercept_, plain.intercept_)


@pytest.mark.parametrize("solver", ["lbfgs", "admm"])
def test_facade_checkpoint_multinomial_and_ovr(tmp_path, solver):
    rng = np.random.RandomState(10)
    X = rng.randn(600, 4).astype(np.float32)
    yk = np.argmax(X @ rng.randn(4, 3) + rng.randn(600, 3), axis=1)
    for mc in ("multinomial", "ovr"):
        kw = dict(solver=solver, multiclass=mc, max_iter=4)
        plain = tlm.LogisticRegression(**kw).fit(X, yk)
        ck = tlm.LogisticRegression(
            checkpoint=str(tmp_path / f"{mc}-{solver}"), checkpoint_every=2,
            **kw).fit(X, yk)
        assert ck.n_iter_ == plain.n_iter_
        np.testing.assert_array_equal(ck.coef_, plain.coef_)
    # one snapshot per OVR class, one for the softmax problem
    names = os.listdir(tmp_path)
    assert sum(f.startswith(f"ovr-{solver}.") for f in names) == 3
    assert sum(f.startswith(f"multinomial-{solver}.") for f in names) == 1

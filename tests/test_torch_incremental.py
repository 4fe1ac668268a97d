"""The PyTorch port's incremental tier held against the JAX package, on the
CPU: the streaming SGD steps, the GLMs' ``partial_fit``, ``Incremental`` /
``ParallelPostFit`` / ``fit`` / ``incremental_scan``, the scorers, the
``Partial*`` estimators, ``clone`` and the streaming state's converter.

The same numpy inputs, made from a seed, go through both packages; the
port runs under ``config_context(device="cpu")``, where a container's
matvec and pullback run their plain versions. Tolerances: a step, and a
chain of 20 blocks, within rtol 1e-5 (the same f32 gradient summed in
other orders: XLA's reductions against PyTorch's); within the port, the
device chain and the ``partial_fit`` loop bit for bit (the same step on
the same blocks); host estimators (``Partial*``, scikit-learn's) exactly.
"""

import subprocess
import sys
import pathlib
import warnings

import numpy as np
import pytest
import scipy.sparse as scipy_sparse
import torch

import jax.numpy as jnp

from dask_ml_tpu import wrappers as jwrap
from dask_ml_tpu import linear_model as jlm
from dask_ml_tpu.metrics import scorer as jscorer
from dask_ml_tpu.metrics.classification import log_loss as jlog_loss
from dask_ml_tpu.interop import export_learned_attrs
from dask_ml_tpu.models import glm as jcore
from dask_ml_tpu.ops import sparse as jsps
from dask_ml_tpu_torch import config_context
from dask_ml_tpu_torch import linear_model as tlm
from dask_ml_tpu_torch import wrappers as twrap
from dask_ml_tpu_torch.base import clone
from dask_ml_tpu_torch.convert import glm_from_numpy
from dask_ml_tpu_torch.metrics import log_loss, scorer as tscorer
from dask_ml_tpu_torch.models import glm as tcore
from dask_ml_tpu_torch.ops import sparse as tsps

RTOL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _cpu():
    with config_context(device="cpu"):
        yield


def _blocks(seed, n_blocks=20, rows=50, d=6, family="logistic", k=None):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n_blocks * rows, d)).astype(np.float32)
    eta = X @ rng.standard_normal(d).astype(np.float32)
    if k:
        y = rng.integers(0, k, len(X)).astype(np.float32)
    elif family == "logistic":
        y = (eta > 0).astype(np.float32)
    elif family == "poisson":
        y = rng.poisson(np.exp(0.3 * eta)).astype(np.float32)
    else:
        y = (eta + 0.1 * rng.standard_normal(len(X))).astype(np.float32)
    w = rng.uniform(0.5, 1.5, len(X)).astype(np.float32)
    w[-7:] = 0.0  # a padded remainder's rows
    return X, y, w


def _chain(apply_one, state, X, y, w, rows, asarray):
    out = []
    for i in range(0, len(X), rows):
        s = slice(i, i + rows)
        state = apply_one(state, asarray(X[s]), asarray(y[s]),
                          asarray(w[s]))
        out.append(np.array(state[0]))
    return out, state


@pytest.mark.parametrize("family,regularizer,fit_intercept,k", [
    ("logistic", "l2", True, None), ("logistic", "l1", False, None),
    ("normal", "elastic_net", True, None), ("poisson", "l2", False, None),
    ("poisson", "l1", True, None), ("logistic", "elastic_net", True, 3)])
def test_sgd_step_and_chain_match_jax(family, regularizer, fit_intercept, k):
    """One step and a 20-block chain: every state within rtol 1e-5."""
    X, y, w = _blocks(1, family=family, k=k)
    cfg = dict(family=family, regularizer=regularizer, lamduh=0.3,
               eta0=0.2, power_t=0.4, fit_intercept=fit_intercept,
               n_classes=k)
    width = 7 if fit_intercept else 6
    shape = (width, k) if k else (width,)
    _, japply = jcore.get_stream_step(**cfg)
    _, tapply = tcore.get_stream_step(**cfg)
    jstates, _ = _chain(japply, (jnp.zeros(shape), jnp.asarray(0.0)),
                        X, y, w, 50, jnp.asarray)
    tstates, (_, t) = _chain(
        tapply, (torch.zeros(shape), torch.tensor(0.0)), X, y, w, 50,
        torch.as_tensor)
    assert float(t) == 20.0
    for js, ts in zip(jstates, tstates):
        np.testing.assert_allclose(ts, js, **RTOL)


def test_sgd_step_on_a_container_matches_jax():
    """CSR blocks staged as containers: the port's matvec and its plain
    pullback (``index_add_``) against JAX's K6 and ``segment_sum``."""
    X, y, w = _blocks(2, n_blocks=4, rows=64, d=40)
    X[np.abs(X) < 1.0] = 0.0
    cfg = dict(family="logistic", regularizer="l2", lamduh=0.1, eta0=0.5)
    _, japply = jcore.get_stream_step(**cfg)
    _, tapply = tcore.get_stream_step(**cfg)
    js = (jnp.zeros(41), jnp.asarray(0.0))
    ts = (torch.zeros(41), torch.tensor(0.0))
    for i in range(0, 256, 64):
        csr = scipy_sparse.csr_matrix(X[i:i + 64])
        A = tsps.ell_from_csr(csr)
        js = japply(js, jsps.SparseRows(jnp.asarray(A.values),
                                        jnp.asarray(A.cols), A.d),
                    jnp.asarray(y[i:i + 64]), jnp.asarray(w[i:i + 64]))
        ts = tapply(ts, A.to("cpu"), torch.as_tensor(y[i:i + 64]),
                    torch.as_tensor(w[i:i + 64]))
        np.testing.assert_allclose(ts[0].numpy(), np.asarray(js[0]), **RTOL)


def test_batched_epoch_matches_jax():
    """M = 4 members, one frozen, blocks in a permuted order."""
    X, y, w = _blocks(3, n_blocks=6, rows=40, d=5)
    Xb = np.concatenate([X, np.ones((len(X), 1), np.float32)], 1).reshape(
        6, 40, 6)
    yb, wb = y.reshape(6, 40), w.reshape(6, 40)
    rng = np.random.default_rng(3)
    betas = rng.standard_normal((4, 6)).astype(np.float32) * 0.1
    ts = np.array([0.0, 3.0, 1.0, 0.0], np.float32)
    lam = np.array([0.0, 0.1, 1.0, 0.01], np.float32)
    eta0 = np.array([0.5, 0.1, 0.2, 0.05], np.float32)
    power_t = np.array([0.5, 0.25, 0.5, 1.0], np.float32)
    live = np.array([True, True, False, True])
    order = np.array([3, 0, 5, 1, 4, 2], np.int32)
    for regularizer in ("l2", "l1"):
        jb, jt = jcore.get_batched_sgd_epoch("logistic", regularizer, True)(
            *map(jnp.asarray, (betas, ts, lam, eta0, power_t, live, Xb, yb,
                               wb, order)))
        tb, tt = tcore.get_batched_sgd_epoch("logistic", regularizer, True)(
            *map(torch.as_tensor, (betas, ts, lam, eta0, power_t, live, Xb,
                                   yb, wb, order)))
        np.testing.assert_allclose(tb.numpy(), np.asarray(jb), **RTOL)
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_array_equal(tb[2].numpy(), betas[2])
    # each member is its own single-member chain
    one = tcore.get_batched_sgd_epoch("logistic", "l1", True)(
        *map(torch.as_tensor, (betas[1:2], ts[1:2], lam[1:2], eta0[1:2],
                               power_t[1:2], live[1:2], Xb, yb, wb, order)))
    np.testing.assert_allclose(one[0][0].numpy(), tb[1].numpy(), **RTOL)


def _dense(seed, n=777, d=5, k=2):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, d)).astype(np.float32)
    score = X @ rng.standard_normal((d, k))
    y = np.argmax(score, 1) if k > 2 else (score[:, 0] > 0).astype(int)
    return X, y


def test_partial_fit_chain_resume_and_errors_match_jax():
    """A partial_fit chain in blocks of 100 (a remainder of 77), resumed
    in two calls of the wrappers' fit, with weights sliced per block;
    the class-set errors of the JAX package."""
    X, y = _dense(4)
    sw = np.random.default_rng(4).uniform(0.5, 2.0, len(X))
    kw = dict(C=10.0, solver="proximal_grad", solver_kwargs={"eta0": 0.3})
    je = jwrap.fit(jlm.LogisticRegression(**kw), X, y, block_size=100,
                   sample_weight=sw, classes=[0, 1])
    te = tlm.LogisticRegression(**kw)
    twrap.fit(te, X[:400], y[:400], block_size=100, sample_weight=sw[:400],
              classes=[0, 1])
    twrap.fit(te, X[400:], y[400:], block_size=100, sample_weight=sw[400:])
    assert te.n_iter_ == je.n_iter_ == 8
    np.testing.assert_allclose(te.coef_, je.coef_, **RTOL)
    np.testing.assert_allclose(te.intercept_, je.intercept_, **RTOL)
    np.testing.assert_array_equal(te.predict(X), je.predict(X))
    for est in (te, jlm.LogisticRegression(**kw).partial_fit(
            X[:10], y[:10], classes=[0, 1])):
        with pytest.raises(ValueError, match="changed between"):
            est.partial_fit(X[:50], y[:50], classes=[0, 2])
    for mk in (tlm.LogisticRegression, jlm.LogisticRegression):
        with pytest.raises(ValueError, match="at least 2 classes"):
            mk().partial_fit(X[:5], np.zeros(5, int))
        with pytest.raises(ValueError, match="multiclass='multinomial'"):
            mk().partial_fit(X[:9], np.arange(9) % 3)
        with pytest.raises(ValueError, match="outside `classes`"):
            mk().partial_fit(X[:9], np.arange(9) % 3, classes=[0, 1])
    with pytest.raises(ValueError, match="running state"):
        te.partial_fit(X[:10, :3], y[:10])


def test_partial_fit_warm_starts_from_a_batch_fit_like_jax():
    X, y = _dense(5, n=400)
    kw = dict(solver="lbfgs", max_iter=5)
    je = jlm.LogisticRegression(**kw).fit(X, y)
    te = tlm.LogisticRegression(**kw).fit(X, y)
    np.testing.assert_allclose(te.coef_, je.coef_, rtol=1e-4, atol=1e-5)
    je.partial_fit(X[:100], y[:100])
    te.partial_fit(X[:100], y[:100])
    assert te.n_iter_ == je.n_iter_ == 1
    np.testing.assert_allclose(te.coef_, je.coef_, rtol=1e-4, atol=1e-5)


@pytest.mark.parametrize("cls,family", [("LinearRegression", "normal"),
                                        ("PoissonRegression", "poisson")])
def test_regression_partial_fit_matches_jax(cls, family):
    X, y, _ = _blocks(6, n_blocks=5, rows=60, d=4, family=family)
    kw = dict(C=50.0, solver_kwargs={"eta0": 0.05, "power_t": 0.25})
    je = jwrap.fit(getattr(jlm, cls)(**kw), X, y, block_size=60)
    te = twrap.fit(getattr(tlm, cls)(**kw), X, y, block_size=60)
    np.testing.assert_allclose(te.coef_, je.coef_, **RTOL)
    np.testing.assert_allclose(te.predict(X), np.asarray(je.predict(X)),
                               rtol=1e-5, atol=1e-5)


def test_softmax_partial_fit_matches_jax():
    X, y = _dense(7, n=600, k=3)
    kw = dict(multiclass="multinomial", solver_kwargs={"eta0": 0.5})
    je, te = jlm.LogisticRegression(**kw), tlm.LogisticRegression(**kw)
    for i in range(0, 600, 100):
        je.partial_fit(X[i:i + 100], y[i:i + 100], classes=[2, 0, 1])
        te.partial_fit(X[i:i + 100], y[i:i + 100], classes=[2, 0, 1])
    assert te.coef_.shape == (3, 5)
    np.testing.assert_array_equal(te.classes_, [2, 0, 1])
    np.testing.assert_allclose(te.coef_, je.coef_, **RTOL)
    np.testing.assert_array_equal(te.predict(X), je.predict(X))


def test_incremental_equals_fit_and_the_partial_fit_loop():
    """Incremental's device chain (with a remainder block) equals the
    functional fit and a hand-written partial_fit loop bit for bit, and
    the JAX package's Incremental within rtol 1e-5."""
    X, y = _dense(8)
    kw = dict(C=100.0, solver_kwargs={"eta0": 0.5})
    inc = twrap.Incremental(tlm.LogisticRegression(**kw), block_size=128)
    inc.fit(X, y)
    assert not hasattr(inc.estimator, "coef_")
    fitted = twrap.fit(tlm.LogisticRegression(**kw), X, y, block_size=128)
    loop = tlm.LogisticRegression(**kw)
    for i in range(0, len(X), 128):
        loop.partial_fit(X[i:i + 128], y[i:i + 128])
    for other in (fitted, loop):
        np.testing.assert_array_equal(inc.coef_, other.coef_)
        np.testing.assert_array_equal(inc.intercept_, other.intercept_)
    assert inc.n_iter_ == 7
    jinc = jwrap.Incremental(jlm.LogisticRegression(**kw), block_size=128)
    jinc.fit(X, y)
    np.testing.assert_allclose(inc.coef_, jinc.coef_, **RTOL)
    # a second partial_fit continues from estimator_
    inc.partial_fit(X[:128], y[:128])
    loop.partial_fit(X[:128], y[:128])
    np.testing.assert_array_equal(inc.coef_, loop.coef_)
    assert inc.score(X, y) == loop.score(X, y)


def test_incremental_refuses_sparse_and_serving():
    X, y = _dense(9, n=200)
    with pytest.raises(ValueError, match="dense X"):
        twrap.Incremental(tlm.LogisticRegression()).fit(
            scipy_sparse.csr_matrix(X), y)
    est = tlm.LogisticRegression(solver="lbfgs", max_iter=3).fit(X, y)
    ppf = twrap.ParallelPostFit(est, serving=object())
    for call in (lambda: ppf.fit(X, y), lambda: ppf.predict(X)):
        with pytest.raises(NotImplementedError, match="Queue A item 11"):
            call()
    with pytest.raises(AttributeError, match="not fitted"):
        twrap.Incremental(tlm.LogisticRegression()).predict(X)


def test_incremental_scan_remainder_and_multioutput_like_jax():
    rng = np.random.default_rng(10)
    X = rng.standard_normal((150, 3)).astype(np.float32)
    Y = rng.standard_normal((150, 2)).astype(np.float32)
    sw = rng.uniform(size=150).astype(np.float32)
    seen = []

    def tstep(W, blk):
        xs, ys, wv = blk
        seen.append((tuple(xs.shape), tuple(ys.shape)))
        return W + xs.T @ (wv[:, None] * ys)

    def jstep(W, blk):
        xs, ys, wv = blk
        return W + xs.T @ (wv[:, None] * ys)

    got = twrap.incremental_scan(tstep, torch.zeros(3, 2), X, Y,
                                 sample_weight=sw, block_size=64)
    assert seen == [((64, 3), (64, 2))] * 3
    want = jwrap.incremental_scan(jstep, jnp.zeros((3, 2)), X, Y,
                                  sample_weight=sw, block_size=64)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_allclose(got.numpy(), X.T @ (sw[:, None] * Y),
                               rtol=1e-4)
    with pytest.raises(ValueError, match="sample_weight"):
        twrap.incremental_scan(tstep, torch.zeros(3, 2), X, Y,
                               sample_weight=sw[:5])
    with pytest.raises(ValueError, match="no rows"):
        twrap.incremental_scan(tstep, torch.zeros(3, 2), X[:0])


def test_incremental_chain_makes_no_host_read():
    X, y = _dense(11)
    est = tlm.LogisticRegression()
    step, state, y_enc = est._incremental_begin(X, y)
    tcore.reset_host_reads()
    twrap.incremental_scan(step, state, X, y_enc, block_size=100)
    assert tcore.host_reads == {"n": 0, "newton_steps": 0}


def test_parallel_post_fit_delegates_blocks_and_scores():
    from sklearn.linear_model import LogisticRegression as SKLogistic

    X, y = _dense(12, n=1000)
    native = tlm.LogisticRegression(solver="lbfgs", max_iter=10).fit(X, y)
    calls = []

    class Spy:
        def __init__(self, est):
            self.est = est

        def predict(self, X):
            calls.append(len(X))
            return self.est.predict(X)

    Spy.__module__ = "dask_ml_tpu_torch.fake"
    ppf = twrap.ParallelPostFit(Spy(native), block_size=300)
    np.testing.assert_array_equal(ppf.predict(X), native.predict(X))
    assert calls == [1000]  # native: the whole array
    Spy.__module__ = "dask_ml_tpu.fake"  # the JAX package's: foreign here
    calls.clear()
    np.testing.assert_array_equal(ppf.predict(X), native.predict(X))
    assert sorted(calls) == [100, 300, 300, 300]
    sk = SKLogistic().fit(X, y)
    ppf = twrap.ParallelPostFit(sk, block_size=128, scoring="accuracy")
    np.testing.assert_array_equal(ppf.predict(X), sk.predict(X))
    np.testing.assert_allclose(ppf.predict_proba(X), sk.predict_proba(X))
    # the JAX accuracy sums in f32
    assert ppf.score(X, y) == pytest.approx(jwrap.ParallelPostFit(
        sk, block_size=128, scoring="accuracy").score(X, y), rel=1e-6)
    with pytest.raises(AttributeError, match="transform"):
        ppf.transform(X)
    fit = twrap.ParallelPostFit(tlm.LogisticRegression(
        solver="lbfgs", max_iter=10)).fit(X, y)
    np.testing.assert_array_equal(fit.coef_, native.coef_)


def test_scorers_match_jax():
    X, y = _dense(13, n=300)
    est = tlm.LogisticRegression(solver="lbfgs", max_iter=10).fit(X, y)
    jest = jlm.LogisticRegression(solver="lbfgs", max_iter=10).fit(X, y)
    for name in ("accuracy", "neg_log_loss"):
        np.testing.assert_allclose(
            tscorer.get_scorer(name)(est, X, y),
            jscorer.get_scorer(name)(jest, X, y), rtol=1e-4)
    Xr, yr, _ = _blocks(13, n_blocks=1, rows=200, family="normal")
    reg = tlm.LinearRegression(solver="lbfgs").fit(Xr, yr)
    jreg = jlm.LinearRegression(solver="lbfgs").fit(Xr, yr)
    for name in ("neg_mean_squared_error", "neg_mean_absolute_error", "r2"):
        np.testing.assert_allclose(
            tscorer.get_scorer(name)(reg, Xr, yr),
            jscorer.get_scorer(name)(jreg, Xr, yr), rtol=1e-4)
    assert set(tscorer.SCORERS) == set(jscorer.SCORERS)
    p = np.clip(np.random.default_rng(1).uniform(size=50), 0, 1)
    labels = np.where(np.random.default_rng(2).uniform(size=50) > .5, 7, -1)
    np.testing.assert_allclose(log_loss(labels, p), jlog_loss(labels, p),
                               rtol=1e-6)
    # a sklearn name resolves where scikit-learn imports; others raise
    assert callable(tscorer.get_scorer("balanced_accuracy"))
    with pytest.raises(ValueError, match="not a valid scoring"):
        tscorer.get_scorer("no_such_scorer")
    from dask_ml_tpu_torch.metrics import accuracy_score

    for fn in (accuracy_score, lambda y_true, y_pred: 0.0):
        assert tscorer._looks_like_raw_metric(fn) == \
            jscorer._looks_like_raw_metric(fn)
        with pytest.raises(ValueError, match="raw metric"):
            tscorer.check_scoring(est, fn)
    assert tscorer.check_scoring(est) is None
    with pytest.raises(TypeError, match="no score method"):
        tscorer.check_scoring(object())


@pytest.mark.parametrize("name,module,classes", [
    ("PartialSGDClassifier", "linear_model", True),
    ("PartialSGDRegressor", "linear_model", False),
    ("PartialPerceptron", "linear_model", True),
    ("PartialPassiveAggressiveClassifier", "linear_model", True),
    ("PartialMultinomialNB", "naive_bayes", True),
    ("PartialBernoulliNB", "naive_bayes", True),
    ("PartialMLPClassifier", "neural_network", True)])
def test_partial_estimators_match_jax(name, module, classes):
    import importlib

    X, y = _dense(14, n=500)
    if module == "naive_bayes":
        X = np.abs(X)
    kw = dict(random_state=0) if "NB" not in name else {}
    if name == "PartialMLPClassifier":
        kw["hidden_layer_sizes"] = (4,)
    if classes:
        kw["classes"] = [0, 1]
    ours = getattr(importlib.import_module(f"dask_ml_tpu_torch.{module}"),
                   name)
    theirs = getattr(importlib.import_module(f"dask_ml_tpu.{module}"), name)
    with pytest.warns(FutureWarning, match="Incremental"):
        t = ours(**kw)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = theirs(**kw)
        t.fit(X, y, block_size=100)
        j.fit(X, y, block_size=100)
    np.testing.assert_array_equal(t.predict(X), j.predict(X))
    assert t.get_params() == j.get_params()
    with pytest.warns(FutureWarning):
        c = clone(t)
    assert c.get_params() == t.get_params() and not hasattr(c, "n_iter_")
    if classes:
        with pytest.raises(TypeError, match="classes"):
            ours()


def test_partial_mlp_alias_and_functional_predict():
    from dask_ml_tpu_torch import _partial
    from dask_ml_tpu_torch.neural_network import (ParitalMLPClassifier,
                                                  PartialMLPClassifier)

    assert ParitalMLPClassifier is PartialMLPClassifier
    X, y = _dense(15, n=250)
    est = tlm.LogisticRegression(solver="lbfgs", max_iter=5).fit(X, y)
    np.testing.assert_array_equal(_partial.predict(est, X, block_size=64),
                                  est.predict(X))
    assert _partial.predict(est, X[:0]).shape == (0,)
    assert _partial.fit is twrap.fit


def test_clone_and_nested_params():
    inc = twrap.Incremental(tlm.LogisticRegression(C=2.0), block_size=7)
    params = inc.get_params()
    assert params["estimator__C"] == 2.0 and params["block_size"] == 7
    inc.set_params(estimator__C=5.0, block_size=9)
    assert inc.estimator.C == 5.0 and inc.block_size == 9
    c = clone(inc)
    assert c.estimator is not inc.estimator and c.estimator.C == 5.0
    assert c.get_params(deep=False).keys() == inc.get_params(
        deep=False).keys()
    with pytest.raises(ValueError, match="Invalid parameter"):
        inc.set_params(nope__C=1.0)
    assert clone([tlm.LinearRegression(C=3.0)])[0].C == 3.0


@pytest.mark.parametrize("k", [2, 3])
def test_a_jax_chain_continues_in_the_port(k):
    """A chain begun in the JAX package, carried across with its streaming
    state, continues in the port to the JAX package's own continuation."""
    X, y = _dense(16, n=600, k=k)
    kw = dict(multiclass="multinomial", solver_kwargs={"eta0": 0.3})
    je = jlm.LogisticRegression(**kw)
    jwrap.fit(je, X[:300], y[:300], block_size=100, classes=np.arange(k))
    attrs = dict(export_learned_attrs(je), _pf_state=je._pf_state,
                 _pf_classes=je._pf_classes)
    te = glm_from_numpy(attrs, "logistic", multiclass="multinomial")
    te.set_params(**kw)  # the dict carries no constructor settings
    twrap.fit(te, X[300:], y[300:], block_size=100)
    jwrap.fit(je, X[300:], y[300:], block_size=100)
    assert te.n_iter_ == je.n_iter_ == 6
    np.testing.assert_allclose(te.coef_, je.coef_, **RTOL)
    with pytest.raises(ValueError, match="_pf_state"):
        glm_from_numpy(dict(attrs, _pf_state=(np.zeros(3), 0.0)),
                       "logistic", multiclass="multinomial")


def test_import_without_sklearn():
    """Where scikit-learn is not installed (the card's machine), the
    wrappers, the Partial* base, the scorers and linear_model import and
    an Incremental fit runs; only a Partial* name needs scikit-learn."""
    code = (
        "import sys\n"
        "sys.modules['sklearn'] = None\n"
        "import numpy as np\n"
        "import dask_ml_tpu_torch.wrappers as w, dask_ml_tpu_torch._partial\n"
        "import dask_ml_tpu_torch.metrics.scorer as s\n"
        "import dask_ml_tpu_torch.linear_model as lm\n"
        "from dask_ml_tpu_torch import config_context\n"
        "X = np.random.default_rng(0).standard_normal((300, 4))\n"
        "y = (X[:, 0] > 0).astype(int)\n"
        "with config_context(device='cpu'):\n"
        "    inc = w.Incremental(lm.LogisticRegression(), block_size=64,\n"
        "                        scoring='accuracy').fit(X, y)\n"
        "    assert inc.score(X, y) > 0.8\n"
        "try:\n"
        "    s.get_scorer('balanced_accuracy')\n"
        "except ValueError:\n"
        "    pass\n"
        "else:\n"
        "    raise AssertionError('an sklearn name resolved')\n"
        "try:\n"
        "    lm.PartialSGDClassifier\n"
        "except ImportError:\n"
        "    print('clean')\n")
    root = pathlib.Path(__file__).resolve().parents[1]
    out = subprocess.run([sys.executable, "-c", code], cwd=root,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "clean" in out.stdout
